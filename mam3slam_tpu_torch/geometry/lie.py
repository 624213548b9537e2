"""Batched SO(3) / SE(3) operations on torch tensors.

Port of ``mam3slam_tpu.geometry.lie``.  Same conventions: Hamilton
quaternions ``(w, x, y, z)`` of shape ``[..., 4]``, SE(3) tangents
``[rho(3), phi(3)]``, Sim(3) tangents ``[rho(3), phi(3), sigma]``,
arbitrary leading batch dimensions, small-angle Taylor branches selected
with ``torch.where`` on a benign value (the reference's safe ``where``),
so forward-mode jacobians through them stay finite.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=_EPS)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v [..., 3]`` by unit quaternions ``q [..., 4]``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion with w >= 0
    (Shepperd's four-candidate construction, branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4 cand, 4]
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrix."""
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return k.reshape(phi.shape[:-1] + (3, 3))


def vee(K: torch.Tensor) -> torch.Tensor:
    return torch.stack([K[..., 2, 1], K[..., 0, 2], K[..., 1, 0]], dim=-1)


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``[..., 3]`` -> unit quaternion (Taylor-guarded)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(safe_sq)
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix (Rodrigues, Taylor-guarded)."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(safe_sq)
    K = hat(phi)
    K2 = K @ K
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    return _eye3_like(K) + a * K + b * K2


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi), the V matrix of the SE(3) exponential."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(safe_sq)
    K = hat(phi)
    K2 = K @ K
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (safe_sq * theta))
    return _eye3_like(K) + b * K + c * K2


def so3_log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle ``[..., 3]``."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0: theta <= pi
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn_sq = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    small = vn_sq < 1e-12
    vn = torch.sqrt(torch.where(small, 1.0, vn_sq))
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / vn)
    return k * q[..., 1:]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    return so3_log_quat(quat_from_matrix(R))


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta_sq < _EPS
    safe_sq = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(safe_sq)
    K = hat(phi)
    K2 = K @ K
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - 0.5 * theta * torch.cos(half)
         / torch.clamp(torch.sin(half), min=_EPS)) / safe_sq)
    return _eye3_like(K) - 0.5 * K + cot_term * K2


class SE3(NamedTuple):
    """Rigid transform ``x_out = R(q) @ x + t``."""

    q: torch.Tensor  # [..., 4]
    t: torch.Tensor  # [..., 3]


def se3_identity(shape=(), dtype=torch.float32, device=None) -> SE3:
    return SE3(quat_identity(shape, dtype, device),
               torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))


def se3_compose(a: SE3, b: SE3) -> SE3:
    """a * b (apply b first, then a)."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def se3_inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def se3_apply(a: SE3, pts: torch.Tensor) -> torch.Tensor:
    return quat_rotate(a.q, pts) + a.t


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with the row (0, 0, 0, 1) appended."""
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_matrix(a: SE3) -> torch.Tensor:
    """``[..., 4, 4]`` homogeneous matrix."""
    return _homogeneous(torch.cat([quat_to_matrix(a.q), a.t[..., None]],
                                  dim=-1))


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> SE3:
    return SE3(quat_from_matrix(R), t)


def se3_exp(tangent: torch.Tensor) -> SE3:
    """Tangent ``[..., 6] = [rho, phi]`` -> SE3."""
    rho, phi = tangent[..., :3], tangent[..., 3:6]
    q = so3_exp_quat(phi)
    V = so3_left_jacobian(phi)
    return SE3(q, (V @ rho[..., None])[..., 0])


def se3_log(a: SE3) -> torch.Tensor:
    phi = so3_log_quat(a.q)
    rho = (so3_left_jacobian_inv(phi) @ a.t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

class Sim3(NamedTuple):
    """Similarity transform ``x_out = s * R(q) @ x + t``; ``s`` has shape
    ``[...]`` (no trailing axis)."""

    q: torch.Tensor  # [..., 4]
    t: torch.Tensor  # [..., 3]
    s: torch.Tensor  # [...]


def sim3_identity(shape=(), dtype=torch.float32, device=None) -> Sim3:
    return Sim3(quat_identity(shape, dtype, device),
                torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device),
                torch.ones(tuple(shape), dtype=dtype, device=device))


def sim3_from_se3(a: SE3, s=None) -> Sim3:
    batch = a.q.shape[:-1]
    scale = (torch.ones(batch, dtype=a.q.dtype, device=a.q.device)
             if s is None else torch.as_tensor(s, dtype=a.q.dtype,
                                               device=a.q.device))
    return Sim3(a.q, a.t, scale.expand(batch))


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    return Sim3(quat_normalize(quat_mul(a.q, b.q)),
                a.s[..., None] * quat_rotate(a.q, b.t) + a.t, a.s * b.s)


def sim3_inverse(a: Sim3) -> Sim3:
    qi = quat_conj(a.q)
    s_inv = 1.0 / a.s
    return Sim3(qi, -s_inv[..., None] * quat_rotate(qi, a.t), s_inv)


def sim3_apply(a: Sim3, pts: torch.Tensor) -> torch.Tensor:
    return a.s[..., None] * quat_rotate(a.q, pts) + a.t


def sim3_matrix(a: Sim3) -> torch.Tensor:
    R = a.s[..., None, None] * quat_to_matrix(a.q)
    return _homogeneous(torch.cat([R, a.t[..., None]], dim=-1))


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) = int_0^1 e^{sigma u} exp(u hat(phi)) du ``[..., 3, 3]``,
    the translation mixing matrix of the Sim(3) exponential (closed form
    with the reference's Taylor guards)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    s = torch.exp(sigma)
    sigma_sq = sigma * sigma
    small_sigma = torch.abs(sigma) < 1e-4
    small_theta = theta_sq < 1e-8
    safe_sigma = torch.where(small_sigma, 1.0, sigma)
    safe_theta_sq = torch.where(small_theta, 1.0, theta_sq)
    safe_theta = torch.sqrt(safe_theta_sq)

    # C = (e^sigma - 1) / sigma
    C = torch.where(small_sigma, 1.0 + 0.5 * sigma + sigma_sq / 6.0,
                    (s - 1.0) / safe_sigma)
    # sigma ~ 0
    A0 = torch.where(small_theta, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(safe_theta)) / safe_theta_sq)
    B0 = torch.where(small_theta, 1.0 / 6.0 - theta_sq / 120.0,
                     (safe_theta - torch.sin(safe_theta))
                     / (safe_theta_sq * safe_theta))
    # sigma != 0, theta ~ 0
    A1 = ((safe_sigma - 1.0) * s + 1.0) / torch.where(small_sigma, 1.0,
                                                      sigma_sq)
    B1 = (s * 0.5 * sigma_sq + s - 1.0 - sigma * s) / torch.where(
        small_sigma, 1.0, sigma_sq * safe_sigma)
    # general
    a_ = s * torch.sin(safe_theta)
    b_ = s * torch.cos(safe_theta)
    c_ = theta_sq + sigma_sq
    safe_c = torch.where(c_ < 1e-12, 1.0, c_)
    A2 = (a_ * sigma + (1.0 - b_) * safe_theta) / (safe_theta * safe_c)
    B2 = (C - ((b_ - 1.0) * sigma + a_ * safe_theta) / safe_c) / safe_theta_sq

    A = torch.where(small_sigma, A0, torch.where(small_theta, A1, A2))
    B = torch.where(small_sigma, B0, torch.where(small_theta, B1, B2))
    K = hat(phi)
    return (A[..., None, None] * K + B[..., None, None] * (K @ K)
            + C[..., None, None] * _eye3_like(K))


def sim3_exp(tangent: torch.Tensor) -> Sim3:
    """Tangent ``[..., 7] = [rho, phi, sigma]`` -> Sim3."""
    rho, phi, sigma = tangent[..., :3], tangent[..., 3:6], tangent[..., 6]
    W = _sim3_W(phi, sigma)
    return Sim3(so3_exp_quat(phi), (W @ rho[..., None])[..., 0],
                torch.exp(sigma))


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for batched 3x3 A by the adjugate (cheap under forward
    mode, where a batched LU is not)."""
    c0 = torch.linalg.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c1 = torch.linalg.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c2 = torch.linalg.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = (A[..., 0, :] * c0).sum(-1)
    adj_b = c0 * b[..., :1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]
    return adj_b / det[..., None]


def sim3_log(a: Sim3) -> torch.Tensor:
    phi = so3_log_quat(a.q)
    sigma = torch.log(a.s)
    rho = _solve3(_sim3_W(phi, sigma), a.t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
