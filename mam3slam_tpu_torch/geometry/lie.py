"""Batched SO(3) / SE(3) operations on torch tensors.

Port of ``mam3slam_tpu.geometry.lie`` limited to what the per-frame
tracking path calls.  Same conventions: Hamilton quaternions ``(w, x, y,
z)`` of shape ``[..., 4]``, SE(3) tangents ``[rho(3), phi(3)]``, arbitrary
leading batch dimensions, small-angle Taylor branches selected with
``torch.where``.
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


class SE3(NamedTuple):
    """Rigid transform ``x_out = R(q) @ x + t``."""

    q: torch.Tensor  # [..., 4]
    t: torch.Tensor  # [..., 3]


def se3_compose(a: SE3, b: SE3) -> SE3:
    """a * b (apply b first, then a)."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def se3_inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def se3_exp(tangent: torch.Tensor) -> SE3:
    """Tangent ``[..., 6] = [rho, phi]`` -> SE3."""
    rho, phi = tangent[..., :3], tangent[..., 3:6]
    q = so3_exp_quat(phi)
    V = so3_left_jacobian(phi)
    return SE3(q, (V @ rho[..., None])[..., 0])
