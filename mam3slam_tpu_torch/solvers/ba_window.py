"""Windowed bundle adjustment on the dense reduced camera system.

Port of the dense path of ``mam3slam_tpu.solvers.ba_window``
(``run_window_ba_dense``): Huber-robust Levenberg-Marquardt over a window
of free keyframes and the points they observe, laid out point-major
(``[Pw, M]`` observation slots, fixed observers included).  Each LM step
forms the reduced camera system explicitly (Schur complement of the 3x3
point blocks), factors it with one Cholesky and back-substitutes the
points; the trial cost is evaluated by the next iteration's
linearisation, and a rejected step re-steps from the best point.

The per-edge math runs on flat component arrays (``[E]``, E = Pw * M) as
in the reference.  The reference's one-hot matmuls become ``index_add_``
segment sums over the free-camera slot.  The camera-major view and the
CG solver are not ported (see ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie

CHI2_MONO = 5.991


class WindowProblem(NamedTuple):
    """Dense two-view BA problem (field meanings as in the reference).
    Kc = free-camera cap, Pw = window-point cap, M = observation cap; the
    camera-major ``cm_*`` arrays have 0 rows (point-major solver)."""

    cam_idx: torch.Tensor      # [Kc] arena KF slot, -1 = unused
    cam_valid: torch.Tensor    # [Kc] bool
    cam_q: torch.Tensor        # [Kc, 4]
    cam_t: torch.Tensor        # [Kc, 3]
    cam_params: torch.Tensor   # [Kc, 8]
    cm_uv: torch.Tensor        # [0, F, 2]
    cm_w: torch.Tensor         # [0, F]
    cm_pt: torch.Tensor        # [0, F]
    cm_mslot: torch.Tensor     # [0, F]
    cm_valid: torch.Tensor     # [0, F]
    pt_idx: torch.Tensor       # [Pw] arena MP slot, -1 = unused
    pt_valid: torch.Tensor     # [Pw]
    pts: torch.Tensor          # [Pw, 3]
    pm_kf: torch.Tensor        # [Pw, M] arena KF slot of the observer
    pm_feat: torch.Tensor      # [Pw, M] feature index in that KF
    pm_cslot: torch.Tensor     # [Pw, M] free-camera slot, -1 = fixed
    pm_uv: torch.Tensor        # [Pw, M, 2]
    pm_w: torch.Tensor         # [Pw, M] information (1 / sigma^2)
    pm_valid: torch.Tensor     # [Pw, M]
    pm_q0: torch.Tensor        # [Pw, M, 4] observer pose snapshots
    pm_t0: torch.Tensor        # [Pw, M, 3]
    pm_params0: torch.Tensor   # [Pw, M, 8]
    cam_slot_of: torch.Tensor  # [K] free-camera slot or -1
    pt_slot_of: torch.Tensor   # [P] window-point slot or -1


class WindowResult(NamedTuple):
    cam_q: torch.Tensor        # [Kc, 4]
    cam_t: torch.Tensor        # [Kc, 3]
    pts: torch.Tensor          # [Pw, 3]
    pm_inlier: torch.Tensor    # [Pw, M] bool, chi2-gated at the solution
    cost: torch.Tensor         # [] robust cost


def _huber_w(chi2, delta2):
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _rho(chi2, delta2):
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12))
                       - delta2)


def _spd_inv3(A):
    """Closed-form cofactor inverse of batched 3x3 SPD blocks."""
    A = A + 1e-8 * torch.eye(3, dtype=A.dtype, device=A.device)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00, C01, C02 = e * i - f * h, c * h - b * i, b * f - c * e
    C10, C11, C12 = f * g - d * i, a * i - c * g, c * d - a * f
    C20, C21, C22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * C00 + b * C10 + c * C20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    M = torch.stack([torch.stack([C00, C01, C02], -1),
                     torch.stack([C10, C11, C12], -1),
                     torch.stack([C20, C21, C22], -1)], -2)
    return M * inv_det[..., None, None]


def _chol3(A):
    """Closed-form Cholesky (A = L L^T) of batched 3x3 SPD blocks."""
    a11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=1e-20))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=1e-20))
    z = torch.zeros_like(a11)
    return torch.stack([torch.stack([a11, z, z], -1),
                        torch.stack([l21, l22, z], -1),
                        torch.stack([l31, l32, l33], -1)], -2)


class _EdgeConsts(NamedTuple):
    """Flattened per-edge constants of a WindowProblem ([E] each)."""

    uvx: torch.Tensor
    uvy: torch.Tensor
    w0: torch.Tensor
    valid: torch.Tensor
    is_free: torch.Tensor
    cslot: torch.Tensor       # clamped free-camera slot
    q0: tuple                 # fixed-observer quaternion comps (4 x [E])
    t0: tuple                 # fixed-observer translation comps (3 x [E])
    par: tuple                # camera parameter comps (8 x [E])


def _flatten_consts(prob: WindowProblem) -> _EdgeConsts:
    def f(a):
        return a.reshape(-1)

    return _EdgeConsts(
        uvx=f(prob.pm_uv[..., 0]), uvy=f(prob.pm_uv[..., 1]),
        w0=f(prob.pm_w), valid=f(prob.pm_valid),
        is_free=f(prob.pm_cslot >= 0),
        cslot=f(torch.clamp(prob.pm_cslot, min=0)).long(),
        q0=tuple(f(prob.pm_q0[..., i]) for i in range(4)),
        t0=tuple(f(prob.pm_t0[..., i]) for i in range(3)),
        par=tuple(f(prob.pm_params0[..., i]) for i in range(8)))


def _soa_rot_from_quat(qw, qx, qy, qz):
    """Rotation-matrix components (row-major) of a (w, x, y, z) quaternion."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def _soa_project_and_jac(kind, par, X, Y, Z):
    """(u, v, the 2x3 projection jacobian's six entries, depth_ok), the
    math of cameras.project_ideal / cameras.project_jac."""
    fx, fy, cx, cy = par[0], par[1], par[2], par[3]
    if kind == cam_mod.PINHOLE:
        iz = 1.0 / torch.where(torch.abs(Z) < 1e-6, 1e-6, Z)
        iz2 = iz * iz
        zero = torch.zeros_like(X)
        u, v = fx * X * iz + cx, fy * Y * iz + cy
        j = (fx * iz, zero, -fx * X * iz2, zero, fy * iz, -fy * Y * iz2)
    else:  # KANNALA_BRANDT8
        k1, k2, k3, k4 = par[4], par[5], par[6], par[7]
        r2 = torch.clamp(X * X + Y * Y, min=1e-18)
        r = torch.sqrt(r2)
        theta = torch.atan2(r, Z)
        t2 = theta * theta
        d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        dd = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2
                                          + t2 * (7.0 * k3 + 9.0 * k4 * t2)))
        rho2 = r2 + Z * Z
        dth_dx = X * Z / (rho2 * r)
        dth_dy = Y * Z / (rho2 * r)
        dth_dz = -r / rho2
        s = d / r
        ds_dx = (dd * dth_dx * r - d * (X / r)) / r2
        ds_dy = (dd * dth_dy * r - d * (Y / r)) / r2
        ds_dz = dd * dth_dz / r
        u, v = fx * s * X + cx, fy * s * Y + cy
        j = (fx * (s + X * ds_dx), fx * X * ds_dy, fx * X * ds_dz,
             fy * Y * ds_dx, fy * (s + Y * ds_dy), fy * Y * ds_dz)
    return u, v, j, Z > 1e-3


def _soa_linearize(c: _EdgeConsts, kind, cam_q, cam_t, pts, M):
    """Residual (rx, ry), point jacobian (2x3), camera jacobian (2x6, zero
    on fixed edges) and depth mask of every edge, as [E] components."""
    free, cs = c.is_free, c.cslot
    qw, qx, qy, qz = (torch.where(free, cam_q[:, i][cs], c.q0[i])
                      for i in range(4))
    tx, ty, tz = (torch.where(free, cam_t[:, i][cs], c.t0[i])
                  for i in range(3))
    R = _soa_rot_from_quat(qw, qx, qy, qz)
    px, py, pz = (pts[:, i].repeat_interleave(M) for i in range(3))
    X = R[0] * px + R[1] * py + R[2] * pz + tx
    Y = R[3] * px + R[4] * py + R[5] * pz + ty
    Z = R[6] * px + R[7] * py + R[8] * pz + tz
    u, v, j, dok = _soa_project_and_jac(kind, c.par, X, Y, Z)
    j00, j01, j02, j10, j11, j12 = j
    # Jp = dpi @ R
    jp = (j00 * R[0] + j01 * R[3] + j02 * R[6],
          j00 * R[1] + j01 * R[4] + j02 * R[7],
          j00 * R[2] + j01 * R[5] + j02 * R[8],
          j10 * R[0] + j11 * R[3] + j12 * R[6],
          j10 * R[1] + j11 * R[4] + j12 * R[7],
          j10 * R[2] + j11 * R[5] + j12 * R[8])
    # Jc = [dpi | -dpi @ hat(Xc)]
    zf = free.to(X.dtype)
    jc = (j00 * zf, j01 * zf, j02 * zf,
          (-j01 * Z + j02 * Y) * zf, (j00 * Z - j02 * X) * zf,
          (-j00 * Y + j01 * X) * zf,
          j10 * zf, j11 * zf, j12 * zf,
          (-j11 * Z + j12 * Y) * zf, (j10 * Z - j12 * X) * zf,
          (-j10 * Y + j11 * X) * zf)
    return u - c.uvx, v - c.uvy, jp, jc, dok


# upper-triangle index of each entry of a symmetric 6x6 block
_IU6 = ((0, 1, 2, 3, 4, 5), (1, 6, 7, 8, 9, 10), (2, 7, 11, 12, 13, 14),
        (3, 8, 12, 15, 16, 17), (4, 9, 13, 16, 18, 19),
        (5, 10, 14, 17, 19, 20))


def _damp(H, free, lam):
    """LM damping of the diagonal; fixed or unused vertices get I."""
    dim = H.shape[-1]
    eye = torch.eye(dim, dtype=H.dtype, device=H.device)
    add = lam * torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6) \
        + 1e-8
    return torch.where(free[:, None, None], H + add[..., None] * eye, eye)


def _lm_iteration_dense(prob: WindowProblem, c: _EdgeConsts, kind, cam_q,
                        cam_t, pts, lam, edge_mask, huber_delta2, robust):
    """One LM step on the explicit reduced camera system.  Returns the
    stepped (q, t, pts) and the robust cost at the linearisation point."""
    Pw, M = prob.pm_uv.shape[:2]
    Kc = prob.cam_q.shape[0]
    dev = pts.device

    rx, ry, jp, jc, dok = _soa_linearize(c, kind, cam_q, cam_t, pts, M)
    chi2 = c.w0 * (rx * rx + ry * ry)
    active = edge_mask & dok
    cost_here = torch.where(active, _rho(chi2, huber_delta2), 0.0).sum()
    w_rob = _huber_w(chi2, huber_delta2) if robust else torch.ones_like(chi2)
    w = torch.where(active, c.w0 * w_rob, 0.0)

    def msum(a):  # per-point sum over the M observation slots
        return a.reshape(Pw, M).sum(1)

    wrx, wry = w * rx, w * ry
    g_p = torch.stack([msum(jp[a] * wrx + jp[3 + a] * wry)
                       for a in range(3)], dim=-1)
    hpp = {(a, b): msum(w * (jp[a] * jp[b] + jp[3 + a] * jp[3 + b]))
           for a in range(3) for b in range(a, 3)}
    Hpp = torch.stack([torch.stack([hpp[min(a, b), max(a, b)]
                                    for b in range(3)], -1)
                       for a in range(3)], -2)

    # camera blocks: 6 gradient + 21 Hcc comps per edge, summed per slot
    # (fixed edges go to a scratch slot Kc)
    cols = [jc[a] * wrx + jc[6 + a] * wry for a in range(6)]
    cols += [w * (jc[a] * jc[b] + jc[6 + a] * jc[6 + b])
             for a in range(6) for b in range(a, 6)]
    slot = torch.where(c.is_free, c.cslot, Kc)
    red = torch.zeros(Kc + 1, 27, dtype=pts.dtype, device=dev)
    red.index_add_(0, slot, torch.stack(cols, dim=-1))
    g_c = red[:Kc, :6]
    iu = torch.tensor(_IU6, device=dev)
    Hcc = red[:Kc, 6:][:, iu]                              # [Kc, 6, 6]

    # W blocks (Jc^T W Jp) summed per (point, camera slot): Z [Pw, Kc, 6, 3]
    wb = [w * (jc[a] * jp[b] + jc[6 + a] * jp[3 + b])
          for a in range(6) for b in range(3)]
    prow = torch.arange(Pw, device=dev).repeat_interleave(M)
    Z = torch.zeros(Pw * (Kc + 1), 18, dtype=pts.dtype, device=dev)
    Z.index_add_(0, prow * (Kc + 1) + slot, torch.stack(wb, dim=-1))
    Z = Z.reshape(Pw, Kc + 1, 6, 3)[:, :Kc]

    Hcc_l = _damp(Hcc, prob.cam_valid, lam)
    Hpp_inv = _spd_inv3(_damp(Hpp, prob.pt_valid, lam))

    # Schur coupling sum_p Z_p Hpp^-1 Z_p^T = (Z L)(Z L)^T, one matmul
    Zl = torch.einsum("pkab,pbc->pkac", Z, _chol3(Hpp_inv))
    Zf = Zl.permute(0, 3, 1, 2).reshape(Pw * 3, Kc * 6)
    H_red = (-(Zf.T @ Zf)).reshape(Kc, 6, Kc, 6)
    ii = torch.arange(Kc, device=dev)
    H_red[ii, :, ii, :] += Hcc_l
    H_red = H_red.reshape(Kc * 6, Kc * 6)
    z0 = torch.einsum("pab,pb->pa", Hpp_inv, g_p)
    b = -g_c + torch.einsum("pkab,pb->ka", Z, z0)

    # a failed factorisation (the reference's NaN) gives a zero step
    L, info = torch.linalg.cholesky_ex(H_red)
    dx = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(Kc, 6)
    dx_c = torch.where(prob.cam_valid[:, None], dx, 0.0)
    dx_c = torch.where((info == 0) & torch.isfinite(dx_c).all(), dx_c, 0.0)

    # point back-substitution
    vc = [dx_c[:, a][c.cslot] for a in range(6)]
    u = torch.stack([msum(sum(wb[a * 3 + b0] * vc[a] for a in range(6)))
                     for b0 in range(3)], dim=-1)
    dx_p = torch.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
    dx_p = torch.where(prob.pt_valid[:, None], dx_p, 0.0)
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)

    dT = lie.se3_exp(dx_c)
    new_q = lie.quat_normalize(lie.quat_mul(dT.q, cam_q))
    new_t = lie.quat_rotate(dT.q, cam_t) + dT.t
    return new_q, new_t, pts + dx_p, cost_here


def run_window_ba_dense(prob: WindowProblem, kind: int, iters: int = 10,
                        huber_delta2: float = CHI2_MONO,
                        robust: bool = True, chi2_th: float = CHI2_MONO,
                        pm_edge_mask=None,
                        lam0: float = 1e-4) -> WindowResult:
    """LM with accept/reject and adaptive damping over ``iters + 1``
    linearisations; the result holds the best point and its chi2 inliers
    among the masked edges."""
    mask0 = prob.pm_valid if pm_edge_mask is None \
        else (prob.pm_valid & pm_edge_mask)
    consts = _flatten_consts(prob)
    mask0_flat = mask0.reshape(-1)
    Pw, M = prob.pm_uv.shape[:2]
    dev = prob.pts.device

    q = bq = prob.cam_q
    t = bt = prob.cam_t
    p = bp = prob.pts
    bcost = torch.tensor(float("inf"), device=dev)
    lam = torch.tensor(lam0, device=dev)
    for _ in range(iters + 1):
        nq, nt, np_, cost = _lm_iteration_dense(
            prob, consts, kind, q, t, p, lam, mask0_flat, huber_delta2,
            robust)
        accept = cost < bcost
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
        bq = torch.where(accept, q, bq)
        bt = torch.where(accept, t, bt)
        bp = torch.where(accept, p, bp)
        bcost = torch.where(accept, cost, bcost)
        # apply the computed step from the best point
        dq = lie.quat_mul(nq, lie.quat_conj(q))
        dt = nt - lie.quat_rotate(dq, t)
        q = lie.quat_normalize(lie.quat_mul(dq, bq))
        t = lie.quat_rotate(dq, bt) + dt
        p = bp + (np_ - p)

    rx, ry, _, _, dok = _soa_linearize(consts, kind, bq, bt, bp, M)
    chi2 = consts.w0 * (rx * rx + ry * ry)
    inlier = (consts.valid & dok & (chi2 < chi2_th)).reshape(Pw, M)
    return WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                        pm_inlier=inlier & mask0, cost=bcost)
