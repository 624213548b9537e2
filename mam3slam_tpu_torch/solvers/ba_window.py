"""Windowed bundle adjustment over the dense two-view layout.

Port of ``mam3slam_tpu.solvers.ba_window``: Huber-robust
Levenberg-Marquardt over a window of free keyframes and the points they
observe.  The problem (``WindowProblem``) lays the edges out point-major
(``[Pw, M]`` observation slots, fixed observers included) and, when
built with the camera-major view, camera-major (``[Kc, F]`` feature
slots of each free camera, bridged to their point-major slot).

* ``run_window_ba_dense`` forms the reduced camera system explicitly
  (Schur complement of the 3x3 point blocks), factors it with one
  Cholesky and back-substitutes the points; the per-edge math runs on
  flat component arrays (``[E]``, E = Pw * M) and the reference's
  one-hot matmuls are fixed-order segment sums (``ops/segsum.py``) over
  the free-camera slot, planned once per solve.  It reads only the
  point-major view.
* ``run_window_ba`` is the implicit-Schur PCG: free-camera edges are
  linearised camera-major and gathered into the point-major view, so both
  views hold the same values and the operator stays symmetric.

Both evaluate a trial's cost with the next iteration's linearisation, and
a rejected step re-steps from the best point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import segsum
from mam3slam_tpu_torch.solvers.ba import _damp, _huber_w, _pcg, _rho

CHI2_MONO = 5.991


class WindowProblem(NamedTuple):
    """Dense two-view BA problem (field meanings as in the reference).
    Kc = free-camera cap, F = features per keyframe, Pw = window-point
    cap, M = observation cap; the camera-major ``cm_*`` arrays have 0 rows
    in a problem built without that view."""

    cam_idx: torch.Tensor      # [Kc] arena KF slot, -1 = unused
    cam_valid: torch.Tensor    # [Kc] bool
    cam_q: torch.Tensor        # [Kc, 4]
    cam_t: torch.Tensor        # [Kc, 3]
    cam_params: torch.Tensor   # [Kc, 8]
    cm_uv: torch.Tensor        # [Kc, F, 2]
    cm_w: torch.Tensor         # [Kc, F] information (1 / sigma^2)
    cm_pt: torch.Tensor        # [Kc, F] point slot into Pw, -1 = none
    cm_mslot: torch.Tensor     # [Kc, F] point-major slot m of the edge
    cm_valid: torch.Tensor     # [Kc, F]
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


def _spd_inv6(A):
    return torch.linalg.inv_ex(A + 1e-8 * torch.eye(6, dtype=A.dtype,
                                                    device=A.device))[0]


# ---------------------------------------------------------------------------
# implicit-Schur PCG over both views
# ---------------------------------------------------------------------------

def _cm_linearize(prob: WindowProblem, kind, cam_q, cam_t, pts):
    """Camera-major residuals and jacobians [Kc, F, ...] of the free-camera
    edges: r, Jc, Jp, depth_ok."""
    X = pts[torch.clamp(prob.cm_pt, min=0).long()]           # [Kc, F, 3]
    Xc = lie.quat_rotate(cam_q[:, None, :], X) + cam_t[:, None, :]
    cam = cam_mod.Camera(prob.cam_params[:, None, :], kind)
    r = cam_mod.project_ideal(cam, Xc) - prob.cm_uv
    dpi = cam_mod.project_jac(cam, Xc)                       # [Kc, F, 2, 3]
    Jc = torch.cat([dpi, -dpi @ lie.hat(Xc)], -1)
    Jp = dpi @ lie.quat_to_matrix(cam_q)[:, None]
    return r, Jc, Jp, Xc[..., 2] > 1e-3


def _pm_fixed_linearize(prob: WindowProblem, kind, pts):
    """Point-major residuals and point jacobians [Pw, M, ...] against the
    stored observer poses (used for the fixed-camera edges)."""
    Xc = lie.quat_rotate(prob.pm_q0, pts[:, None, :]) + prob.pm_t0
    cam = cam_mod.Camera(prob.pm_params0, kind)
    r = cam_mod.project_ideal(cam, Xc) - prob.pm_uv
    Jp = cam_mod.project_jac(cam, Xc) @ lie.quat_to_matrix(prob.pm_q0)
    return r, Jp, Xc[..., 2] > 1e-3


def _gather_cm(flat, cslot, feat, F):
    """Camera-major per-edge rows ``flat [Kc * F, ...]`` in point-major
    layout; fixed-camera slots read row 0 (callers mask them)."""
    return flat[(torch.clamp(cslot, min=0) * F
                 + torch.clamp(feat, min=0)).long()]


def _both_views(prob: WindowProblem, kind, cam_q, cam_t, pts):
    """The camera-major linearisation and its point-major copy (free
    edges gathered from it, fixed edges linearised directly): (r_cm, Jc_cm,
    Jp_cm, dok_cm, r_pm, Jp_pm, dok_pm)."""
    F = prob.cm_uv.shape[1]
    is_free = prob.pm_cslot >= 0
    r_cm, Jc_cm, Jp_cm, dok_cm = _cm_linearize(prob, kind, cam_q, cam_t, pts)
    r_fx, Jp_fx, dok_fx = _pm_fixed_linearize(prob, kind, pts)

    def pm(flat, fixed):
        got = _gather_cm(flat, prob.pm_cslot, prob.pm_feat, F)
        sel = is_free.reshape(is_free.shape + (1,) * (got.dim() - 2))
        return torch.where(sel, got, fixed)

    return (r_cm, Jc_cm, Jp_cm, dok_cm,
            pm(r_cm.reshape(-1, 2), r_fx),
            pm(Jp_cm.reshape(-1, 2, 3), Jp_fx),
            pm(dok_cm.reshape(-1), dok_fx))


def window_cost_and_inliers(prob: WindowProblem, kind, cam_q, cam_t, pts,
                            chi2_th: float = CHI2_MONO):
    """Robust cost and chi2 inlier mask over the point-major edge set,
    which holds every edge once (free edges gathered from the
    camera-major view, fixed edges direct)."""
    *_, r, _, dok = _both_views(prob, kind, cam_q, cam_t, pts)
    chi2 = prob.pm_w * (r * r).sum(-1)
    active = prob.pm_valid & dok
    cost = torch.where(active, _rho(chi2, chi2_th), 0.0).sum()
    return cost, active & (chi2 < chi2_th)


def cm_mask_from_pm(prob: WindowProblem, pm_mask):
    """A point-major edge mask on the camera-major grid, through each free
    edge's recorded point-major slot."""
    return pm_mask[torch.clamp(prob.cm_pt, min=0).long(),
                   torch.clamp(prob.cm_mslot, min=0).long()] & prob.cm_valid


def pm_linearize_all(prob: WindowProblem, kind, cam_q, cam_t, pts):
    """Point-major linearisation of every edge in one pass (free edges
    read the camera state through ``pm_cslot``, fixed edges the stored
    poses): r [Pw, M, 2], Jp [Pw, M, 2, 3], Jc [Pw, M, 2, 6] (zero on
    fixed edges), depth_ok."""
    is_free = prob.pm_cslot >= 0
    csl = torch.clamp(prob.pm_cslot, min=0).long()
    q = torch.where(is_free[..., None], cam_q[csl], prob.pm_q0)
    t = torch.where(is_free[..., None], cam_t[csl], prob.pm_t0)
    Xc = lie.quat_rotate(q, pts[:, None, :]) + t
    cam = cam_mod.Camera(prob.pm_params0, kind)
    r = cam_mod.project_ideal(cam, Xc) - prob.pm_uv
    dpi = cam_mod.project_jac(cam, Xc)
    Jp = dpi @ lie.quat_to_matrix(q)
    Jc = torch.cat([dpi, -dpi @ lie.hat(Xc)], -1)
    Jc = torch.where(is_free[..., None, None], Jc, 0.0)
    return r, Jp, Jc, Xc[..., 2] > 1e-3


def _lm_iteration(prob: WindowProblem, kind, cam_q, cam_t, pts, lam,
                  pm_edge_mask, cm_edge_mask, huber_delta2, cg_iters,
                  robust):
    """One LM step of the implicit-Schur PCG.  Returns the stepped (q, t,
    pts) and the robust cost at the linearisation point."""
    is_free = prob.pm_cslot >= 0
    r_cm, Jc_cm, Jp_cm, dok_cm, r_pm, Jp_pm, dok_pm = _both_views(
        prob, kind, cam_q, cam_t, pts)

    chi2_pm = prob.pm_w * (r_pm * r_pm).sum(-1)
    cost_here = torch.where(pm_edge_mask & dok_pm,
                            _rho(chi2_pm, huber_delta2), 0.0).sum()
    w_rob_pm = _huber_w(chi2_pm, huber_delta2) if robust \
        else torch.ones_like(chi2_pm)
    w_pm = torch.where(pm_edge_mask & dok_pm, prob.pm_w * w_rob_pm, 0.0)
    # the camera-major weights from the same residuals, over the same
    # edge set (the run's mask projected onto the grid)
    chi2_cm = prob.cm_w * (r_cm * r_cm).sum(-1)
    w_rob_cm = _huber_w(chi2_cm, huber_delta2) if robust \
        else torch.ones_like(chi2_cm)
    w_cm = torch.where(cm_edge_mask & dok_cm, prob.cm_w * w_rob_cm, 0.0)

    wJc = Jc_cm * w_cm[..., None, None]                      # [Kc, F, 2, 6]
    g_c = torch.einsum("kfij,kfi->kj", wJc, r_cm)
    Hcc = torch.einsum("kfia,kfib->kab", wJc, Jc_cm)
    W_cm = torch.einsum("kfia,kfib->kfab", wJc, Jp_cm)       # [Kc, F, 6, 3]
    wJp_pm = Jp_pm * w_pm[..., None, None]
    g_p = torch.einsum("pmij,pmi->pj", wJp_pm, r_pm)
    Hpp = torch.einsum("pmia,pmib->pab", wJp_pm, Jp_pm)
    F = prob.cm_uv.shape[1]
    W_pm = torch.where(is_free[..., None, None], _gather_cm(
        W_cm.reshape(-1, 6, 3), prob.pm_cslot, prob.pm_feat, F), 0.0)

    Hcc_l = _damp(Hcc, prob.cam_valid, lam)
    Hpp_inv = _spd_inv3(_damp(Hpp, prob.pt_valid, lam))
    ptc = torch.clamp(prob.cm_pt, min=0).long()
    csl = torch.clamp(prob.pm_cslot, min=0).long()

    def S_mv(v):                                             # v [Kc, 6]
        u = torch.einsum("pmab,pma->pb", W_pm, v[csl])
        z = torch.einsum("pab,pb->pa", Hpp_inv, u)
        back = torch.einsum("kfab,kfb->ka", W_cm, z[ptc])
        return torch.einsum("kab,kb->ka", Hcc_l, v) - back

    z0 = torch.einsum("pab,pb->pa", Hpp_inv, g_p)
    b = -g_c + torch.einsum("kfab,kfb->ka", W_cm, z0[ptc])
    WHW = torch.einsum("kfab,kfbc,kfdc->kfad", W_cm, Hpp_inv[ptc], W_cm)
    M_inv = _spd_inv6(Hcc_l - WHW.sum(1))
    x = _pcg(S_mv, lambda v: torch.einsum("kab,kb->ka", M_inv, v),
                    b, cg_iters)
    dx_c = torch.where(prob.cam_valid[:, None], x, 0.0)

    u = torch.einsum("pmab,pma->pb", W_pm, dx_c[csl])
    dx_p = torch.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
    dx_p = torch.where(prob.pt_valid[:, None], dx_p, 0.0)
    dT = lie.se3_exp(dx_c)
    return (lie.quat_normalize(lie.quat_mul(dT.q, cam_q)),
            lie.quat_rotate(dT.q, cam_t) + dT.t, pts + dx_p, cost_here)


def run_window_ba(prob: WindowProblem, kind: int, iters: int = 10,
                  cg_iters: int = 30, huber_delta2: float = CHI2_MONO,
                  robust: bool = True, chi2_th: float = CHI2_MONO,
                  pm_edge_mask=None, lam0: float = 1e-4) -> WindowResult:
    """The implicit-Schur PCG LM (needs the camera-major view) with
    accept / reject over ``iters + 1`` linearisations."""
    mask0 = prob.pm_valid if pm_edge_mask is None \
        else (prob.pm_valid & pm_edge_mask)
    cm_mask0 = cm_mask_from_pm(prob, mask0)
    bq, bt, bp, bcost = _lm_loop(
        lambda q, t, p, lam: _lm_iteration(
            prob, kind, q, t, p, lam, mask0, cm_mask0, huber_delta2,
            cg_iters, robust), prob.cam_q, prob.cam_t, prob.pts, iters, lam0)
    _, inlier = window_cost_and_inliers(prob, kind, bq, bt, bp, chi2_th)
    return WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                        pm_inlier=inlier & mask0, cost=bcost)


def _lm_loop(step, q, t, p, iters: int, lam0: float):
    """The window solvers' accept / reject loop: ``step(q, t, p, lam)``
    linearises at (q, t, p) and returns the stepped state and the robust
    cost there; the trial's cost is read at the next linearisation, and a
    rejected trial re-steps from the best point with this linearisation.
    Returns the best (q, t, p, cost)."""
    bq, bt, bp = q, t, p
    bcost = torch.tensor(float("inf"), device=p.device)
    lam = torch.tensor(lam0, device=p.device)
    for _ in range(iters + 1):
        nq, nt, np_, cost = step(q, t, p, lam)
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
    return bq, bt, bp, bcost


# ---------------------------------------------------------------------------
# dense reduced camera system
# ---------------------------------------------------------------------------

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
    cam_plan: segsum.SegmentPlan   # free edges by camera slot -> [Kc]
    pair_plan: segsum.SegmentPlan  # free edges by (point, slot) -> [Pw Kc]


def _flatten_consts(prob: WindowProblem) -> _EdgeConsts:
    def f(a):
        return a.reshape(-1)

    Pw, M = prob.pm_uv.shape[:2]
    Kc = prob.cam_q.shape[0]
    is_free = f(prob.pm_cslot >= 0)
    cslot = f(torch.clamp(prob.pm_cslot, min=0)).long()
    prow = torch.arange(Pw, device=cslot.device).repeat_interleave(M)
    # fixed edges are summed nowhere (index -1)
    return _EdgeConsts(
        uvx=f(prob.pm_uv[..., 0]), uvy=f(prob.pm_uv[..., 1]),
        w0=f(prob.pm_w), valid=f(prob.pm_valid), is_free=is_free,
        cslot=cslot,
        q0=tuple(f(prob.pm_q0[..., i]) for i in range(4)),
        t0=tuple(f(prob.pm_t0[..., i]) for i in range(3)),
        par=tuple(f(prob.pm_params0[..., i]) for i in range(8)),
        cam_plan=segsum.segment_plan(torch.where(is_free, cslot, -1), Kc),
        pair_plan=segsum.segment_plan(
            torch.where(is_free, prow * Kc + cslot, -1), Pw * Kc))


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


def _soa_blocks(w, rx, ry, jp, jc, Pw: int, M: int):
    """The weighted normal-equation blocks of [E] edge components (E =
    Pw * M): per point the gradient [Pw, 3] and Hpp [Pw, 3, 3] (sums over
    its M slots), and per edge the camera block's 6 gradient and 21
    upper-triangle Hcc components and the 18 of W = Jc^T w Jp (lists of
    [E] tensors)."""
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
    cols = [jc[a] * wrx + jc[6 + a] * wry for a in range(6)]
    cols += [w * (jc[a] * jc[b] + jc[6 + a] * jc[6 + b])
             for a in range(6) for b in range(a, 6)]
    wb = [w * (jc[a] * jp[b] + jc[6 + a] * jp[3 + b])
          for a in range(6) for b in range(3)]
    return g_p, Hpp, cols, wb


def _lm_iteration_dense(prob: WindowProblem, c: _EdgeConsts, kind, cam_q,
                        cam_t, pts, lam, edge_mask, huber_delta2, robust,
                        group=None):
    """One LM step on the explicit reduced camera system.  Returns the
    stepped (q, t, pts) and the robust cost at the linearisation point.
    With a process group the problem's points are this rank's shard: the
    reduced system's parts (coupling, camera blocks, Schur RHS, cost) are
    summed over the group in one packed all-reduce, and each rank solves
    the same reduced system."""
    Pw, M = prob.pm_uv.shape[:2]
    Kc = prob.cam_q.shape[0]
    dev = pts.device

    rx, ry, jp, jc, dok = _soa_linearize(c, kind, cam_q, cam_t, pts, M)
    chi2 = c.w0 * (rx * rx + ry * ry)
    active = edge_mask & dok
    cost_here = torch.where(active, _rho(chi2, huber_delta2), 0.0).sum()
    w_rob = _huber_w(chi2, huber_delta2) if robust else torch.ones_like(chi2)
    w = torch.where(active, c.w0 * w_rob, 0.0)

    g_p, Hpp, cols, wb = _soa_blocks(w, rx, ry, jp, jc, Pw, M)

    # camera blocks: 6 gradient + 21 Hcc comps per free edge, summed per
    # slot, and the W blocks (Jc^T W Jp) per (point, camera slot): Z [Pw,
    # Kc, 6, 3]
    red = segsum.segment_sum(c.cam_plan, torch.stack(cols, dim=-1))
    Z = segsum.segment_sum(c.pair_plan, torch.stack(wb, dim=-1)
                           ).reshape(Pw, Kc, 6, 3)

    Hpp_inv = _spd_inv3(_damp(Hpp, prob.pt_valid, lam))
    # Schur coupling sum_p Z_p Hpp^-1 Z_p^T = (Z L)(Z L)^T, one matmul
    Zl = torch.einsum("pkab,pbc->pkac", Z, _chol3(Hpp_inv))
    Zf = Zl.permute(0, 3, 1, 2).reshape(Pw * 3, Kc * 6)
    C = Zf.T @ Zf
    z0 = torch.einsum("pab,pb->pa", Hpp_inv, g_p)
    bz = torch.einsum("pkab,pb->ka", Z, z0)
    if group is not None:
        flat = torch.cat([C.reshape(-1), red.reshape(-1), bz.reshape(-1),
                          cost_here[None]])
        dist.all_reduce(flat, group=group)
        n_c, n_r = C.numel(), red.numel()
        C = flat[:n_c].reshape(C.shape)
        red = flat[n_c:n_c + n_r].reshape(Kc, 27)
        bz = flat[n_c + n_r:-1].reshape(Kc, 6)
        cost_here = flat[-1]

    g_c = red[:, :6]
    Hcc_l = _damp(red[:, 6:][:, torch.tensor(_IU6, device=dev)],
                  prob.cam_valid, lam)                     # [Kc, 6, 6]
    H_red = (-C).reshape(Kc, 6, Kc, 6)
    ii = torch.arange(Kc, device=dev)
    H_red[ii, :, ii, :] += Hcc_l
    H_red = H_red.reshape(Kc * 6, Kc * 6)
    b = -g_c + bz

    # a failed factorisation (the reference's NaN) gives a zero step
    L, info = torch.linalg.cholesky_ex(H_red)
    dx = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(Kc, 6)
    dx_c = torch.where(prob.cam_valid[:, None], dx, 0.0)
    dx_c = torch.where((info == 0) & torch.isfinite(dx_c).all(), dx_c, 0.0)

    # point back-substitution
    vc = [dx_c[:, a][c.cslot] for a in range(6)]
    u = torch.stack([sum(wb[a * 3 + b0] * vc[a] for a in range(6))
                     .reshape(Pw, M).sum(1) for b0 in range(3)], dim=-1)
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
    bq, bt, bp, bcost = _lm_loop(
        lambda q, t, p, lam: _lm_iteration_dense(
            prob, consts, kind, q, t, p, lam, mask0_flat, huber_delta2,
            robust), prob.cam_q, prob.cam_t, prob.pts, iters, lam0)
    inlier = _soa_inliers(consts, kind, bq, bt, bp, Pw, M, chi2_th)
    return WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                        pm_inlier=inlier & mask0, cost=bcost)


def _soa_inliers(c: _EdgeConsts, kind, cam_q, cam_t, pts, Pw, M, chi2_th):
    """[Pw, M] chi2 inlier mask of the valid edges at (q, t, pts)."""
    rx, ry, _, _, dok = _soa_linearize(c, kind, cam_q, cam_t, pts, M)
    chi2 = c.w0 * (rx * rx + ry * ry)
    return (c.valid & dok & (chi2 < chi2_th)).reshape(Pw, M)
