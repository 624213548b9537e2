"""Visual-inertial optimisation: inertial BA, IMU initialisation and the
motion-only visual-inertial pose solve.

Port of ``mam3slam_tpu.solvers.vi`` (the reference's inertial g2o graphs:
FullInertialBA, LocalInertialBA, InertialOptimization,
PoseInertialOptimizationLastKeyFrame).  One 15-dof nav-state block per
keyframe, tangent [rho(3), phi(3), v(3), bg(3), ba(3)], T_cw with
camera == body.  Reprojection edges take ``ba._edge_linearize``'s
analytic jacobians in the first 6 dims; each preintegration edge fused
with the bias random walk is one 15-dim residual whitened by the
preintegration covariance, its jacobians taken in forward mode for all
edges at once (``pgo.batched_jacfwd``).  ``run_vi_ba`` solves its normal
equations by Schur-complement PCG: points eliminated per point, the
reduced nav-state system applied edge-wise with segment sums.

Where the reference's ``jnp.linalg`` inverse, Cholesky or solve returns
NaN for a matrix it cannot factor, the ``_ex`` variants here return NaN
too (torch's plain calls raise): a failed IMU initialisation shows as a
non-finite result, and an LM step built on it is rejected, as in the
reference.  The reference's ``axis_name`` (its mesh hook for sharded
edges) is ``run_vi_ba(group=)``: a ``torch.distributed`` process group
over which the edge sums are all-reduced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import segsum
from mam3slam_tpu_torch.solvers import ba as ba_mod
from mam3slam_tpu_torch.solvers import imu as imu_mod
from mam3slam_tpu_torch.solvers.ba_window import _huber_w, _rho, _spd_inv3
from mam3slam_tpu_torch.solvers.pgo import batched_jacfwd
from mam3slam_tpu_torch.utils import autodiff

GRAVITY = imu_mod.GRAVITY


class InertialEdges(NamedTuple):
    """Preintegration constraints between nav states; [M]-shaped."""

    i: torch.Tensor        # [M] i32 earlier KF slot
    j: torch.Tensor        # [M] i32 later KF slot
    preint: imu_mod.Preintegrated  # batched [M, ...]
    valid: torch.Tensor    # [M] bool


class VIProblem(NamedTuple):
    cam_q: torch.Tensor       # [K, 4] T_cw
    cam_t: torch.Tensor       # [K, 3]
    vel: torch.Tensor         # [K, 3] world-frame velocity
    bg: torch.Tensor          # [K, 3] gyro bias
    ba: torch.Tensor          # [K, 3] acc bias
    cam_params: torch.Tensor  # [K, 8]
    pts: torch.Tensor         # [P, 3]
    obs: ba_mod.Obs           # reprojection edges
    iedges: InertialEdges
    cam_free: torch.Tensor    # [K] bool
    pt_free: torch.Tensor     # [P] bool
    gravity: torch.Tensor     # [3] world gravity vector


class VIResult(NamedTuple):
    cam_q: torch.Tensor
    cam_t: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    pts: torch.Tensor
    cost: torch.Tensor


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _nan_unless(ok, x):
    """``x`` where the factorisation succeeded, NaN elsewhere (the
    reference's result for a matrix it cannot factor)."""
    return torch.where(ok.reshape(ok.shape + (1,) * (x.dim() - ok.dim())),
                       x, float("nan"))


def _inv(A):
    X, info = torch.linalg.inv_ex(A)
    return _nan_unless(info == 0, X)


def _cholesky(A):
    L, info = torch.linalg.cholesky_ex(A)
    return _nan_unless(info == 0, L)


def _solve(A, b):
    x, info = torch.linalg.solve_ex(A, b)
    return _nan_unless(info == 0, x)


def _body_state_from_tcw(q_cw, t_cw):
    """World-frame body rotation and position from T_cw (body ==
    camera)."""
    q_wc = lie.quat_conj(q_cw)
    return lie.quat_to_matrix(q_wc), -lie.quat_rotate(q_wc, t_cw)


def _retract(d, q, t, v, bg, ba):
    dT = lie.se3_exp(d[..., :6])
    return (lie.quat_normalize(lie.quat_mul(dT.q, q)),
            lie.quat_rotate(dT.q, t) + dT.t, v + d[..., 6:9],
            bg + d[..., 9:12], ba + d[..., 12:15])


def _edge_residual15(d_i, d_j, q_i, t_i, v_i, bg_i, ba_i,
                     q_j, t_j, v_j, bg_j, ba_j, preint, gravity):
    """15-dim residual of inertial edges at tangent perturbations d_i,
    d_j ([..., 15] each): EdgeInertial's rotation, velocity and position
    discrepancies and the bias random walk (EdgeGyroRW / EdgeAccRW)."""
    qi, ti, vi, bgi, bai = _retract(d_i, q_i, t_i, v_i, bg_i, ba_i)
    qj, tj, vj, bgj, baj = _retract(d_j, q_j, t_j, v_j, bg_j, ba_j)
    R_i, p_i = _body_state_from_tcw(qi, ti)
    R_j, p_j = _body_state_from_tcw(qj, tj)
    r9 = imu_mod.inertial_residual(preint, R_i, vi, p_i, R_j, vj, p_j,
                                   bgi, bai, gravity=gravity)
    return torch.cat([r9, bgj - bgi, baj - bai], -1)


def _edge_info15(preint: imu_mod.Preintegrated, walk_g2, walk_a2):
    """Edge information [..., 15, 15]: the inverse preintegration
    covariance and the bias random-walk information."""
    cov9 = preint.cov[..., :9, :9]
    info = torch.zeros(cov9.shape[:-2] + (15, 15), dtype=cov9.dtype,
                       device=cov9.device)
    info[..., :9, :9] = _inv(cov9 + 1e-9 * _eye(9, cov9))
    dt = torch.clamp(preint.dt, min=1e-6)[..., None, None]
    info[..., 9:12, 9:12] = _eye(3, cov9) / (walk_g2 * dt)
    info[..., 12:15, 12:15] = _eye(3, cov9) / (walk_a2 * dt)
    return info


def _edge_states(prob: VIProblem):
    ie = prob.iedges
    i, j = ie.i.long(), ie.j.long()
    return ((prob.cam_q[i], prob.cam_t[i], prob.vel[i], prob.bg[i],
             prob.ba[i]),
            (prob.cam_q[j], prob.cam_t[j], prob.vel[j], prob.bg[j],
             prob.ba[j]))


def _inertial_r_info(prob: VIProblem, walk_g2, walk_a2):
    """Residuals [M, 15] and information [M, 15, 15] of every inertial
    edge at the current state."""
    si, sj = _edge_states(prob)
    z = torch.zeros(prob.iedges.i.shape[0], 15, dtype=prob.cam_t.dtype,
                    device=prob.cam_t.device)
    r = _edge_residual15(z, z, *si, *sj, prob.iedges.preint, prob.gravity)
    return r, _edge_info15(prob.iedges.preint, walk_g2, walk_a2)


def _linearize_inertial(prob: VIProblem, walk_g2, walk_a2):
    """Residuals, jacobians and information of every inertial edge:
    (r [M, 15], Ji [M, 15, 15], Jj [M, 15, 15], info [M, 15, 15])."""
    si, sj = _edge_states(prob)
    preint = prob.iedges.preint
    r, J = batched_jacfwd(
        lambda x: _edge_residual15(x[:, :15], x[:, 15:], *si, *sj, preint,
                                   prob.gravity),
        torch.zeros(prob.iedges.i.shape[0], 30, dtype=prob.cam_t.dtype,
                    device=prob.cam_t.device))
    return (r, J[..., :15], J[..., 15:],
            _edge_info15(preint, walk_g2, walk_a2))


def vi_cost(prob: VIProblem, kind: int, walk_g2, walk_a2,
            huber_delta2: float = ba_mod.CHI2_MONO):
    """Robust total cost: reprojection Huber plus the inertial quadratic."""
    r, _, _, depth_ok = ba_mod._edge_linearize(
        prob.cam_q, prob.cam_t, prob.cam_params, kind, prob.pts, prob.obs)
    chi2 = prob.obs.w * (r * r).sum(-1)
    active = prob.obs.valid & depth_ok
    c_vis = torch.where(active, _rho(chi2, huber_delta2), 0.0).sum()
    ri, info = _inertial_r_info(prob, walk_g2, walk_a2)
    ci = torch.einsum("mi,mij,mj->m", ri, info, ri)
    return c_vis + torch.where(prob.iedges.valid, ci, 0.0).sum()


def _vi_plans(prob: VIProblem):
    """The segment plans of the valid reprojection edges onto their
    cameras and points and of the inertial edges onto their i and j
    states, built once per solve."""
    K = prob.cam_q.shape[0]
    cam_plan, pt_plan = ba_mod.edge_plans(prob)
    return (cam_plan, pt_plan, segsum.segment_plan(prob.iedges.i, K),
            segsum.segment_plan(prob.iedges.j, K))


def _vi_lm_iteration(prob: VIProblem, kind: int, lam, walk_g2, walk_a2,
                     huber_delta2, cg_iters, plans, group=None):
    """One LM step over the 15-dof nav blocks with the points
    Schur-eliminated (``plans`` are ``_vi_plans(prob)``); with a process
    group every segment sum is all-reduced over it (edges sharded).
    Returns (q, t, vel, bg, ba, pts)."""
    K = prob.cam_q.shape[0]
    obs = prob.obs
    oc, op = obs.cam.long(), obs.pt.long()
    oc_plan, op_plan, ii_plan, jj_plan = plans

    def seg(vals, plan):
        return ba_mod._segsum(vals, plan, group)

    dt_, dev = prob.cam_t.dtype, prob.cam_t.device
    eye15 = _eye(15, prob.cam_t)
    eye3 = _eye(3, prob.cam_t)

    # reprojection part (the first 6 tangent dims of each nav block)
    r, Jc6, Jp, depth_ok = ba_mod._edge_linearize(
        prob.cam_q, prob.cam_t, prob.cam_params, kind, prob.pts, obs)
    chi2 = obs.w * (r * r).sum(-1)
    w = torch.where(obs.valid & depth_ok,
                    obs.w * _huber_w(chi2, huber_delta2), 0.0)
    Jc6 = torch.where(prob.cam_free[oc][:, None, None], Jc6, 0.0)
    Jp = torch.where(prob.pt_free[op][:, None, None], Jp, 0.0)
    wJc = Jc6 * w[:, None, None]
    wJp = Jp * w[:, None, None]

    g_c = torch.zeros(K, 15, dtype=dt_, device=dev)
    g_c[:, :6] = seg(torch.einsum("eij,ei->ej", wJc, r), oc_plan)
    g_p = seg(torch.einsum("eij,ei->ej", wJp, r), op_plan)
    Hcc = torch.zeros(K, 15, 15, dtype=dt_, device=dev)
    Hcc[:, :6, :6] = seg(torch.einsum("eik,eij->ekj", wJc, Jc6), oc_plan)
    Hpp = seg(torch.einsum("eik,eij->ekj", wJp, Jp), op_plan)
    W_e = torch.einsum("eik,eij->ekj", wJc, Jp)             # [E, 6, 3]

    # inertial part: a fixed endpoint's jacobian is zeroed, and the edge
    # stays while its other endpoint is free
    ri, Ji, Jj, info = _linearize_inertial(prob, walk_g2, walk_a2)
    ie = prob.iedges
    ii, jj = ie.i.long(), ie.j.long()
    free_i, free_j = prob.cam_free[ii], prob.cam_free[jj]
    em_any = ie.valid & (free_i | free_j)
    Ji = torch.where((em_any & free_i)[:, None, None], Ji, 0.0)
    Jj = torch.where((em_any & free_j)[:, None, None], Jj, 0.0)
    info = torch.where(em_any[:, None, None], info, 0.0)
    IJi = torch.einsum("mab,mbc->mac", info, Ji)
    IJj = torch.einsum("mab,mbc->mac", info, Jj)
    g_c = g_c + seg(torch.einsum("mac,ma->mc", IJi, ri), ii_plan)
    g_c = g_c + seg(torch.einsum("mac,ma->mc", IJj, ri), jj_plan)
    Hcc = Hcc + seg(torch.einsum("mca,mab->mcb", Ji.transpose(1, 2), IJi),
                    ii_plan)
    Hcc = Hcc + seg(torch.einsum("mca,mab->mcb", Jj.transpose(1, 2), IJj),
                    jj_plan)

    # damping
    diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    add = lam * torch.clamp(diag, min=1e-6) + 1e-8
    Hcc_l = torch.where(prob.cam_free[:, None, None],
                        Hcc + add[..., None] * eye15, eye15)
    diagp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_l = Hpp + (lam * torch.clamp(diagp, min=1e-6)
                   + 1e-8)[..., None] * eye3
    Hpp_l = torch.where(prob.pt_free[:, None, None], Hpp_l, eye3)
    Hpp_inv = _spd_inv3(Hpp_l)

    # cross blocks between the i and j nav states of each edge
    Hij = torch.einsum("mca,mab->mcb", Ji.transpose(1, 2), IJj)

    def S_mv(v):  # [K, 15]
        u = torch.einsum("ekj,ek->ej", W_e, v[:, :6][oc])
        z = torch.einsum("pij,pj->pi", Hpp_inv, seg(u, op_plan))
        back = torch.einsum("ekj,ej->ek", W_e, z[op])
        out = torch.einsum("kij,kj->ki", Hcc_l, v)
        out[:, :6] -= seg(back, oc_plan)
        out = out + seg(torch.einsum("mcb,mb->mc", Hij, v[jj]), ii_plan)
        return out + seg(torch.einsum("mbc,mb->mc", Hij, v[ii]), jj_plan)

    z0 = torch.einsum("pij,pj->pi", Hpp_inv, g_p)
    b = -g_c
    b[:, :6] += seg(torch.einsum("ekj,ej->ek", W_e, z0[op]), oc_plan)
    WHW = torch.einsum("eik,ekl,ejl->eij", W_e, Hpp_inv[op], W_e)
    S_diag = Hcc_l.clone()
    S_diag[:, :6, :6] -= seg(WHW, oc_plan)
    M_inv = _inv(S_diag + 1e-8 * eye15)

    def precond(v):
        return torch.einsum("kij,kj->ki", M_inv, v)

    x = torch.zeros_like(b)
    rr = b - S_mv(x)
    p = precond(rr)
    rz = (rr * p).sum()
    for _ in range(cg_iters):
        Sp = S_mv(p)
        denom = (p * Sp).sum()
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        rr = rr - alpha * Sp
        zz = precond(rr)
        rz_new = (rr * zz).sum()
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = zz + beta * p
        rz = rz_new
    dx = torch.where(prob.cam_free[:, None], x, 0.0)

    u = torch.einsum("ekj,ek->ej", W_e, dx[:, :6][oc])
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, -g_p - seg(u, op_plan))
    dx_p = torch.where(prob.pt_free[:, None], dx_p, 0.0)

    dT = lie.se3_exp(dx[:, :6])
    return (lie.quat_normalize(lie.quat_mul(dT.q, prob.cam_q)),
            lie.quat_rotate(dT.q, prob.cam_t) + dT.t,
            prob.vel + dx[:, 6:9], prob.bg + dx[:, 9:12],
            prob.ba + dx[:, 12:15], prob.pts + dx_p)


def run_vi_ba(prob: VIProblem, kind: int, calib: imu_mod.ImuCalib,
              iters: int = 10, cg_iters: int = 40,
              huber_delta2: float = ba_mod.CHI2_MONO,
              lam0: float = 1e-4, group=None) -> VIResult:
    """Visual-inertial BA (FullInertialBA; with boundary keyframes fixed
    through ``cam_free``, LocalInertialBA / MergeInertialBA): LM with
    accept / reject.  ``group``: the process group the linearisation's
    segment sums are all-reduced over (the reference's ``axis_name``)."""
    _, _, walk_g2, walk_a2 = imu_mod.calib_squares(calib, prob.cam_t)
    lam = torch.tensor(lam0, dtype=prob.cam_t.dtype, device=prob.cam_t.device)
    cost = vi_cost(prob, kind, walk_g2, walk_a2, huber_delta2)
    names = ("cam_q", "cam_t", "vel", "bg", "ba", "pts")
    plans = _vi_plans(prob)
    for _ in range(iters):
        new = _vi_lm_iteration(prob, kind, lam, walk_g2, walk_a2,
                               huber_delta2, cg_iters, plans, group)
        trial = prob._replace(**dict(zip(names, new)))
        new_cost = vi_cost(trial, kind, walk_g2, walk_a2, huber_delta2)
        accept = new_cost < cost
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
        prob = prob._replace(**{n: torch.where(accept, getattr(trial, n),
                                               getattr(prob, n))
                                for n in names})
        cost = torch.where(accept, new_cost, cost)
    return VIResult(cam_q=prob.cam_q, cam_t=prob.cam_t, vel=prob.vel,
                    bg=prob.bg, ba=prob.ba, pts=prob.pts, cost=cost)


# ---------------------------------------------------------------------------
# IMU initialisation (the reference's InertialOptimization)
# ---------------------------------------------------------------------------

def inertial_optimization(cam_q, cam_t, kf_valid, iedges: InertialEdges,
                          calib: imu_mod.ImuCalib, fix_scale: bool = False,
                          iters: int = 30, prior_g: float = 1e2,
                          prior_a: float = 1e6):
    """With the visual map fixed, estimate the gravity direction, the
    scale, one shared bias pair and per-keyframe velocities.  Returns
    (R_wg [3, 3], scale, bg [3], ba [3], vel [K, 3]); the map moves by
    p' = s * R_wg^T p (Map::ApplyScaledRotation)."""
    del kf_valid  # every keyframe takes part, as in the reference
    K = cam_q.shape[0]
    f32, dev = cam_t.dtype, cam_t.device
    R_wb, p_w = _body_state_from_tcw(cam_q, cam_t)
    g0 = torch.tensor([0.0, 0.0, -GRAVITY], dtype=f32, device=dev)
    ii, jj = iedges.i.long(), iedges.j.long()
    preint = iedges.preint
    info9 = _inv(preint.cov[..., :9, :9] + 1e-9 * _eye(9, cam_t))
    L9 = _cholesky(info9 + 1e-9 * _eye(9, cam_t))
    sq_g, sq_a = prior_g ** 0.5, prior_a ** 0.5

    def unpack(x):
        phi_g = torch.cat([x[0:2], torch.zeros_like(x[:1])])  # 2-dof
        return phi_g, torch.exp(x[2]), x[3:6], x[6:9], x[9:].reshape(K, 3)

    def residuals(x):
        phi_g, s, bg, ba, vel = unpack(x)
        s_eff = 1.0 if fix_scale else s
        g = lie.so3_exp(phi_g) @ g0
        r9 = imu_mod.inertial_residual(
            preint, R_wb[ii], vel[ii], s_eff * p_w[ii], R_wb[jj], vel[jj],
            s_eff * p_w[jj], bg, ba, gravity=g)
        r = torch.einsum("mba,mb->ma", L9, r9)            # L^T r
        r = torch.where(iedges.valid[:, None], r, 0.0).reshape(-1)
        # bias priors (the reference's priorG / priorA)
        return torch.cat([r, sq_g * bg, sq_a * ba])

    def with_value(x):
        r = residuals(x)
        return r, r

    eye = _eye(9 + 3 * K, cam_t)
    x = torch.zeros(9 + 3 * K, dtype=f32, device=dev)
    lam = torch.tensor(1e-2, dtype=f32, device=dev)
    for _ in range(iters):
        J, r = autodiff.jacfwd(with_value, x, has_aux=True)
        H = J.T @ J
        H = (H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
             + 1e-9 * eye)
        x_new = x + _solve(H, -(J.T @ r))
        better = (residuals(x_new) ** 2).sum() < (r ** 2).sum()
        x = torch.where(better, x_new, x)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e6))
    phi_g, s, bg, ba, vel = unpack(x)
    if fix_scale:
        s = torch.ones_like(s)
    return lie.so3_exp(phi_g), s, bg, ba, vel


# ---------------------------------------------------------------------------
# motion-only visual-inertial pose optimisation
# ---------------------------------------------------------------------------

def pose_inertial_optimization(q0, t0, v0, bg0, ba0, cam_params, kind: int,
                               pts, uv, w, valid,
                               q_ref, t_ref, v_ref, bg_ref, ba_ref,
                               preint: imu_mod.Preintegrated,
                               calib: imu_mod.ImuCalib,
                               gravity: Optional[torch.Tensor] = None,
                               rounds: int = 4, iters: int = 6):
    """The current frame's nav state against the reprojections of fixed
    map points, the preintegration edge to the fixed reference keyframe
    and the bias random walk (PoseInertialOptimizationLastKeyFrame).
    Returns (q, t, v, bg, ba, inlier [N] bool)."""
    f32, dev = pts.dtype, pts.device
    g = imu_mod._gravity(gravity, pts)
    delta2 = ba_mod.CHI2_MONO
    info15 = _edge_info15(preint, *imu_mod.calib_squares(calib, pts)[2:])
    L15 = _cholesky(info15 + 1e-9 * _eye(15, pts))
    z15 = torch.zeros(15, dtype=f32, device=dev)
    cam = cam_mod.Camera(cam_params, kind)

    def vis_residual(d, q, t):
        dT = lie.se3_exp(d[:6])
        nq = lie.quat_normalize(lie.quat_mul(dT.q, q))
        nt = lie.quat_rotate(dT.q, t) + dT.t
        Xc = lie.quat_rotate(nq[None], pts) + nt[None]
        return cam_mod.project_ideal(cam, Xc) - uv, Xc[:, 2]

    # the edge as a batch of one: under forward mode a scalar-shaped
    # rotation matrix gives quat_from_matrix f64 tangents
    preint1 = imu_mod.Preintegrated(*(x[None] for x in preint))
    ref1 = tuple(x[None] for x in (q_ref, t_ref, v_ref, bg_ref, ba_ref))

    def inertial_r(d, *state):
        r = _edge_residual15(z15[None], d[None], *ref1,
                             *(x[None] for x in state), preint1, g)
        return L15.T @ r[0]

    def state_cost(q, t, v, bg, ba, active):
        r, depth = vis_residual(z15, q, t)
        chi2 = w * (r * r).sum(-1)
        c_vis = torch.where(active & (depth > 1e-3), _rho(chi2, delta2),
                            0.0).sum()
        ri = inertial_r(z15, q, t, v, bg, ba)
        return c_vis + (ri * ri).sum()

    def lm_rounds(state, active, robust):
        lam = torch.tensor(1e-3, dtype=f32, device=dev)
        bcost = state_cost(*state, active)
        for _ in range(iters):
            q, t, v, bg, ba = state
            # both edge families linearised at the current (best) state
            def vis(d):
                r, depth = vis_residual(d, q, t)
                return r, (r, depth)

            Jv, (r, depth) = autodiff.jacfwd(vis, z15, has_aux=True)
            chi2 = w * (r * r).sum(-1)
            w_rob = (_huber_w(chi2, delta2) if robust
                     else torch.ones_like(chi2))
            we = torch.where(active & (depth > 1e-3), w * w_rob, 0.0)
            H = torch.einsum("n,nid,nie->de", we, Jv, Jv)
            gvec = torch.einsum("n,nid,ni->d", we, Jv, r)
            Jin, ri = autodiff.jacfwd(
                lambda d: (inertial_r(d, q, t, v, bg, ba),) * 2, z15,
                has_aux=True)
            H = H + Jin.T @ Jin
            gvec = gvec + Jin.T @ ri
            H = (H + lam * torch.diag(torch.clamp(torch.diagonal(H),
                                                  min=1e-6))
                 + 1e-8 * _eye(15, pts))
            dx = _solve(H, -gvec)
            dT = lie.se3_exp(dx[:6])
            new = (lie.quat_normalize(lie.quat_mul(dT.q, q)),
                   lie.quat_rotate(dT.q, t) + dT.t, v + dx[6:9],
                   bg + dx[9:12], ba + dx[12:15])
            ncost = state_cost(*new, active)
            accept = ncost < bcost
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 4.0, max=1e4))
            state = tuple(torch.where(accept, a, b)
                          for a, b in zip(new, state))
            bcost = torch.where(accept, ncost, bcost)
        return state

    state = (q0, t0, v0, bg0, ba0)
    active = valid
    for rd in range(rounds):
        state = lm_rounds(state, active, robust=rd < 2)
        r, depth = vis_residual(z15, state[0], state[1])
        chi2 = w * (r * r).sum(-1)
        active = valid & (depth > 1e-3) & (chi2 <= delta2)
    return (*state, active)
