"""Edge-list bundle adjustment and motion-only pose optimisation
(reference Optimizer::BundleAdjustment / LocalBundleAdjustment and
PoseOptimization).

Port of ``mam3slam_tpu.solvers.ba``.  ``run_ba`` is the mask-aware LM
over an edge list (``BAProblem``): each iteration linearises every edge,
solves the reduced camera system by matrix-free Schur PCG (two segment
sums per product, block-Jacobi preconditioner) and back-substitutes the
points; every segment sum is a fixed-order one (``ops/segsum.py``) over
plans built once per solve.  With ``group`` (a ``torch.distributed``
process group) the edges are this rank's shard and every segment sum
and the cost are all-reduced over the group, so all ranks step
identically (``parallel/dist_ba.py``).  ``pose_optimization`` on CUDA
tensors runs the pose kernel of ``ops/cuda_pose.py`` for either camera
kind (the reference sends only PINHOLE to its Pallas kernel and KB8 to
XLA); CPU tensors take the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import cuda_pose, segsum

CHI2_MONO = cuda_pose.CHI2_MONO


class Obs(NamedTuple):
    """Observation edges, [E]-shaped tensors."""

    cam: torch.Tensor    # [E] i32 camera index
    pt: torch.Tensor     # [E] i32 point index
    uv: torch.Tensor     # [E, 2] measured pixel
    w: torch.Tensor      # [E] information 1 / sigma^2
    valid: torch.Tensor  # [E] bool


def _edge_linearize(cam_q, cam_t, cam_params, kind, pts, obs: Obs):
    """Residuals r = pred - uv [E, 2], analytic jacobians Jc [E, 2, 6]
    (left se3 tangent [rho, phi]) and Jp [E, 2, 3], and depth > 1e-3."""
    ci, pi = obs.cam.long(), obs.pt.long()
    q = cam_q[ci]
    Xc = lie.quat_rotate(q, pts[pi]) + cam_t[ci]
    cam = cam_mod.Camera(cam_params[ci], kind)
    r = cam_mod.project_ideal(cam, Xc) - obs.uv
    dpi = cam_mod.project_jac(cam, Xc)
    Jc = torch.cat([dpi, -dpi @ lie.hat(Xc)], -1)
    Jp = dpi @ lie.quat_to_matrix(q)
    return r, Jc, Jp, Xc[..., 2] > 1e-3


class BAProblem(NamedTuple):
    cam_q: torch.Tensor       # [K, 4] T_cw rotation (world -> camera)
    cam_t: torch.Tensor       # [K, 3]
    cam_params: torch.Tensor  # [K, 8] intrinsics
    pts: torch.Tensor         # [P, 3] world points
    obs: Obs
    cam_free: torch.Tensor    # [K] bool, False = fixed
    pt_free: torch.Tensor     # [P] bool


class BAResult(NamedTuple):
    cam_q: torch.Tensor
    cam_t: torch.Tensor
    pts: torch.Tensor
    inlier: torch.Tensor      # [E] bool, chi2-gated at the solution
    cost: torch.Tensor        # [] robust cost


def _segsum(vals: torch.Tensor, plan: segsum.SegmentPlan,
            group=None) -> torch.Tensor:
    """Fixed-order segment sum of per-edge values into the plan's vertex
    rows; with a process group, the partial sums are all-reduced over
    it."""
    out = segsum.segment_sum(plan, vals)
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def edge_plans(problem: BAProblem):
    """The segment plans of the valid edges onto their cameras and points,
    built once per solve (the edge list is fixed over its iterations).
    An invalid edge carries zero weight, so its rows are all zero and are
    summed nowhere (padded edges name point 0, and would make it one
    segment of most of the list)."""
    obs = problem.obs
    return (segsum.segment_plan(torch.where(obs.valid, obs.cam, -1),
                                problem.cam_q.shape[0]),
            segsum.segment_plan(torch.where(obs.valid, obs.pt, -1),
                                problem.pts.shape[0]))


_huber_w = cuda_pose._huber_w   # IRLS weight of the Huber kernel


def _rho(chi2, delta2):
    """The Huber cost of whitened chi2."""
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12))
                       - delta2)


def _spd_inv3(A: torch.Tensor, damp: float = 1e-8) -> torch.Tensor:
    return torch.linalg.inv_ex(A + damp * torch.eye(3, dtype=A.dtype,
                                                    device=A.device))[0]


def _spd_inv6(A: torch.Tensor, damp: float = 1e-8) -> torch.Tensor:
    return torch.linalg.inv_ex(A + damp * torch.eye(6, dtype=A.dtype,
                                                    device=A.device))[0]


def ba_cost_and_inliers(problem: BAProblem, kind: int,
                        chi2_th: float = CHI2_MONO, group=None):
    """Robust cost (all-reduced over ``group``) and the chi2 inlier mask
    of the edges at the current estimate."""
    r, _, _, depth_ok = _edge_linearize(
        problem.cam_q, problem.cam_t, problem.cam_params, kind,
        problem.pts, problem.obs)
    chi2 = problem.obs.w * (r * r).sum(-1)
    active = problem.obs.valid & depth_ok
    cost = torch.where(active, _rho(chi2, chi2_th), 0.0).sum()
    if group is not None:
        dist.all_reduce(cost, group=group)
    return cost, active & (chi2 < chi2_th)


def _damp(H, free, lam):
    """LM damping of the diagonal; fixed vertices get an identity block."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    add = lam * torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6) \
        + 1e-8
    return torch.where(free[:, None, None], H + add[..., None] * eye, eye)


def _lm_iteration(problem: BAProblem, kind: int, lam, edge_mask,
                  huber_delta2: float, cg_iters: int, robust: bool,
                  plans, group=None):
    """One LM step: linearise, Schur PCG for the camera step, point
    back-substitution; ``plans`` are ``edge_plans(problem)``.  Returns
    the trial (q, t, pts)."""
    obs = problem.obs
    oc, op = obs.cam.long(), obs.pt.long()
    cam_plan, pt_plan = plans

    def seg(vals, plan):
        return _segsum(vals, plan, group)

    r, Jc, Jp, depth_ok = _edge_linearize(
        problem.cam_q, problem.cam_t, problem.cam_params, kind,
        problem.pts, obs)
    chi2 = obs.w * (r * r).sum(-1)
    w_rob = _huber_w(chi2, huber_delta2) if robust else torch.ones_like(chi2)
    w = torch.where(edge_mask & depth_ok, obs.w * w_rob, 0.0)
    # fixed vertices' jacobians are zero (their state never moves)
    Jc = torch.where(problem.cam_free[oc][:, None, None], Jc, 0.0)
    Jp = torch.where(problem.pt_free[op][:, None, None], Jp, 0.0)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    g_c = seg(torch.einsum("eij,ei->ej", wJc, r), cam_plan)
    g_p = seg(torch.einsum("eij,ei->ej", wJp, r), pt_plan)
    Hcc = seg(torch.einsum("eik,eij->ekj", wJc, Jc), cam_plan)
    Hpp = seg(torch.einsum("eik,eij->ekj", wJp, Jp), pt_plan)
    W_e = torch.einsum("eik,eij->ekj", wJc, Jp)               # [E, 6, 3]

    Hcc_l = _damp(Hcc, problem.cam_free, lam)
    Hpp_inv = _spd_inv3(_damp(Hpp, problem.pt_free, lam))

    def S_mv(v):  # (Hcc_l - W Hpp^-1 W^T) v, v [K, 6]
        u = torch.einsum("ekj,ek->ej", W_e, v[oc])
        z = torch.einsum("pij,pj->pi", Hpp_inv, seg(u, pt_plan))
        back = torch.einsum("ekj,ej->ek", W_e, z[op])
        return torch.einsum("kij,kj->ki", Hcc_l, v) - seg(back, cam_plan)

    z0 = torch.einsum("pij,pj->pi", Hpp_inv, g_p)
    b = -g_c + seg(torch.einsum("ekj,ej->ek", W_e, z0[op]), cam_plan)
    WHW = torch.einsum("eik,ekl,ejl->eij", W_e, Hpp_inv[op], W_e)
    M_inv = _spd_inv6(Hcc_l - seg(WHW, cam_plan))
    x = _pcg(S_mv, lambda v: torch.einsum("kij,kj->ki", M_inv, v), b,
             cg_iters)
    dx_c = torch.where(problem.cam_free[:, None], x, 0.0)

    u = torch.einsum("ekj,ek->ej", W_e, dx_c[oc])
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, -g_p - seg(u, pt_plan))
    dx_p = torch.where(problem.pt_free[:, None], dx_p, 0.0)

    dT = lie.se3_exp(dx_c)
    return (lie.quat_normalize(lie.quat_mul(dT.q, problem.cam_q)),
            lie.quat_rotate(dT.q, problem.cam_t) + dT.t,
            problem.pts + dx_p)


def _pcg(S_mv, precond, b, iters: int):
    """``iters`` steps of preconditioned CG on S x = b from x = 0 (the
    reference's fixed-count loop, its divisions guarded at 1e-20)."""
    x = torch.zeros_like(b)
    rr = b - S_mv(x)
    p = precond(rr)
    rz = (rr * p).sum()
    for _ in range(iters):
        Sp = S_mv(p)
        den = (p * Sp).sum()
        alpha = rz / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
        x = x + alpha * p
        rr = rr - alpha * Sp
        zz = precond(rr)
        rz_new = (rr * zz).sum()
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = zz + beta * p
        rz = rz_new
    return x


def run_ba(problem: BAProblem, kind: int, iters: int = 10,
           cg_iters: int = 30, huber_delta2: float = CHI2_MONO,
           robust: bool = True, chi2_th: float = CHI2_MONO,
           edge_mask: Optional[torch.Tensor] = None, lam0: float = 1e-4,
           group=None) -> BAResult:
    """LM with accept / reject and adaptive damping over a fixed budget
    (the reference's BundleAdjustment / LocalBundleAdjustment): Huber
    robustness, chi2 inlier classification of the result's edges."""
    obs = problem.obs
    mask0 = obs.valid if edge_mask is None else (obs.valid & edge_mask)
    names = ("cam_q", "cam_t", "pts")

    def cost_at(prob):
        return ba_cost_and_inliers(prob, kind, chi2_th, group)[0]

    lam = torch.tensor(lam0, dtype=torch.float32, device=problem.pts.device)
    cost = cost_at(problem)
    plans = edge_plans(problem)
    for _ in range(iters):
        trial = problem._replace(**dict(zip(names, _lm_iteration(
            problem, kind, lam, mask0, huber_delta2, cg_iters, robust,
            plans, group))))
        new_cost = cost_at(trial)
        accept = new_cost < cost
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
        problem = problem._replace(**{
            n: torch.where(accept, getattr(trial, n), getattr(problem, n))
            for n in names})
        cost = torch.where(accept, new_cost, cost)
    _, inlier = ba_cost_and_inliers(problem, kind, chi2_th)
    return BAResult(cam_q=problem.cam_q, cam_t=problem.cam_t,
                    pts=problem.pts, inlier=inlier & mask0, cost=cost)


class PoseOptResult(NamedTuple):
    q: torch.Tensor          # [4]
    t: torch.Tensor          # [3]
    inlier: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor  # [] int32


def pose_optimization(q0, t0, cam_params, kind: int, pts, uv, w, valid,
                      rounds: int = 4, iters: int = 5) -> PoseOptResult:
    """Motion-only BA of one SE3 vertex over unary reprojection edges:
    4 rounds with chi2 = 5.991 re-classification between rounds and the
    Huber kernel in rounds 0-1."""
    if _build.is_cuda(pts):
        q, t, inlier, n = cuda_pose.pose_optimization_batched(
            q0[None].contiguous(), t0[None].contiguous(),
            cam_params[None].contiguous(), kind, pts[None].contiguous(),
            uv[None].contiguous(), w[None].contiguous(),
            valid[None].contiguous(), rounds=rounds, iters=iters)
        return PoseOptResult(q=q[0], t=t[0], inlier=inlier[0],
                             n_inliers=n[0])
    return PoseOptResult(*cuda_pose.pose_optimization_plain(
        q0, t0, cam_params, kind, pts, uv, w, valid, rounds=rounds,
        iters=iters))
