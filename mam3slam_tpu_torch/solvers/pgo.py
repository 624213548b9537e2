"""Sim3 pose-graph optimisation over the essential graph.

Port of the Sim3 path of ``mam3slam_tpu.solvers.pgo`` (the reference's
Optimizer::OptimizeEssentialGraph): keyframe poses are Sim3 vertices,
edges carry relative Sim3 measurements, the residual of edge (i, j) is
``log(m * S_i * S_j^-1)``.  Each LM step takes the per-edge 7x7 tangent
jacobians by forward mode, assembles the dense [7K, 7K] normal system with
fixed-order segment sums (``ops/segsum.py``; one keyframe pair may carry
several edges) and solves it by Cholesky; a step is kept only when it
lowers the cost.  On the card ``optimize_essential_graph`` runs these
iterations in the kernels of ``ops/cuda_pgo.py`` (``csrc/pgo.cu``) around
the same segment sums and Cholesky; on the CPU it runs
``optimize_essential_graph_plain``.

``optimize_essential_graph_4dof`` is the inertial variant
(OptimizeEssentialGraph4DoF): for a map whose roll and pitch gravity
observes, only the yaw about the gravity axis and the translation of each
keyframe move, the scale held at 1, with the same LM machinery on a dense
[4K, 4K] system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import cuda_pgo, segsum
from mam3slam_tpu_torch.utils import autodiff


class PGOEdges(NamedTuple):
    """Relative Sim3 measurements m on edges (i, j), consistent when
    S_j = m * S_i."""

    i: torch.Tensor       # [E] i32
    j: torch.Tensor       # [E] i32
    q: torch.Tensor       # [E, 4]
    t: torch.Tensor       # [E, 3]
    s: torch.Tensor       # [E]
    w: torch.Tensor       # [E] information weight
    valid: torch.Tensor   # [E] bool


def edge_residual(q_i, t_i, s_i, q_j, t_j, s_j, q_m, t_m, s_m):
    """log(S_m * S_i * S_j^-1) in R^7, batched."""
    err = lie.sim3_compose(
        lie.Sim3(q_m, t_m, s_m),
        lie.sim3_compose(lie.Sim3(q_i, t_i, s_i),
                         lie.sim3_inverse(lie.Sim3(q_j, t_j, s_j))))
    return lie.sim3_log(err)


def batched_jacfwd(f, x: torch.Tensor):
    """(f(x), per-row jacobians [B, out, n]) of a row-wise function f(x
    [B, n]) -> [B, out]: every row gets the same perturbation, and since
    row b depends only on x[b], the jacobian of the shared perturbation
    is each row's own."""
    def g(d):
        y = f(x + d)
        return y, y

    J, y = autodiff.jacfwd(g, torch.zeros(x.shape[-1], dtype=x.dtype,
                                          device=x.device), has_aux=True)
    return y, J


def _block_plans(ei, ej, K: int):
    """The plans of the normal system's assembly, built once per solve:
    each edge's four blocks (i, i), (j, j), (i, j), (j, i) keyed on row K
    + column of the dense [K, K] block grid (one keyframe pair may carry
    several edges), and its two gradient blocks on i and j."""
    return (segsum.segment_plan(torch.cat([ei * K + ei, ej * K + ej,
                                           ei * K + ej, ej * K + ei]), K * K),
            segsum.segment_plan(torch.cat([ei, ej]), K))


def _assemble(plans, Ji, Jj, r, w, K: int):
    """H [K, K, d, d] and g [K, d] of the weighted edges (jacobians Ji, Jj
    [E, n, d], residuals r [E, n]), summed in a fixed order."""
    d = Ji.shape[-1]
    Hij = torch.einsum("eki,ekj,e->eij", Ji, Jj, w)
    H = segsum.segment_sum(plans[0], torch.cat([
        torch.einsum("eki,ekj,e->eij", Ji, Ji, w),
        torch.einsum("eki,ekj,e->eij", Jj, Jj, w),
        Hij, Hij.transpose(-1, -2)])).reshape(K, K, d, d)
    g = segsum.segment_sum(plans[1], torch.cat([
        torch.einsum("eki,ek,e->ei", Ji, r, w),
        torch.einsum("eki,ek,e->ei", Jj, r, w)]))
    return H, g


def optimize_essential_graph(q_kw, t_kw, s_kw, fixed, edges: PGOEdges,
                             iters: int = 20, lam0: float = 1e-4):
    """Damped Gauss-Newton (LM with accept/reject) over Sim3 vertices
    (q, t, s) [K] world -> keyframe; ``fixed`` [K] bool.  Returns the
    corrected (q, t, s).  CUDA tensors launch ``csrc/pgo.cu``
    (``ops/cuda_pgo.py``); CPU tensors run the plain version."""
    if not _build.is_cuda(q_kw, t_kw, s_kw, fixed, *edges):
        return optimize_essential_graph_plain(q_kw, t_kw, s_kw, fixed, edges,
                                              iters, lam0)
    K = q_kw.shape[0]
    ei, ej = edges.i.int(), edges.j.int()
    return cuda_pgo.essential_graph(
        q_kw.contiguous(), t_kw.contiguous(), s_kw.contiguous(), fixed, ei,
        ej, edges.q.contiguous(), edges.t.contiguous(),
        edges.s.contiguous(), torch.where(edges.valid, edges.w, 0.0),
        _block_plans(ei.long(), ej.long(), K), iters, lam0)


def optimize_essential_graph_plain(q_kw, t_kw, s_kw, fixed, edges: PGOEdges,
                                   iters: int = 20, lam0: float = 1e-4):
    """Plain PyTorch ``optimize_essential_graph``: the per-edge jacobians
    by ``torch.func.jacfwd`` (``batched_jacfwd``)."""
    _build.count_plain("pgo")
    K = q_kw.shape[0]
    dev, dt = q_kw.device, q_kw.dtype
    ei, ej = edges.i.long(), edges.j.long()
    w = torch.where(edges.valid, edges.w, 0.0)
    meas = (edges.q, edges.t, edges.s)

    def cost_of(q, t, s):
        r = edge_residual(q[ei], t[ei], s[ei], q[ej], t[ej], s[ej], *meas)
        return (w * (r * r).sum(-1)).sum()

    def perturbed(xi, q, t, s):
        S = lie.sim3_compose(lie.sim3_exp(xi), lie.Sim3(q, t, s))
        return S.q, S.t, S.s

    eye7 = torch.eye(7, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    plans = _block_plans(ei, ej, K)
    q, t, s = q_kw, t_kw, s_kw
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    cost = cost_of(q, t, s)
    for _ in range(iters):
        Si = (q[ei], t[ei], s[ei])
        Sj = (q[ej], t[ej], s[ej])
        r, J = batched_jacfwd(lambda x: edge_residual(
            *perturbed(x[:, :7], *Si), *perturbed(x[:, 7:], *Sj), *meas),
            torch.zeros(ei.shape[0], 14, dtype=dt, device=dev))
        Ji, Jj = J[..., :7], J[..., 7:]
        Ji = Ji * (~fixed[ei])[:, None, None]
        Jj = Jj * (~fixed[ej])[:, None, None]

        H, g = _assemble(plans, Ji, Jj, r, w, K)

        # fixed vertices get identity rows; LM damping on the diagonal
        Hd = H[diag, diag]
        damp = lam * torch.clamp(torch.diagonal(Hd, dim1=-2, dim2=-1),
                                 min=1e-6) + 1e-8
        H[diag, diag] = (Hd + torch.where(fixed[:, None, None], eye7, 0.0)
                         + damp[..., None] * eye7)
        L, info = torch.linalg.cholesky_ex(
            H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K))
        dx = torch.cholesky_solve(-g.reshape(7 * K, 1), L).reshape(K, 7)
        dx = torch.where((info == 0) & torch.isfinite(dx).all(), dx, 0.0)
        dx = torch.where(fixed[:, None], 0.0, dx)

        nq, nt, ns = perturbed(dx, q, t, s)
        nq = lie.quat_normalize(nq)
        new_cost = cost_of(nq, nt, ns)
        accept = new_cost < cost
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e5))
        q = torch.where(accept, nq, q)
        t = torch.where(accept, nt, t)
        s = torch.where(accept, ns, s)
        cost = torch.where(accept, new_cost, cost)
    return q, t, s


def optimize_essential_graph_4dof(q_kw, t_kw, fixed, edges: PGOEdges,
                                  iters: int = 20, lam0: float = 1e-4,
                                  gravity_axis=None):
    """Damped Gauss-Newton over yaw + translation vertices (the
    reference's VertexPose4DoF / Edge4DoF): each step right-composes a
    world-frame perturbation T_cw o [Rot(axis, dyaw) | dt], the full SE3
    edge residual is evaluated (roll / pitch discrepancies cost but cannot
    be absorbed), scale stays 1.  ``gravity_axis`` defaults to world z.
    Returns the corrected (q, t)."""
    K = q_kw.shape[0]
    dev, dt = q_kw.device, q_kw.dtype
    axis = torch.as_tensor([0.0, 0.0, 1.0] if gravity_axis is None
                           else gravity_axis, dtype=dt, device=dev)
    axis = axis / torch.clamp(torch.linalg.norm(axis), min=1e-9)
    ei, ej = edges.i.long(), edges.j.long()
    w = torch.where(edges.valid, edges.w, 0.0)
    meas = (edges.q, edges.t, edges.s)
    one = torch.ones(ei.shape[0], dtype=dt, device=dev)

    def residual(qi, ti, qj, tj):
        return edge_residual(qi, ti, one, qj, tj, one, *meas)

    def cost_of(q, t):
        r = residual(q[ei], t[ei], q[ej], t[ej])
        return (w * (r * r).sum(-1)).sum()

    def perturb(xi, qq, tt):
        half = 0.5 * xi[..., :1]
        dq = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
        return lie.quat_mul(qq, dq), tt + lie.quat_rotate(qq, xi[..., 1:4])

    eye4 = torch.eye(4, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    plans = _block_plans(ei, ej, K)
    q, t = q_kw, t_kw
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    cost = cost_of(q, t)
    for _ in range(iters):
        qi, ti, qj, tj = q[ei], t[ei], q[ej], t[ej]
        r, J = batched_jacfwd(lambda x: residual(
            *perturb(x[:, :4], qi, ti), *perturb(x[:, 4:], qj, tj)),
            torch.zeros(ei.shape[0], 8, dtype=dt, device=dev))
        Ji = J[..., :4] * (~fixed[ei])[:, None, None]
        Jj = J[..., 4:] * (~fixed[ej])[:, None, None]

        H, g = _assemble(plans, Ji, Jj, r, w, K)

        Hd = H[diag, diag]
        damp = lam * torch.clamp(torch.diagonal(Hd, dim1=-2, dim2=-1),
                                 min=1e-6) + 1e-8
        H[diag, diag] = (Hd + torch.where(fixed[:, None, None], eye4, 0.0)
                         + damp[..., None] * eye4)
        L, info = torch.linalg.cholesky_ex(
            H.permute(0, 2, 1, 3).reshape(4 * K, 4 * K))
        dx = torch.cholesky_solve(-g.reshape(4 * K, 1), L).reshape(K, 4)
        dx = torch.where((info == 0) & torch.isfinite(dx).all(), dx, 0.0)
        dx = torch.where(fixed[:, None], 0.0, dx)

        nq, nt = perturb(dx, q, t)
        nq = lie.quat_normalize(nq)
        new_cost = cost_of(nq, nt)
        accept = new_cost < cost
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e5))
        q = torch.where(accept, nq, q)
        t = torch.where(accept, nt, t)
        cost = torch.where(accept, new_cost, cost)
    return q, t


def correct_points_by_ref(mp_pos, mp_ref_kf, mp_mask, q_old, t_old, s_old,
                          q_new, t_new, s_new):
    """Map points moved with their reference keyframe's Sim3 correction:
    X' = S_new^-1(S_old(X)) for the masked points."""
    ref = torch.clamp(mp_ref_kf, min=0).long()
    S_old = lie.Sim3(q_old[ref], t_old[ref], s_old[ref])
    S_new_inv = lie.sim3_inverse(lie.Sim3(q_new[ref], t_new[ref],
                                          s_new[ref]))
    moved = lie.sim3_apply(S_new_inv, lie.sim3_apply(S_old, mp_pos))
    return torch.where(mp_mask[:, None], moved, mp_pos)
