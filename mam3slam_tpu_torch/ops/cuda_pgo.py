"""PGO kernels: the essential graph's 7DoF LM iterations without a host
round trip.

Wrapper of ``csrc/pgo.cu`` (replaces no Pallas kernel: the reference
leaves this PGO to XLA, ``mam3slam_tpu/solvers/pgo.py``).  The plain
PyTorch version and the entry point are
``solvers/pgo.py:optimize_essential_graph_plain`` and
``optimize_essential_graph``, which launches ``essential_graph`` here for
CUDA tensors.  An iteration is ``pgo_linearize`` (per-edge residuals,
jacobians and their normal-equation rows in ``_assemble``'s order), two
fixed-order segment sums (``ops/segsum.py``), ``pgo_damp`` (the dense
[7K, 7K] system with its damped diagonal blocks, and -g), the Cholesky
solve, and ``pgo_update`` (retraction, the candidate's cost, the
accept-if-lower rule and the damping schedule, all on the card); one
``pgo_update`` before the loop stores the starting cost.
"""

from __future__ import annotations

import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.ops import segsum


def essential_graph(q_kw, t_kw, s_kw, fixed, ei, ej, mq, mt, ms, w, plans,
                    iters: int, lam0: float):
    """``iters`` LM iterations over Sim3 vertices (q, t, s) [K] with
    ``fixed`` [K] bool, edges (ei, ej) [E] measuring (mq, mt, ms) with
    weights ``w`` [E] (0 on invalid edges) and the plans of
    ``solvers/pgo.py:_block_plans``.  Launches 1 + 3 ``iters`` kernels of
    its own beside ``2 iters`` segment sums, whatever E is.  Returns the
    corrected (q, t, s)."""
    K, E = q_kw.shape[0], ei.shape[0]
    f32, i32 = torch.float32, torch.int32
    for x, name, dtype, shape in (
            (q_kw, "q", f32, (K, 4)), (t_kw, "t", f32, (K, 3)),
            (s_kw, "s", f32, (K,)), (fixed, "fixed", torch.bool, (K,)),
            (ei, "ei", i32, (E,)), (ej, "ej", i32, (E,)),
            (mq, "mq", f32, (E, 4)), (mt, "mt", f32, (E, 3)),
            (ms, "ms", f32, (E,)), (w, "w", f32, (E,))):
        _build.check(x, name, dtype, shape)
    dev = q_kw.device
    q, t, s = q_kw.clone(), t_kw.clone(), s_kw.clone()
    cq, ct, cs = torch.empty_like(q), torch.empty_like(t), torch.empty_like(s)
    fixed_u8 = fixed.to(torch.uint8)
    lam = torch.full((), lam0, dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    hrows = torch.empty((4 * E, 7, 7), dtype=f32, device=dev)
    grows = torch.empty((2 * E, 7), dtype=f32, device=dev)
    A = torch.empty((7 * K, 7 * K), dtype=f32, device=dev)
    rhs = torch.empty((7 * K, 1), dtype=f32, device=dev)
    edge_ptrs = (ei.data_ptr(), ej.data_ptr())
    meas_ptrs = (mq.data_ptr(), mt.data_ptr(), ms.data_ptr(), w.data_ptr())
    state_ptrs = (q.data_ptr(), t.data_ptr(), s.data_ptr(), cq.data_ptr(),
                  ct.data_ptr(), cs.data_ptr(), lam.data_ptr(),
                  cost.data_ptr())

    def update(dx, info, init: int):
        _build.launch("mam3_pgo_update", K, E, init, dx, info,
                      fixed_u8.data_ptr(), *edge_ptrs, *meas_ptrs,
                      *state_ptrs)

    update(None, None, 1)
    for _ in range(iters):
        _build.launch("mam3_pgo_linearize", E, *edge_ptrs, q.data_ptr(),
                      t.data_ptr(), s.data_ptr(), fixed_u8.data_ptr(),
                      *meas_ptrs, hrows.data_ptr(), grows.data_ptr())
        H = segsum.segment_sum(plans[0], hrows)
        g = segsum.segment_sum(plans[1], grows)
        _build.launch("mam3_pgo_damp", K, H.data_ptr(), g.data_ptr(),
                      fixed_u8.data_ptr(), lam.data_ptr(), A.data_ptr(),
                      rhs.data_ptr())
        L, info = torch.linalg.cholesky_ex(A)
        dx = torch.cholesky_solve(rhs, L).contiguous()
        update(dx.data_ptr(), info.data_ptr(), 0)
    return q, t, s
