"""The essential-graph PGOs' paths on the CPU, and the PGO kernels'
algebra built for the host.

``optimize_essential_graph`` launches ``csrc/pgo.cu`` for CUDA tensors
(held to its plain version in ``test_torch_cuda.py``); CPU tensors take
``optimize_essential_graph_plain``, counted by ``_build.count_plain``.
The plain version is the 7DoF body as it stood before the kernels, kept
here frozen (``_frozen_7dof``), and must give its bits; the inertial
``optimize_essential_graph_4dof`` keeps its ``jacfwd`` path, held to its
own frozen body.  The problems are ``chip_smoke.pgo_problem``'s (the
loop correction's and the merge's) at a small arena.  The kernels' Sim(3)
algebra (``csrc/pgo_lie.cuh``) is plain C++ besides its qualifiers: built
here with g++, its dual-number jacobians and its retraction are held to
``torch.func.jacfwd`` through ``geometry/lie.py`` and to the plain
retraction.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import cuda_pgo
from mam3slam_tpu_torch.solvers import pgo as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
K_SMALL = 80   # slots: the problems' keyframes lie in the first n + 20


def _frozen_7dof(q_kw, t_kw, s_kw, fixed, edges, iters=20, lam0=1e-4):
    K = q_kw.shape[0]
    dev, dt = q_kw.device, q_kw.dtype
    ei, ej = edges.i.long(), edges.j.long()
    w = torch.where(edges.valid, edges.w, 0.0)
    meas = (edges.q, edges.t, edges.s)

    def cost_of(q, t, s):
        r = P.edge_residual(q[ei], t[ei], s[ei], q[ej], t[ej], s[ej], *meas)
        return (w * (r * r).sum(-1)).sum()

    def perturbed(xi, q, t, s):
        S = lie.sim3_compose(lie.sim3_exp(xi), lie.Sim3(q, t, s))
        return S.q, S.t, S.s

    eye7 = torch.eye(7, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    plans = P._block_plans(ei, ej, K)
    q, t, s = q_kw, t_kw, s_kw
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    cost = cost_of(q, t, s)
    for _ in range(iters):
        Si = (q[ei], t[ei], s[ei])
        Sj = (q[ej], t[ej], s[ej])
        r, J = P.batched_jacfwd(lambda x: P.edge_residual(
            *perturbed(x[:, :7], *Si), *perturbed(x[:, 7:], *Sj), *meas),
            torch.zeros(ei.shape[0], 14, dtype=dt, device=dev))
        Ji, Jj = J[..., :7], J[..., 7:]
        Ji = Ji * (~fixed[ei])[:, None, None]
        Jj = Jj * (~fixed[ej])[:, None, None]

        H, g = P._assemble(plans, Ji, Jj, r, w, K)

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


def _frozen_4dof(q_kw, t_kw, fixed, edges, iters=20, lam0=1e-4,
                 gravity_axis=None):
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
        return P.edge_residual(qi, ti, one, qj, tj, one, *meas)

    def cost_of(q, t):
        r = residual(q[ei], t[ei], q[ej], t[ej])
        return (w * (r * r).sum(-1)).sum()

    def perturb(xi, qq, tt):
        half = 0.5 * xi[..., :1]
        dq = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
        return lie.quat_mul(qq, dq), tt + lie.quat_rotate(qq, xi[..., 1:4])

    eye4 = torch.eye(4, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    plans = P._block_plans(ei, ej, K)
    q, t = q_kw, t_kw
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    cost = cost_of(q, t)
    for _ in range(iters):
        qi, ti, qj, tj = q[ei], t[ei], q[ej], t[ej]
        r, J = P.batched_jacfwd(lambda x: residual(
            *perturb(x[:, :4], qi, ti), *perturb(x[:, 4:], qj, tj)),
            torch.zeros(ei.shape[0], 8, dtype=dt, device=dev))
        Ji = J[..., :4] * (~fixed[ei])[:, None, None]
        Jj = J[..., 4:] * (~fixed[ej])[:, None, None]

        H, g = P._assemble(plans, Ji, Jj, r, w, K)

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


def _problem(kind, invalid=False):
    q, t, s, fixed, edges = chip_smoke.pgo_problem(CPU, kind, seed=7,
                                                   K=K_SMALL)
    if invalid:   # one covisibility edge left out by its valid flag
        valid = edges.valid.clone()
        valid[1] = False
        edges = edges._replace(valid=valid)
    return q, t, s, fixed, edges


def _bit_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _no_kernel_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(cuda_pgo, "essential_graph", refuse)


@pytest.mark.parametrize("kind", ["loop", "merge"])
def test_cpu_tensors_take_the_plain_version(kind, monkeypatch):
    _no_kernel_path(monkeypatch)
    q, t, s, fixed, edges = _problem(kind)
    launches = dict(_build.LAUNCHES)
    plain = _build.PLAIN_CALLS["pgo"]
    got = P.optimize_essential_graph(q, t, s, fixed, edges, iters=3)
    assert _build.PLAIN_CALLS["pgo"] == plain + 1
    assert dict(_build.LAUNCHES) == launches
    assert _bit_equal(got, P.optimize_essential_graph_plain(
        q, t, s, fixed, edges, iters=3))


@pytest.mark.parametrize("kind,iters,invalid", [
    ("loop", 12, False), ("merge", 10, False), ("loop", 20, True)])
def test_plain_version_is_the_previous_body_bit_for_bit(kind, iters,
                                                        invalid):
    q, t, s, fixed, edges = _problem(kind, invalid)
    got = P.optimize_essential_graph(q, t, s, fixed, edges, iters=iters)
    want = _frozen_7dof(q, t, s, fixed, edges, iters=iters)
    assert _bit_equal(got, want)
    moved = chip_smoke.pgo_errors(got, (q, t, s))
    assert moved["angle"] > 1e-3 and moved["t_rel"] > 1e-3, moved


@pytest.mark.parametrize("axis", [None, (0.2, -1.0, 0.1)],
                         ids=["z", "tilted"])
def test_4dof_keeps_its_jacfwd_path(axis, monkeypatch):
    """The inertial PGO takes ``batched_jacfwd`` once an iteration, no
    kernel and no count of the 7DoF plain version, and gives the bits of
    its body as it stood."""
    _no_kernel_path(monkeypatch)
    q, t, _, fixed, edges = _problem("loop")
    calls = []
    inner = P.batched_jacfwd

    def spy(f, x):
        calls.append(x.shape)
        return inner(f, x)

    monkeypatch.setattr(P, "batched_jacfwd", spy)
    plain = _build.PLAIN_CALLS["pgo"]
    got = P.optimize_essential_graph_4dof(q, t, fixed, edges, iters=6,
                                          gravity_axis=axis)
    assert _build.PLAIN_CALLS["pgo"] == plain
    assert calls == [torch.Size([edges.i.shape[0], 8])] * 6
    want = _frozen_4dof(q, t, fixed, edges, iters=6, gravity_axis=axis)
    assert _bit_equal(got, want)


def test_card_problems_have_the_callers_shapes():
    """``chip_smoke.pgo_problem``, which the card tests and phase 15 use:
    at the arena's 512 slots, the loop correction's 45 keyframes with
    100-300 edges and one weight-5 loop edge, every unused slot and the
    loop's target fixed; the merge's target map and welded window fixed
    and 17 keyframes free, every vertex at s = 1."""
    q, t, s, fixed, edges = chip_smoke.pgo_problem(CPU, "loop", seed=1)
    E = edges.i.shape[0]
    assert q.shape[0] == chip_smoke.PGO_K == 512
    assert 100 <= E <= 300
    assert int((edges.w == 5.0).sum()) == 1
    assert int((~fixed).sum()) == 44
    assert bool(fixed[edges.i[-1]]) and not bool(fixed[edges.j[-1]])
    assert float((s - 1).abs().max()) > 1e-3
    q, t, s, fixed, edges = chip_smoke.pgo_problem(CPU, "merge", seed=1)
    assert 100 <= edges.i.shape[0] <= 300
    assert int((~fixed).sum()) == 17
    assert bool((s == 1).all())


HOST_HARNESS = r"""
#include "pgo_lie.cuh"
using namespace pgo;
template <typename T>
Sim3<T> at(const float* q, const float* t, const float* s, int k) {
  Sim3<T> o;
  for (int c = 0; c < 4; ++c) o.q[c] = lit<T>(q[4 * k + c]);
  for (int c = 0; c < 3; ++c) o.t[c] = lit<T>(t[3 * k + c]);
  o.s = lit<T>(s[k]);
  return o;
}
// r [E, 7] and J [E, 7, 14] of log(m exp(xi_i) S_i (exp(xi_j) S_j)^-1)
// at xi = 0, one dual evaluation a tangent direction, as a lane does
extern "C" void linearize(int E, const int* ei, const int* ej,
                          const float* q, const float* t, const float* s,
                          const float* mq, const float* mt, const float* ms,
                          float* r, float* J) {
  for (int e = 0; e < E; ++e)
    for (int k = 0; k < 14; ++k) {
      Dual xi_i[7], xi_j[7], res[7];
      for (int c = 0; c < 7; ++c) {
        xi_i[c] = {0.f, k == c ? 1.f : 0.f};
        xi_j[c] = {0.f, k == 7 + c ? 1.f : 0.f};
      }
      edge_residual(perturbed(xi_i, at<Dual>(q, t, s, ei[e])),
                    perturbed(xi_j, at<Dual>(q, t, s, ej[e])),
                    at<Dual>(mq, mt, ms, e), res);
      for (int c = 0; c < 7; ++c) {
        r[7 * e + c] = res[c].v;
        J[(7 * e + c) * 14 + k] = res[c].d;
      }
    }
}
// normalize(exp(dx) S) of every vertex, as pgo_update retracts
extern "C" void retract(int K, const float* dx, const float* q,
                        const float* t, const float* s, float* oq,
                        float* ot, float* os) {
  for (int v = 0; v < K; ++v) {
    Sim3<float> n = perturbed(dx + 7 * v, at<float>(q, t, s, v));
    quat_normalize(n.q);
    for (int c = 0; c < 4; ++c) oq[4 * v + c] = n.q[c];
    for (int c = 0; c < 3; ++c) ot[3 * v + c] = n.t[c];
    os[v] = n.s;
  }
}
"""


def _host_algebra(tmp_path):
    src = tmp_path / "harness.cc"
    src.write_text(HOST_HARNESS)
    lib = tmp_path / "libharness.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-I", os.path.join(os.path.dirname(_build.CSRC_DIR),
                                       "csrc"),
                    str(src), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _rows(x):
    return np.ascontiguousarray(x.numpy(), dtype=np.float32)


def test_kernel_algebra_matches_jacfwd_on_the_host(tmp_path):
    """Random Sim3 vertices and measurements (a third exact, the rest
    noisy, five with rotations of ~1 rad): the dual-number residuals
    within 1e-5 of their scale and jacobians within 1e-4 of each edge's
    largest entry of ``torch.func.jacfwd``'s in float32 (both round in
    float32, in other orders; float64 puts each within 3e-5 of the
    truth); the retraction within 1e-6."""
    lib = _host_algebra(tmp_path)
    rng = np.random.default_rng(4)
    K, E = 30, 200

    def tangent(n, t_sd, r_sd, s_sd):
        return torch.tensor(np.concatenate([
            rng.normal(0, t_sd, (n, 3)), rng.normal(0, r_sd, (n, 3)),
            rng.normal(0, s_sd, (n, 1))], 1), dtype=torch.float32)

    S = lie.sim3_exp(tangent(K, 2.0, 0.5, 0.3))
    ei = rng.integers(0, K, E)
    ej = (ei + rng.integers(1, K, E)) % K
    ei_t, ej_t = torch.tensor(ei), torch.tensor(ej)
    Si = lie.Sim3(S.q[ei_t], S.t[ei_t], S.s[ei_t])
    Sj = lie.Sim3(S.q[ej_t], S.t[ej_t], S.s[ej_t])
    xi_n = tangent(E, 0.05, 0.02, 0.02) * torch.tensor(
        np.arange(E) % 3 != 0, dtype=torch.float32)[:, None]
    xi_n[5:10] *= 50
    m = lie.sim3_compose(lie.sim3_exp(xi_n),
                         lie.sim3_compose(Sj, lie.sim3_inverse(Si)))

    def perturbed(xi, q, t, s):
        P2 = lie.sim3_compose(lie.sim3_exp(xi), lie.Sim3(q, t, s))
        return P2.q, P2.t, P2.s

    r_ref, J_ref = P.batched_jacfwd(lambda x: P.edge_residual(
        *perturbed(x[:, :7], *Si), *perturbed(x[:, 7:], *Sj), *m),
        torch.zeros(E, 14))
    q, t, s = _rows(S.q), _rows(S.t), _rows(S.s)
    mq, mt, ms = _rows(m.q), _rows(m.t), _rows(m.s)
    i32 = [np.ascontiguousarray(x, dtype=np.int32) for x in (ei, ej)]
    r = np.zeros((E, 7), np.float32)
    J = np.zeros((E, 7, 14), np.float32)
    lib.linearize(E, *map(_ptr, (*i32, q, t, s, mq, mt, ms, r, J)))
    r_ref, J_ref = r_ref.numpy(), J_ref.numpy()
    assert np.abs(r - r_ref).max() < 1e-5 * np.abs(r_ref).max()
    scale = np.abs(J_ref).max(axis=(1, 2))
    assert (np.abs(J - J_ref).max(axis=(1, 2)) < 1e-4 * scale).all()

    dx = _rows(tangent(K, 0.05, 0.05, 0.05))
    dx[:3] = 0.0
    out = [np.zeros_like(x) for x in (q, t, s)]
    lib.retract(K, *map(_ptr, (dx, q, t, s, *out)))
    nq, nt, ns = perturbed(torch.from_numpy(dx), S.q, S.t, S.s)
    for got, want in zip(out, (lie.quat_normalize(nq), nt, ns)):
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
