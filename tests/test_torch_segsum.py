"""Fixed-order segment sums (``mam3slam_tpu_torch/ops/segsum.py``) on the
CPU: the plain version against a float64 numpy sum at each caller's
shape and against an independent replay of the kernel's order; a
property over any index vector; and a guard that runs the port's BA, VI
and PGO solvers with every floating-point scatter sum made to raise, so
none is left on their paths (on the card such sums use atomics, whose
order changes from run to run).  The kernel itself is held to the plain
version bit for bit in ``tests/test_torch_cuda.py``.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.ops import segsum as SS
from mam3slam_tpu_torch.solvers import ba as tba
from mam3slam_tpu_torch.solvers import ba_window as tbw
from mam3slam_tpu_torch.solvers import pgo as tpgo
from mam3slam_tpu_torch.solvers import vi as tvi
from test_ba import _build_problem, make_scene
from test_ba_window_dense import _toy_problem
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
from test_torch_sim3_pgo import _drifted_ring, _drifted_ring_4dof
from test_torch_vi import _port as _port_vi
from test_torch_vi import simulate

PIN = tcam.PINHOLE


def _np64_sum(idx, v, n_out):
    """The exact-ish reference: float64 sums and the sums of |v|."""
    out = np.zeros((n_out,) + v.shape[1:])
    mag = np.zeros_like(out)
    for i, k in enumerate(idx):
        if 0 <= k < n_out:
            out[k] += v[i]
            mag[k] += np.abs(v[i])
    return out, mag


def _window_case(rng, Kc=24, Pw=512, M=16):
    """The window BA's camera sums (``red``, 27 values an edge into Kc
    slots) and its (point, slot) sums (``Z``, 18 into Pw Kc), a third of
    the edges on fixed cameras (summed nowhere)."""
    slot = rng.integers(0, Kc, Pw * M)
    free = rng.random(Pw * M) > 0.3
    prow = np.repeat(np.arange(Pw), M)
    return {"window_red": (np.where(free, slot, -1), Kc, (27,)),
            "window_pair": (np.where(free, prow * Kc + slot, -1), Pw * Kc,
                            (6, 3))}


def _cases():
    rng = np.random.default_rng(5)
    cases = _window_case(rng)
    K, P, E = 10, 500, 3000
    cases["run_ba_cam"] = (rng.integers(0, K, E), K, (6, 6))
    cases["run_ba_pt"] = (rng.integers(0, P, E), P, (3, 3))
    Kp, Ep = 20, 60
    ei, ej = rng.integers(0, Kp, Ep), rng.integers(0, Kp, Ep)
    cases["pgo_H"] = (np.concatenate([ei * Kp + ei, ej * Kp + ej,
                                      ei * Kp + ej, ej * Kp + ei]), Kp * Kp,
                      (7, 7))
    cases["pgo_g"] = (np.concatenate([ei, ej]), Kp, (7,))
    cases["empty_segments"] = (rng.choice([3, 17, 40], 200), 50, (5,))
    cases["all_dropped"] = (rng.choice([-1, 9, 12], 100), 9, (4,))
    cases["no_rows"] = (np.zeros(0, np.int64), 7, (3,))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_segment_sum_matches_float64(name):
    """Every segment within one float32 rounding of the float64 sum (the
    sums are carried in float64 and rounded once: 2^-24 of the result,
    plus 1e-12 of the sum of its |values| for the float64 adds); rows no
    kept index names are exactly 0."""
    idx, n_out, tail = CASES[name]
    rng = np.random.default_rng(len(idx))
    v = (rng.normal(size=(len(idx),) + tail)
         * 10.0 ** rng.uniform(-2, 2, (len(idx),) + (1,) * len(tail))
         ).astype(np.float32)
    got = SS.segment_sum(SS.segment_plan(torch.tensor(idx), n_out),
                         torch.tensor(v)).numpy()
    ref, mag = _np64_sum(idx, v, n_out)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert (np.abs(got - ref) <= 2.0 ** -24 * np.abs(ref) + 1e-12 * mag
            ).all()
    empty = mag.reshape(n_out, -1).sum(1) == 0
    assert (got.reshape(n_out, -1)[empty] == 0).all()


def _kernel_order(idx, v, n_out):
    """The kernel's order replayed one add at a time: lane l of segment k
    adds the segment's rows l, l + 32, ... from 0, then the lanes fold
    x[:off] + x[off:2 off] for off = 16 .. 1, in float64, rounded once to
    v's dtype."""
    out = np.zeros((n_out,) + v.shape[1:], v.dtype)
    for k in range(n_out):
        rows = np.flatnonzero(idx == k)
        if len(rows) == 0:
            continue
        lanes = np.zeros((32,) + v.shape[1:], np.float64)
        for j, r in enumerate(rows):
            lanes[j % 32] = lanes[j % 32] + v[r].astype(np.float64)
        off = 16
        while off:
            lanes[:off] = lanes[:off] + lanes[off:2 * off]
            off //= 2
        out[k] = lanes[0].astype(v.dtype)
    return out


@pytest.mark.parametrize("E,n_out,C", [(1, 1, 1), (40, 3, 2), (700, 5, 3),
                                       (2000, 60, 4)])
def test_plain_segment_sum_follows_the_kernels_order(E, n_out, C):
    """Bit for bit the replay of the kernel's order, with segments of 1
    to several hundred rows (short ones fold from fewer lanes in the
    plain version) and magnitudes over six decades; -0.0 values sum to
    +0.0 as the kernel's do."""
    rng = np.random.default_rng(E)
    idx = rng.integers(-1, n_out + 1, E)
    idx[: E // 3] = 0
    v = (rng.normal(size=(E, C)) * 10.0 ** rng.uniform(-3, 3, (E, 1))
         ).astype(np.float32)
    v[::7] = -0.0
    got = SS.segment_sum(SS.segment_plan(torch.tensor(idx), n_out),
                         torch.tensor(v)).numpy()
    assert np.array_equal(got.view(np.int32),
                          _kernel_order(idx, v, n_out).view(np.int32))


def test_plain_segment_sum_float64_follows_the_kernels_order():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 4, 300)
    v = rng.normal(size=(300, 4)) * 10.0 ** rng.uniform(-8, 8, (300, 1))
    got = SS.segment_sum(SS.segment_plan(torch.tensor(idx), 4),
                         torch.tensor(v))
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy().view(np.int64),
                          _kernel_order(idx, v, 4).view(np.int64))


def test_segment_sum_barely_depends_on_the_row_order():
    """Carried in float64 and rounded once, a float32 segment sum is the
    correctly rounded sum of its rows almost always: shuffling the rows
    inside their segments leaves >= 99.9% of the outputs bit-equal and
    the rest one rounding apart (a sum in float32 would differ in most
    of them)."""
    rng = np.random.default_rng(11)
    E, n_out, C = 20000, 40, 27
    idx = rng.integers(0, n_out, E)
    v = (rng.normal(size=(E, C)) * 10.0 ** rng.uniform(-3, 3, (E, 1))
         ).astype(np.float32)
    order = rng.permutation(E)
    a = SS.segment_sum(SS.segment_plan(torch.tensor(idx), n_out),
                       torch.tensor(v)).numpy()
    b = SS.segment_sum(SS.segment_plan(torch.tensor(idx[order]), n_out),
                       torch.tensor(v[order])).numpy()
    assert (a == b).mean() >= 0.999
    assert (np.abs(a - b) <= 2.0 ** -23 * np.abs(a)).all()


@settings(max_examples=60, deadline=None)
@given(idx=st.lists(st.integers(-2, 9), max_size=160),
       seg=st.integers(0, 7), seed=st.integers(0, 2 ** 16))
def test_segment_unchanged_when_other_rows_move(idx, seg, seed):
    """For any index vector, a segment's sum is the same bits when the
    rows outside it are permuted (its own rows keep their places)."""
    idx = np.asarray(idx, np.int64)
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(len(idx), 3))
         * 10.0 ** rng.uniform(-3, 3, (len(idx), 1))).astype(np.float32)
    n_out = 8
    other = np.flatnonzero(idx != seg)
    order = np.arange(len(idx))
    order[other] = rng.permutation(other)
    a = SS.segment_sum(SS.segment_plan(torch.tensor(idx), n_out),
                       torch.tensor(v))
    b = SS.segment_sum(SS.segment_plan(torch.tensor(idx[order]), n_out),
                       torch.tensor(v[order]))
    assert torch.equal(a[seg], b[seg])


def test_plan_fields():
    """Segments in index order, each holding its rows in their order;
    dropped rows (index outside [0, n_out)) last and in no segment."""
    idx = torch.tensor([3, -1, 0, 3, 5, 0, 3, 7])
    p = SS.segment_plan(idx, 6)
    assert p.perm.tolist()[:6] == [2, 5, 0, 3, 6, 4]
    assert sorted(p.perm.tolist()[6:]) == [1, 7]
    assert p.start.tolist() == [0, 2, 5, 6, 6, 6]
    assert p.end.tolist() == [2, 5, 6, 6, 6, 6]
    assert p.key.tolist() == [0, 3, 5, -1, -1, -1]
    assert p.perm.dtype == torch.int32 and p.n_out == 6


# ---------------------------------------------------------------------------
# the guard: no floating-point scatter sum on the solvers' paths
# ---------------------------------------------------------------------------

class _NoFloatScatterSum(TorchDispatchMode):
    """Raise on an ATen scatter sum whose values are floating point."""

    SUMS = ("aten.index_add", "aten.scatter_add", "aten.index_put",
            "aten._index_put_impl", "aten.put", "aten.scatter_reduce",
            "aten.index_reduce", "aten.bincount", "aten._unsafe_index_put")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name.startswith(self.SUMS) and any(
                isinstance(a, torch.Tensor) and a.is_floating_point()
                for a in args):
            accumulate = (kwargs.get("accumulate", False)
                          or any(a is True for a in args[2:]))
            if (not name.startswith(("aten.index_put", "aten._index_put",
                                     "aten.put", "aten._unsafe"))
                    or accumulate):
                raise AssertionError(f"floating-point scatter sum {name}")
        return func(*args, **kwargs)


def _raising(name, method):
    def wrapper(self, *args, **kwargs):
        accumulate = kwargs.get("accumulate", len(args) > 2 and args[2])
        if self.is_floating_point() and (
                name not in ("index_put_", "index_put", "put_")
                or accumulate):
            raise AssertionError(f"floating-point {name}")
        return method(self, *args, **kwargs)
    return wrapper


@contextlib.contextmanager
def no_float_scatter_sums(monkeypatch):
    """``index_add_``, ``index_put_(accumulate=True)`` and
    ``scatter_add_`` (and their out-of-place forms) patched to raise on
    floating dtypes, and every ATen scatter sum refused below them."""
    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add",
                 "index_put_", "index_put", "put_"):
        monkeypatch.setattr(torch.Tensor, name,
                            _raising(name, getattr(torch.Tensor, name)))
    with _NoFloatScatterSum():
        yield
    monkeypatch.undo()


def test_guard_catches_a_float_index_add(monkeypatch):
    with no_float_scatter_sums(monkeypatch):
        with pytest.raises(AssertionError):
            torch.zeros(3).index_add_(0, torch.tensor([0, 0]),
                                      torch.ones(2))
        with pytest.raises(AssertionError):
            torch.zeros(3).index_put_((torch.tensor([1, 1]),),
                                      torch.ones(2), accumulate=True)
        with pytest.raises(AssertionError):
            torch.zeros(3).scatter_add_(0, torch.tensor([2, 2]),
                                        torch.ones(2))
        # integer sums and plain writes stay allowed
        torch.zeros(3, dtype=torch.int32).index_add_(
            0, torch.tensor([0, 0]), torch.ones(2, dtype=torch.int32))
        torch.zeros(3)[torch.tensor([1, 2])] = 1.0


def _window():
    jprob, *_ = _toy_problem(seed=0)
    return convert.window_problem_from_numpy(jax.tree.map(np.asarray, jprob),
                                             "cpu")


def _edge_problem():
    q, t, pts, oc, op, ouv = make_scene(n_cams=4, n_pts=120, noise_px=0.5,
                                        seed=1)
    jprob = _build_problem(q, t + 0.01, pts, oc, op, ouv,
                           np.array([False, True, True, True]),
                           np.ones(len(pts), bool))
    return convert.ba_problem_from_numpy(jax.tree.map(np.asarray, jprob),
                                         "cpu")


def _vi_problem():
    sim = simulate()
    n_kf = sim["n_kf"]
    cam_free = np.ones(n_kf, bool)
    cam_free[0] = False
    edges, calib = _port_vi(sim)
    f32 = dict(cam_q=sim["q"], cam_t=sim["t"] + 0.01, vel=sim["v"],
               bg=np.tile(sim["bg"], (n_kf, 1)),
               ba=np.tile(sim["ba"], (n_kf, 1)),
               cam_params=np.broadcast_to(np.asarray(sim["cam"].params),
                                          (n_kf, 8)),
               pts=sim["pts"], gravity=np.array([0.0, 0.0, -9.81]))
    prob = tvi.VIProblem(
        obs=convert.from_numpy(tba.Obs, sim["obs"], "cpu"), iedges=edges,
        cam_free=torch.from_numpy(cam_free),
        pt_free=torch.ones(len(sim["pts"]), dtype=torch.bool),
        **{k: torch.from_numpy(np.array(v, np.float32))
           for k, v in f32.items()})
    return prob, calib


def _pgo(four_dof: bool):
    if four_dof:
        (q, t), edges, _, ax = _drifted_ring_4dof(None, K=12)
        args = (torch.tensor(q), torch.tensor(t))
    else:
        (q, t, s), edges, _ = _drifted_ring(K=12)
        args = (torch.tensor(q), torch.tensor(t), torch.tensor(s))
    fixed = torch.zeros(len(q), dtype=torch.bool)
    fixed[0] = True
    e = convert.from_numpy(tpgo.PGOEdges, tpgo.PGOEdges(**edges),
                           device="cpu")
    if four_dof:
        return lambda: tpgo.optimize_essential_graph_4dof(*args, fixed, e,
                                                          iters=2)
    return lambda: tpgo.optimize_essential_graph(*args, fixed, e, iters=2)


SOLVERS = {
    "run_window_ba_dense": lambda: (lambda p: lambda: tbw.run_window_ba_dense(
        p, PIN, iters=2))(_window()),
    "run_window_ba": lambda: (lambda p: lambda: tbw.run_window_ba(
        p, PIN, iters=2, cg_iters=5))(_window()),
    "run_ba": lambda: (lambda p: lambda: tba.run_ba(
        p, PIN, iters=2, cg_iters=5))(_edge_problem()),
    "run_vi_ba": lambda: (lambda pc: lambda: tvi.run_vi_ba(
        pc[0], PIN, pc[1], iters=2, cg_iters=5))(_vi_problem()),
    "optimize_essential_graph": lambda: _pgo(False),
    "optimize_essential_graph_4dof": lambda: _pgo(True),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_no_float_scatter_sum_on_solver_path(name, monkeypatch):
    """The solver runs to a finite result with every floating-point
    scatter sum made to raise, and gives the same bits twice."""
    solve = SOLVERS[name]()
    with no_float_scatter_sums(monkeypatch):
        first = solve()
    second = solve()
    for a, b in zip(first, second):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
