"""Port parity of the stored loop and merge edges in the essential graph
(tests/test_loop_edges.py, whose file is ``slow``): both packages'
``LoopServer._essential_edges`` on one state built from a seed, with a
stored edge from an earlier closure present, give the same edges (pairs,
the relative Sim3 measured at the current estimates, the weights), on a
10-keyframe chain and at K = 512 with a banded covisibility; and
``correct_loop`` on that chain gives the same corrected poses, which the
stored edge moves.  No pixels: the states are written field by field.
The port's twin of the two-revolution closure on the ring world is
``slow``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu.slam import system as jsystem
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.geometry import lie as tlie
from mam3slam_tpu_torch.mapstate import state as TS
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import system as tsystem
from test_slam_e2e import CX, CY, FX, FY, H, N_FEAT, W, umeyama_align
from test_torch_server import _ang, _compare_after
from test_torch_server_e2e import (port_frame,  # noqa: F401
                                   torch_threads_per_worker)


def _pair(n_feat: int, max_kf: int, max_mp: int, server_cfg=None):
    """(port system, JAX system), each with a LoopServer, at one config."""
    kw = dict(width=W, height=H, n_feat=n_feat, max_kf=max_kf,
              max_mp=max_mp, n_levels=4)
    jsys_ = jsystem.SlamSystem(jsystem.SlamConfig(**kw),
                               jcam.make_pinhole(FX, FY, CX, CY))
    jsys_.server = jserver.LoopServer(
        jsys_, jserver.ServerConfig(**(server_cfg or {})))
    tsys_ = tsystem.SlamSystem(tsystem.SlamConfig(**kw),
                               tcam.make_pinhole(FX, FY, CX, CY,
                                                 device="cpu"))
    tsys_.server = tserver.LoopServer(
        tsys_, tserver.ServerConfig(**(server_cfg or {})))
    return tsys_, jsys_


def _install(tsys_, jsys_, fields: dict, loops=()):
    """Write ``fields`` (numpy) over the JAX system's empty state, give
    both systems that state, then store ``loops`` with each package's
    ``add_loop_edge``."""
    ms = convert.to_numpy(jsys_.ms)._replace(**fields)
    jms = JS.MapState(*(jnp.asarray(x) for x in ms))
    tms = convert.map_state_from_numpy(ms, device="cpu")
    for i, j in loops:
        jms = JS.add_loop_edge(jms, i, j)
        tms = TS.add_loop_edge(tms, i, j)
    jsys_.ms, tsys_.ms = jms, tms
    for f in ("loop_i", "loop_j", "loop_valid"):
        np.testing.assert_array_equal(getattr(tms, f).numpy(),
                                      np.asarray(getattr(jms, f)))


def _chain(max_kf: int, K: int, rng=None, rot: float = 0.0):
    """K keyframes of map 0 on a line 0.3 apart, each the parent of the
    next; with ``rng``, rotated by up to ``rot`` rad about random axes
    and moved by 1 cm noise."""
    q = np.tile(np.float32([1, 0, 0, 0]), (max_kf, 1))
    t = np.zeros((max_kf, 3), np.float32)
    t[:K, 0] = np.arange(K) * 0.3
    if rng is not None:
        axis = rng.normal(0, rot / 2, (K, 3))
        q[:K] = np.concatenate([np.ones((K, 1)), axis], 1)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t[:K] += rng.normal(0, 0.01, (K, 3))
    valid = np.arange(max_kf) < K
    parent = np.full(max_kf, -1, np.int32)
    parent[1:K] = np.arange(K - 1)
    return dict(kf_q=q.astype(np.float32), kf_t=t.astype(np.float32),
                kf_valid=valid, kf_seq=np.where(valid, np.arange(max_kf),
                                                TS.BIG_SEQ).astype(np.int32),
                kf_map=np.where(valid, 0, -1).astype(np.int32),
                kf_parent=parent)


def _sim3s(q, t, s):
    return (jlie.Sim3(jnp.asarray(q), jnp.asarray(t), jnp.asarray(s)),
            tlie.Sim3(torch.tensor(q), torch.tensor(t), torch.tensor(s)))


def _assert_edges_match(tsys_, jsys_, kf, target, q, t, s, in_map):
    """Both packages' essential edges for the loop (kf, target) with the
    hypothesis Sim3 (q, t, s): the same pairs in the same order, weights
    equal, q / t within 1e-5, s within 1e-6.  Returns the port's edges
    as numpy."""
    js, ts = _sim3s(q, t, s)
    je = jsys_.server._essential_edges(jsys_.ms, kf, target, js, in_map)
    te = tsys_.server._essential_edges(tsys_.ms, kf, target, ts, in_map)
    je = {f: np.asarray(getattr(je, f)) for f in je._fields}
    te = {f: getattr(te, f).numpy() for f in te._fields}
    for f in ("i", "j", "w", "valid"):
        np.testing.assert_array_equal(te[f], je[f], err_msg=f)
    for f, tol in (("q", 1e-5), ("t", 1e-5), ("s", 1e-6)):
        np.testing.assert_allclose(te[f], je[f], atol=tol, err_msg=f)
    return te


def test_stored_edge_enters_the_essential_graph():
    """tests/test_loop_edges.py:42 on both packages: the edge (2, 7)
    stored by an earlier closure is in the edge set of a later loop (0,
    9), measured at the current estimates, beside the spanning tree and
    the new loop edge of weight 5."""
    tsys_, jsys_ = _pair(N_FEAT, 16, 1024)
    K = 10
    _install(tsys_, jsys_, _chain(16, K), loops=[(2, 7)])
    in_map = np.arange(16) < K
    e = _assert_edges_match(tsys_, jsys_, 9, 0, np.float32([1, 0, 0, 0]),
                            np.float32([0.1, 0, 0]), np.float32(1.0),
                            in_map)
    pairs = list(zip(e["i"].tolist(), e["j"].tolist()))
    assert set(pairs) == ({(k - 1, k) for k in range(1, K)}
                          | {(2, 7), (0, 9)})
    k = pairs.index((2, 7))
    np.testing.assert_allclose(e["t"][k], [0.3 * 5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(e["s"][k], 1.0, atol=1e-6)
    assert e["w"][k] == 5.0 and e["w"][pairs.index((0, 9))] == 5.0
    assert (e["w"][:K - 1] == 1.0).all()


def test_stored_edge_of_this_loop_is_not_doubled():
    """A loop closed again between the same keyframes: its stored edge
    gives way to the new loop edge in both packages (``exclude_pair``),
    and a stored MERGE-style edge with an endpoint outside the map is
    left out."""
    tsys_, jsys_ = _pair(N_FEAT, 16, 1024)
    K = 10
    fields = _chain(16, K, np.random.default_rng(1), 0.2)
    fields["kf_valid"][12] = True
    fields["kf_map"][12] = 1
    _install(tsys_, jsys_, fields, loops=[(0, 9), (3, 12), (4, 8)])
    in_map = np.arange(16) < K
    q = fields["kf_q"][9]
    e = _assert_edges_match(tsys_, jsys_, 9, 0, q, fields["kf_t"][9],
                            np.float32(1.02), in_map)
    pairs = list(zip(e["i"].tolist(), e["j"].tolist()))
    assert pairs.count((0, 9)) == 1 and pairs[-1] == (0, 9)
    assert (3, 12) not in pairs and (4, 8) in pairs


def test_edge_assembly_at_k512_matches_reference():
    """tests/test_loop_edges.py:123 on both packages: a full 512-keyframe
    arena with a banded covisibility (5 strong neighbours a keyframe) and
    a stored edge (3, 400): the same edges, more than 2500 of them."""
    tsys_, jsys_ = _pair(64, 512, 512)
    K = 512
    rng = np.random.default_rng(0)
    covis = np.zeros((K, K), np.int32)
    for d in range(1, 6):
        idx = np.arange(K - d)
        covis[idx, idx + d] = 150
        covis[idx + d, idx] = 150
    fields = _chain(K, K, rng, 0.3)
    fields.update(kf_t=rng.normal(0, 1, (K, 3)).astype(np.float32),
                  covis=covis)
    _install(tsys_, jsys_, fields, loops=[(3, 400)])
    e = _assert_edges_match(tsys_, jsys_, 511, 0, fields["kf_q"][511],
                            fields["kf_t"][511], np.float32(1.0),
                            np.ones(K, bool))
    assert e["i"].shape[0] > 2500
    pairs = list(zip(e["i"].tolist(), e["j"].tolist()))
    assert (3, 400) in pairs and pairs[-1] == (0, 511)


def _loop_state(rng, K=10, max_kf=16, n_mp=40):
    """The 10-keyframe chain with drift, a covisibility band and points
    owned by its keyframes (reference keyframe, position in front)."""
    fields = _chain(max_kf, K, rng, 0.05)
    fields["kf_t"][:K] += np.cumsum(rng.normal(0, 0.01, (K, 3)), 0)
    covis = np.zeros((max_kf, max_kf), np.int32)
    for d in (1, 2):
        idx = np.arange(K - d)
        covis[idx, idx + d] = covis[idx + d, idx] = 120
    ref_kf = np.full(1024, -1, np.int32)
    ref_kf[:n_mp] = rng.integers(0, K, n_mp)
    pos = np.zeros((1024, 3), np.float32)
    pos[:n_mp] = rng.normal([1.5, 0, 4], [1.5, 1, 0.5], (n_mp, 3))
    fields.update(covis=covis, mp_valid=np.arange(1024) < n_mp,
                  mp_map=np.where(np.arange(1024) < n_mp, 0, -1).astype(
                      np.int32),
                  mp_ref_kf=ref_kf, mp_pos=pos)
    return fields


@pytest.fixture(scope="module")
def loop_state():
    return _loop_state(np.random.default_rng(3))


def _hypothesis(fields, kf, target):
    S = jlie.sim3_compose(
        jlie.sim3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.02, 0.005,
                                   0.03])),
        jlie.Sim3(jnp.asarray(fields["kf_q"][kf]),
                  jnp.asarray(fields["kf_t"][kf]), jnp.asarray(1.0)))
    return dict(target_kf=target, is_merge=False, n_coincidences=3,
                q=np.asarray(S.q), t=np.asarray(S.t), s=float(S.s),
                last_kf=kf)


@pytest.mark.parametrize("stored", [True, False])
def test_correct_loop_with_a_stored_edge_matches_reference(loop_state,
                                                           stored):
    """``correct_loop`` of the loop (9 -> 0) on the chain, with the edge
    (2, 7) of an earlier closure stored or not: the same corrected
    keyframe poses and points in both packages (1e-3 rad / 1e-3 x
    scale, test_torch_server_correct.py's tolerance), the same stored
    edges after it (the new one recorded), no global BA (capped off)."""
    cfg = dict(max_kf_for_gba=0)
    tsys_, jsys_ = _pair(N_FEAT, 16, 1024, cfg)
    _install(tsys_, jsys_, loop_state, loops=[(2, 7)] if stored else [])
    h = _hypothesis(loop_state, 9, 0)
    jsys_.server.correct_loop(0, 9, jserver.Hypothesis(**h))
    tsys_.server.correct_loop(0, 9, tserver.Hypothesis(**h))
    _compare_after(tsys_, jsys_)
    assert tsys_.server.events == jsys_.server.events == [
        "LOOP agent=0 kf=9 target=0 map=0"]
    assert tsys_.server.gba_runs == jsys_.server.gba_runs == []
    lv = tsys_.ms.loop_valid.numpy()
    got = set(zip(tsys_.ms.loop_i.numpy()[lv].tolist(),
                  tsys_.ms.loop_j.numpy()[lv].tolist()))
    assert got == ({(2, 7), (0, 9)} if stored else {(0, 9)})


def test_stored_edge_moves_the_correction(loop_state):
    """The stored edge is a constraint of the PGO: the port's corrected
    poses with it differ from those without it, and each agrees with
    the reference's (the parametrised test above)."""
    out = []
    for loops in ([(2, 7)], []):
        tsys_, jsys_ = _pair(N_FEAT, 16, 1024, dict(max_kf_for_gba=0))
        _install(tsys_, jsys_, loop_state, loops=loops)
        tsys_.server.correct_loop(0, 9, tserver.Hypothesis(
            **_hypothesis(loop_state, 9, 0)))
        out.append((tsys_.ms.kf_q.numpy()[:10], tsys_.ms.kf_t.numpy()[:10]))
    (q1, t1), (q0, t0) = out
    assert max(np.abs(t1 - t0).max(), _ang(q1, q0).max()) > 1e-3


@pytest.mark.slow
def test_double_loop_closure_stays_consistent():
    """tests/test_loop_edges.py:83 on the port: two revolutions of the
    ring world, at least two LOOPs, both stored, ATE < 0.4."""
    from test_server_loop import RingWorld, circle_tour

    world = RingWorld(seed=3)
    cfg = tsystem.SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=192,
                             max_mp=10240, n_levels=4, kf_max_interval=8,
                             min_init_matches=60)
    sys_ = tsystem.SlamSystem(cfg, tcam.make_pinhole(FX, FY, CX, CY,
                                                     device="cpu"))
    aid = sys_.add_agent()
    srv = tserver.LoopServer(sys_, tserver.ServerConfig(
        min_kfs_in_map=10, vocab_k=8, vocab_depth=3))
    sys_.server = srv
    poses = circle_tour(440, frac=2.12)
    for i, (R, t) in enumerate(poses):
        sys_.track(aid, port_frame(world, R, t), float(i))
    loops = [e for e in srv.events if e.startswith("LOOP")]
    assert len(loops) >= 2, srv.events
    assert int(sys_.ms.loop_valid.sum()) >= 2
    est, gt = [], []
    for ts, _, t_wc, st in sys_.trajectory_world(aid):
        if st != tsystem.OK:
            continue
        R, t = poses[int(ts)]
        est.append(t_wc)
        gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    ate = np.sqrt(((umeyama_align(est, gt) - gt) ** 2).sum(1).mean())
    assert ate < 0.4, ate
