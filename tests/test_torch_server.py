"""Port parity of the loop server's steps on one shared state.

The state: the port's SlamSystem with a LoopServer runs the two-agent
world of tests/test_server_merge.py until the server confirms its merge
hypothesis, and stops before the merge runs.  That map (two overlapping
maps), the agents, the vocabulary, the keyframe database and the
hypothesis are carried into a JAX SlamSystem + LoopServer through numpy.
Both packages then run the server's programs and ``merge_maps`` from that
state: integer outcomes must be identical, poses agree within 1e-3 rad /
1e-3 x scale.  The welding and global BA, detection and verification,
and ``correct_loop`` on the same state are in
test_torch_server_{ba,verify,correct}.py."""

import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.ops import bow as jbow
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu.slam import system as jsystem
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.slam import server as tserver
from test_slam_e2e import CX, CY, FX, FY, SyntheticWorld
from test_server_merge import arc_trajectory
from test_torch_mapping import _T, _np, assert_maps_match
from test_torch_server_e2e import (empty_frame, port_frame,  # noqa: F401
                                    port_system, torch_threads_per_worker)

SERVER_CFG = dict(min_kfs_in_map=4, vocab_k=8, vocab_depth=3)


class _Stop(Exception):
    pass


def _ang(qa, qb):
    d = np.abs((np.asarray(qa, np.float64)
                * np.asarray(qb, np.float64)).sum(-1))
    return 2 * np.arccos(np.minimum(d, 1.0))


def merge_snapshot():
    """The port's state at the merge trigger."""
    world = SyntheticWorld(n_mp=1200, seed=1)
    sys_ = port_system()
    a0, a1 = sys_.add_agent(), sys_.add_agent()
    srv = sys_.server
    out = {}

    def capture(agent_id, kf, h):
        out.update(ms=sys_.ms, agents=copy.deepcopy(sys_.agents),
                   agent_id=agent_id, kf=kf, h=copy.deepcopy(h),
                   words=srv.kf_bow_words.copy(), vals=srv.kf_bow_vals.copy())
        raise _Stop

    srv._trigger = capture
    try:
        for i, (R, t) in enumerate(arc_trajectory(50, start_x=0.0)):
            sys_.track(a0, port_frame(world, R, t), float(i))
        for i, (R, t) in enumerate(arc_trajectory(50, start_x=1.1)):
            sys_.track(a1, port_frame(world, R, t), float(100 + i))
    except _Stop:
        pass
    assert out, "no merge hypothesis confirmed"
    out.update(cfg=sys_.cfg, voc=srv.voc)
    return out


@pytest.fixture(scope="module")
def snap():
    return merge_snapshot()


def _pair(snap):
    """(port system, JAX system), each with a fresh server, at the
    snapshot."""
    tsys_ = port_system()
    tsys_.ms = snap["ms"]
    tsys_.agents = copy.deepcopy(snap["agents"])
    tsrv = tsys_.server
    tsrv.voc = snap["voc"]
    tsrv.kf_bow_words = snap["words"].copy()
    tsrv.kf_bow_vals = snap["vals"].copy()

    c = snap["cfg"]
    jcfg = jsystem.SlamConfig(**{f: getattr(c, f) for f in
                                 c.__dataclass_fields__})
    jsys_ = jsystem.SlamSystem(jcfg, jcam.make_pinhole(FX, FY, CX, CY))
    jsys_.ms = JS.MapState(*(jnp.asarray(x) for x in
                             convert.to_numpy(snap["ms"])))
    for a in snap["agents"]:
        ja = jsys_.agents[jsys_.add_agent()]
        ja.map_id, ja.state, ja.ref_kf = a.map_id, a.state, a.ref_kf
        ja.q, ja.t = jnp.asarray(a.q), jnp.asarray(a.t)
    jsrv = jserver.LoopServer(jsys_, jserver.ServerConfig(**SERVER_CFG))
    v = snap["voc"]
    jsrv.voc = jbow.Vocabulary(
        centroid_bits=tuple(jnp.asarray(x.numpy()) for x in v.centroid_bits),
        idf=jnp.asarray(v.idf.numpy()), k=v.k, depth=v.depth)
    jsrv.kf_bow_words = snap["words"].copy()
    jsrv.kf_bow_vals = snap["vals"].copy()
    jsys_.server = jsrv
    return tsys_, jsys_


def _assert_poses_match(got_ms, ref_ms, rtol=1e-3):
    kv = np.asarray(ref_ms.kf_valid)
    assert _ang(got_ms.kf_q.numpy()[kv], np.asarray(ref_ms.kf_q)[kv]).max() \
        < 1e-3
    assert_maps_match(got_ms, ref_ms, rtol=rtol, skip=("kf_q", "mp_normal"))
    np.testing.assert_allclose(got_ms.mp_normal.numpy(),
                               np.asarray(ref_ms.mp_normal), atol=1e-3)


def test_fuse_and_refresh_match_reference(snap):
    """The merge's seam fuse: the merging KF placed at the hypothesis'
    pose in the target map, the target's local points fused into it."""
    h, kf = snap["h"], snap["kf"]
    ms_np = convert.to_numpy(snap["ms"])     # shares the port's memory
    kf_q, kf_t = ms_np.kf_q.copy(), ms_np.kf_t.copy()
    kf_q[kf], kf_t[kf] = h.q, h.t / h.s
    ms_np = ms_np._replace(kf_q=kf_q, kf_t=kf_t)
    tsys_, jsys_ = _pair(snap)
    jms = JS.MapState(*(jnp.asarray(x) for x in ms_np))
    tms = convert.map_state_from_numpy(ms_np, device="cpu")
    mask = jsys_.fns["local_mp_mask"](jms, jnp.asarray(h.target_kf), 16)
    ref, n_ref = jsys_.fns["fuse_step"](jms, jnp.asarray(kf), mask)
    got, n_got = tsys_.fns["fuse_step"](tms, kf, _T(mask))
    assert int(n_got) == int(n_ref) > 10
    assert_maps_match(got, ref)
    ref = jsys_.fns["refresh_stats"](ref, ref.mp_valid)
    got = tsys_.fns["refresh_stats"](got, got.mp_valid)
    assert_maps_match(got, ref)


def _compare_after(tsys_, jsys_):
    got, ref = convert.to_numpy(tsys_.ms), _np(jsys_.ms)
    for f in ("kf_valid", "kf_map", "mp_valid", "mp_map", "kf_parent",
              "loop_i", "loop_j", "loop_valid", "map_valid", "map_change",
              "kf_feat_mp"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert [a.map_id for a in tsys_.agents] == \
        [a.map_id for a in jsys_.agents]
    _assert_poses_match(tsys_.ms, jsys_.ms)


def test_merge_maps_matches_reference(snap):
    tsys_, jsys_ = _pair(snap)
    h, kf, aid = snap["h"], snap["kf"], snap["agent_id"]
    jh = jserver.Hypothesis(**vars(h))
    jsys_.server.merge_maps(aid, kf, jh)
    tsys_.server.merge_maps(aid, kf, tserver.Hypothesis(**vars(h)))
    _compare_after(tsys_, jsys_)
    assert tsys_.server.gba_runs == jsys_.server.gba_runs == [
        jsys_.agents[aid].map_id]
    assert int(tsys_.ms.map_valid.sum()) == 1
    a_t, a_j = tsys_.agents[aid], jsys_.agents[aid]
    assert _ang(a_t.q, np.asarray(a_j.q)) < 1e-3
    np.testing.assert_allclose(a_t.t, np.asarray(a_j.t), atol=1e-3)
    assert tsys_.server.events == jsys_.server.events


def test_merge_gates_imu_prediction_until_reinit(snap, monkeypatch):
    """An inertial agent that a MERGE moves into another map stops
    predicting from the IMU (its estimate belongs to the old map's
    frame and scale: ``imu_init_map != map_id``) until IMU_INIT fires
    again in the new map, after which the prediction is back."""
    import chip_smoke
    from mam3slam_tpu_torch.geometry import lie as tlie

    tsys_, _ = _pair(snap)
    aid, kf = snap["agent_id"], snap["kf"]
    a = tsys_.agents[aid]
    old_map = a.map_id
    a.imu_initialized, a.imu_init_map = True, old_map
    a.gravity_w = np.array([0.0, 9.81, 0.0], np.float32)
    a.vel_w = np.zeros(3, np.float32)
    a.last_ts = 200.0
    tsys_.server.merge_maps(aid, kf, tserver.Hypothesis(**vars(snap["h"])))
    assert a.map_id != old_map == a.imu_init_map
    calls = []
    predict = tsys_._imu_predict
    monkeypatch.setattr(tsys_, "_imu_predict",
                        lambda *args: calls.append(1) or predict(*args))
    imu = (np.zeros((10, 3), np.float32),
           np.tile(np.float32([0.0, -9.81, 0.0]), (10, 1)),
           np.full(10, 0.005, np.float32))
    tsys_.track(aid, empty_frame(), 200.05, imu=imu)
    assert calls == []
    # a window of tracked poses and their IMU in the new map: the
    # initialisation runs again there and the prediction comes back
    monkeypatch.setattr(chip_smoke, "IMU_SIGMA_G", 0.0)
    monkeypatch.setattr(chip_smoke, "IMU_SIGMA_A", 0.0)
    monkeypatch.setattr(chip_smoke, "IMU_BIAS_G", (0.0, 0.0, 0.0))
    monkeypatch.setattr(chip_smoke, "IMU_BIAS_A", (0.0, 0.0, 0.0))
    motion = chip_smoke.OrbitMotion(43, 0.0, 42 * 0.8, bob=0.05)
    poses, imus = motion.frames(), motion.imu(0)
    a.imu_buf = []
    for i in range(1, 43):
        R, _, C = poses[i]
        a.q = tlie.quat_from_matrix(torch.from_numpy(R)).numpy()
        a.t = (-R @ (C / 2.5)).astype(np.float32)
        tsys_._imu_buffer_and_init(a, 300.0 + i * 0.05, imus[i])
    assert tsys_.events[-1] == (f"IMU_INIT agent={aid} map={a.map_id} "
                                f"scale={a.imu_scale:.4f}")
    assert a.imu_init_map == a.map_id and 0.02 < a.imu_scale < 50.0
    a.last_ts = 302.1
    tsys_.track(aid, empty_frame(), 302.15, imu=imu)
    assert calls == [1]
