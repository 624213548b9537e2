"""Port parity of the tracking slice as a whole: a JAX SlamSystem tracks
the SyntheticWorld of tests/test_slam_e2e.py for 14 frames; its map, the
agent's chain state and the next frame go through convert.py into the
port, and both packages run the same tracking programs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.geometry import cameras
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.slam.system import OK, SlamConfig, SlamSystem
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.mapstate import state as TS
from mam3slam_tpu_torch.slam import system as tsys
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)

N_TRACKED = 14   # initialised from frame 4; a third KF would cost a mapping
                 # epoch's compile


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    world = SyntheticWorld(seed=0)
    poses = make_trajectory(N_TRACKED + 2)
    cam = cameras.make_pinhole(FX, FY, CX, CY)
    cfg = SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=64,
                     max_mp=4096, n_levels=4, kf_max_interval=12,
                     min_init_matches=60)
    sys_ = SlamSystem(cfg, cam)
    aid = sys_.add_agent()
    for i, (R, t) in enumerate(poses[:N_TRACKED]):
        frame, _ = world.render(R, t)
        state, _ = sys_.track(aid, frame, ts=float(i))
    assert state == OK
    a = sys_.agents[aid]
    frame, _ = world.render(*poses[N_TRACKED])
    chain = (np.asarray(a.q, np.float32), np.asarray(a.t, np.float32),
             np.asarray(a.vel_q, np.float32), np.asarray(a.vel_t, np.float32))
    tcfg = tsys.SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=64,
                           max_mp=4096, n_levels=4)
    return dict(sys=sys_, ms=sys_.ms, frame=frame, ref_kf=int(a.ref_kf),
                chain=chain, cam=cam, fns=tsys.programs(tcfg, 0),
                ms_t=convert.map_state_from_numpy(_np(sys_.ms), device="cpu"),
                frame_t=convert.frame_from_numpy(_np(frame), device="cpu"))


def _T(x):
    return torch.tensor(np.asarray(x))


def _ang(qa, qb):
    d = abs(float(np.dot(np.asarray(qa, np.float64),
                         np.asarray(qb, np.float64))))
    return 2 * np.arccos(min(d, 1.0))


def test_convert_round_trip(run):
    ref = _np(run["ms"])
    back = convert.to_numpy(run["ms_t"])
    for f in JS.MapState._fields:
        a, b = getattr(ref, f), getattr(back, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert TS.MapState._fields == JS.MapState._fields


def test_local_mp_mask_matches_reference(run):
    ref = np.asarray(run["sys"].fns["local_mp_mask"](
        run["ms"], jnp.asarray(run["ref_kf"]), 32))
    got = run["fns"]["local_mp_mask"](run["ms_t"], run["ref_kf"], 32)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 100


def test_track_frame_step_matches_reference(run):
    q_last, t_last, vq, vt = run["chain"]
    idq = np.array([1, 0, 0, 0], np.float32)
    z3 = np.zeros(3, np.float32)
    ref = _np(run["sys"].fns["track_frame_step"](
        run["ms"], run["frame"], jnp.asarray(run["ref_kf"]), vq, vt,
        jnp.asarray(True), q_last, t_last, idq, z3, jnp.asarray(False),
        run["cam"].params))
    got = convert.to_numpy(run["fns"]["track_frame_step"](
        run["ms_t"], run["frame_t"], run["ref_kf"], _T(vq), _T(vt), True,
        _T(q_last), _T(t_last), _T(idq), _T(z3), False,
        _T(run["cam"].params)))
    ms2_r, fmp_r, inl_r, vis_r, vec_r, chain_r = ref
    ms2_g, fmp_g, inl_g, vis_g, vec_g, chain_g = got
    assert (fmp_g == fmp_r).mean() >= 0.99
    assert abs(vec_g[21] - vec_r[21]) <= 2 and vec_r[21] > 100   # n_in
    assert vec_g[22] == vec_r[22]                                # widened
    assert _ang(vec_g[0:4], vec_r[0:4]) < 2e-3
    assert np.linalg.norm(vec_g[4:7] - vec_r[4:7]) < 5e-3
    np.testing.assert_allclose(vec_g, vec_r, atol=5e-3)
    for a, b in zip(chain_g, chain_r):
        np.testing.assert_allclose(a, b, atol=5e-3)
    # found/visible deltas agree on the points whose evidence agrees
    same = (fmp_g == fmp_r) & (inl_g == inl_r) & (fmp_r >= 0)
    pts = fmp_r[same]
    np.testing.assert_array_equal(ms2_g.mp_found[pts], ms2_r.mp_found[pts])
    np.testing.assert_array_equal(ms2_g.mp_visible[vis_g == vis_r],
                                  ms2_r.mp_visible[vis_g == vis_r])
    assert (vis_g == vis_r).mean() >= 0.99


def test_track_ref_kf_matches_reference(run):
    q_last, t_last, _, _ = run["chain"]
    ref = _np(run["sys"].fns["track_ref_kf"](
        run["ms"], run["frame"], jnp.asarray(run["ref_kf"]), q_last, t_last,
        run["cam"].params))
    got = convert.to_numpy(run["fns"]["track_ref_kf"](
        run["ms_t"], run["frame_t"], run["ref_kf"], _T(q_last), _T(t_last),
        _T(run["cam"].params)))
    assert (got[0] == ref[0]).mean() >= 0.99
    assert abs(int(got[4]) - int(ref[4])) <= 2 and int(ref[4]) > 100
    assert int(got[5]) == int(ref[5])
    assert _ang(got[1], ref[1]) < 2e-3
    assert np.linalg.norm(got[2] - ref[2]) < 5e-3


def test_add_keyframe_matches_reference(run):
    """Insert the tracked frame as a keyframe in both packages: every
    MapState field (observations, covisibility, spanning parent)
    agrees."""
    q_last, t_last, _, _ = run["chain"]
    fmp, _, _, _, _, _, _ = run["sys"].fns["match_and_pose"](
        run["ms"], run["frame"], q_last, t_last, run["cam"].params,
        run["ms"].mp_valid, jnp.asarray(6.0), 100, 0.9)
    f = _np(run["frame"])
    kw = dict(q=q_last, t=t_last, agent=0, map_id=0, ts=21.0, agent_kf_id=9)
    ref, kf_r = jax.jit(JS.add_keyframe)(
        run["ms"], feat_uv=f.uv, feat_level=f.level, feat_angle=f.angle,
        feat_desc=f.desc, feat_valid=f.valid, feat_mp=fmp,
        cam_params=run["cam"].params, **kw)
    kw = {k: (_T(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    fr = run["frame_t"]
    got, kf_g = TS.add_keyframe(run["ms_t"], feat_uv=fr.uv,
                                feat_level=fr.level, feat_angle=fr.angle,
                                feat_desc=fr.desc, feat_valid=fr.valid,
                                feat_mp=_T(fmp),
                                cam_params=_T(run["cam"].params), **kw)
    assert int(kf_g) == int(kf_r)
    ref, got = _np(ref), convert.to_numpy(got)
    for name in JS.MapState._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    assert (np.asarray(ref.covis)[int(kf_r)] > 0).sum() >= 2
    idx_r, w_r, ok_r = _np(JS.best_covisible(ref, int(kf_r), 4))
    idx_g, w_g, ok_g = convert.to_numpy(TS.best_covisible(
        convert.map_state_from_numpy(ref, device="cpu"), int(kf_r), 4))
    np.testing.assert_array_equal(idx_g, idx_r)
    np.testing.assert_array_equal(w_g, w_r)
