"""Port parity of windowed BA and the mapping epoch, and the port's
synchronous SlamSystem on its own.

The dense window BA and the whole mapping epoch run in both packages on
the state a JAX SlamSystem holds on the SyntheticWorld of
tests/test_slam_e2e.py just before its fourth keyframe's epoch.  Then
the port's SlamSystem runs that world alone and must meet
test_slam_e2e.py's bounds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.slam import steps as jsteps
from mam3slam_tpu.solvers import ba_window as jbw
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.solvers import ba_window as tbw
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory, umeyama_align)
from test_torch_mapping import (_T, _np, _t_map, assert_maps_match,
                                jax_map_before_epoch)


def _ang(qa, qb):
    """Rotation angle between unit quaternions [..., 4] (rad)."""
    d = np.abs((np.asarray(qa, np.float64)
                * np.asarray(qb, np.float64)).sum(-1))
    return 2 * np.arccos(np.minimum(d, 1.0))


@pytest.fixture(scope="module")
def jax_map():
    return jax_map_before_epoch(4)


def test_dense_window_ba_matches_reference(jax_map):
    """Every KF but the oldest free, poses and points perturbed: the
    problem is built identically and both LM runs land together."""
    pre = jax_map["pre"]
    rng = np.random.default_rng(0)
    ms = pre["ms"]
    ms = ms._replace(
        kf_t=ms.kf_t + jnp.asarray(rng.normal(0, 0.01, ms.kf_t.shape),
                                   jnp.float32) * ms.kf_valid[:, None],
        mp_pos=ms.mp_pos + jnp.asarray(rng.normal(0, 0.02, ms.mp_pos.shape),
                                       jnp.float32) * ms.mp_valid[:, None])
    seq = np.where(np.asarray(ms.kf_valid), np.asarray(ms.kf_seq), 1 << 30)
    opt = np.asarray(ms.kf_valid).copy()
    opt[int(np.argmin(seq))] = False
    is2 = jax_map["cfg"].inv_sigma2
    ref_prob = jax.jit(lambda m, o: jsteps.build_window_problem(
        m, o, jnp.asarray(is2), 8, 1024, with_cm=False))(ms, jnp.asarray(opt))
    prob = tsteps.build_window_problem(_t_map(ms), _T(opt), _T(is2), 8, 1024)
    ref_prob = _np(ref_prob)
    for f in ref_prob._fields:
        np.testing.assert_array_equal(convert.to_numpy(getattr(prob, f)),
                                      getattr(ref_prob, f), err_msg=f)
    assert ref_prob.cam_valid.sum() == 3 and ref_prob.pm_valid.sum() > 600

    # both solve the reference's problem, carried over by convert.py
    ref = _np(jax.jit(lambda p: jbw.run_window_ba_dense(p, 0, iters=6))(
        jbw.WindowProblem(*ref_prob)))
    got = convert.to_numpy(tbw.run_window_ba_dense(
        convert.from_numpy(tbw.WindowProblem, ref_prob, device="cpu"), 0,
        iters=6))
    cv = ref_prob.cam_valid
    assert _ang(got.cam_q[cv], ref.cam_q[cv]).max() < 1e-3
    t_scale = np.abs(ref.cam_t[cv]).max()
    np.testing.assert_allclose(got.cam_t[cv], ref.cam_t[cv],
                               atol=1e-3 * t_scale)
    pv = ref_prob.pt_valid
    np.testing.assert_allclose(got.pts[pv], ref.pts[pv], rtol=1e-3,
                               atol=1e-3 * np.abs(ref.pts[pv]).max())
    assert (got.pm_inlier == ref.pm_inlier)[ref_prob.pm_valid].mean() >= 0.99
    assert ref.pm_inlier.sum() > 0.9 * ref_prob.pm_valid.sum()
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-3)
    # the LM moved the perturbed window
    assert _ang(ref.cam_q[cv], ref_prob.cam_q[cv]).max() > 1e-4


def test_mapping_epoch_matches_reference(jax_map):
    pre = jax_map["pre"]
    ref_ms, ref_pk = jax_map["fns"]["mapping_epoch"](
        pre["ms"], jnp.asarray(pre["kf"]), jnp.asarray(pre["map_id"]),
        jnp.asarray(pre["prot"]))
    got_ms, got_pk = jax_map["tfns"]["mapping_epoch"](
        _t_map(pre["ms"]), pre["kf"], pre["map_id"], _T(pre["prot"]))
    ref_pk, got_pk = np.asarray(ref_pk), got_pk.numpy()
    # counters (culled, new, dropped, fused) and the culling decision:
    # candidate, eligibility, tracked points and parent exact
    np.testing.assert_array_equal(got_pk[0, :4], ref_pk[0, :4])
    assert ref_pk[0, 1] > 0
    # the port also reports the window BA: 2 free cameras, its edges and
    # their final inliers
    assert got_pk[0, 4] == 2 and got_pk[0, 6] > 0.9 * got_pk[0, 5] > 0
    np.testing.assert_array_equal(got_pk[1:, [0, 1, 3, 4]],
                                  ref_pk[1:, [0, 1, 3, 4]])
    np.testing.assert_allclose(got_pk[1:, 2], ref_pk[1:, 2], atol=1e-6)
    live = ref_pk[1:, 1] > 0
    assert live.any()
    assert _ang(got_pk[1:, 5:9][live], ref_pk[1:, 5:9][live]).max() < 1e-3
    np.testing.assert_allclose(got_pk[1:, 9:12], ref_pk[1:, 9:12], atol=1e-3)
    # the map: the same structure, poses and points within the BA bounds
    assert_maps_match(got_ms, ref_ms, rtol=1e-3,
                      skip=("kf_q", "mp_normal"))
    kv = np.asarray(ref_ms.kf_valid)
    assert _ang(got_ms.kf_q.numpy()[kv], np.asarray(ref_ms.kf_q)[kv]).max() \
        < 1e-3
    np.testing.assert_allclose(got_ms.mp_normal.numpy(),
                               np.asarray(ref_ms.mp_normal), atol=1e-3)


# ---------------------------------------------------------------------------
# the port's SlamSystem alone (bounds of tests/test_slam_e2e.py)
# ---------------------------------------------------------------------------

def _frame(world, R, t):
    f, _ = world.render(R, t)
    return tsteps.FrameObs(*(_T(np.asarray(getattr(f, k)))
                             for k in tsteps.FrameObs._fields))


def run_port_slam(n_frames=60):
    world = SyntheticWorld(seed=0)
    poses = make_trajectory(n_frames)
    cfg = tsys.SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=64,
                          max_mp=4096, n_levels=4, kf_max_interval=12,
                          min_init_matches=60)
    sys_ = tsys.SlamSystem(cfg, cameras.make_pinhole(FX, FY, CX, CY,
                                                      device="cpu"))
    aid = sys_.add_agent()
    states = [sys_.track(aid, _frame(world, R, t), ts=float(i))[0]
              for i, (R, t) in enumerate(poses)]
    return sys_, aid, poses, states


@pytest.fixture(scope="module")
def port_run():
    return run_port_slam()


def test_port_slam_tracking_and_ate(port_run):
    sys_, aid, poses, states = port_run
    first_ok = states.index(tsys.OK)
    assert first_ok < 20, first_ok
    assert np.mean([s == tsys.OK for s in states[first_ok:]]) > 0.95
    assert int(sys_.ms.kf_valid.sum()) >= 4
    assert int(sys_.ms.mp_valid.sum()) > 200
    assert len(sys_.timers.series["LM_0"]) >= 2     # mapping epochs ran
    traj = sys_.trajectory_world(aid)
    est, gt = [], []
    for (ts, q, t, st), (R, tt) in zip(traj,
                                       poses[len(poses) - len(traj):]):
        if st == tsys.OK:
            est.append(t)
            gt.append(-R.T @ tt)
    est, gt = np.array(est), np.array(gt)
    assert len(est) > 30
    ate = np.sqrt(((umeyama_align(est, gt) - gt) ** 2).sum(1).mean())
    assert ate < 0.05, ate


def test_port_slam_map_quality(port_run):
    """Forward and reverse observations agree (test_slam_e2e.py's
    bidirectional check)."""
    sys_ = port_run[0]
    ms = convert.to_numpy(sys_.ms)
    checked = 0
    for p in np.where(ms.mp_valid)[0][:200]:
        for m in range(ms.mp_nobs[p]):
            kf, ft = ms.mp_obs_kf[p, m], ms.mp_obs_feat[p, m]
            if kf < 0:
                continue
            assert ms.kf_feat_mp[kf, ft] == p, (p, kf, ft)
            checked += 1
    assert checked > 100
    # and the forward table only links live points of live keyframes
    fmp = ms.kf_feat_mp[ms.kf_valid]
    assert ms.mp_valid[fmp[fmp >= 0]].all()
    JS.MapState(*ms)   # same fields as the reference's MapState
