"""Port parity of the single-device solvers under the distributed layer:
the edge-list LM ``run_ba`` (``solvers/ba.py``), the implicit-Schur PCG
``run_window_ba`` (``solvers/ba_window.py``), the camera-major view of
``build_window_problem``, the ``BAProblem`` wiring of ``slam/steps.py``
and the ``group`` hook of ``run_vi_ba``.

The same numpy inputs go through both packages: tests/test_ba.py's
scenes (fixed vertices and outliers included), tests/test_ba_window_dense
.py's toy window, and one live map state (the port's ``SlamSystem`` with
the reference's RANSAC draws on tests/test_dist_ba.py:270's 40 frames of
SyntheticWorld(n_mp=600, seed=3)), converted into the reference's
``MapState``.  Solver outputs agree within 1e-4 (poses) and 2e-3
(points), costs within 1e-4 relative and at most 0.5% of the inlier
classifications apart (f32 sums in another order); the problem builders
agree field for field; each reference test's own gates hold on the
port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.slam import steps as jsteps
from mam3slam_tpu.solvers import ba as jba
from mam3slam_tpu.solvers import ba_window as jbw
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.parallel import mesh as tmesh
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.solvers import ba as tba
from mam3slam_tpu_torch.solvers import ba_window as tbw
from mam3slam_tpu_torch.solvers import imu as timu
from mam3slam_tpu_torch.solvers import vi as tvi
from test_ba import _build_problem, _reproj_rms, make_scene
from test_ba_window_dense import _toy_problem
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)
from test_torch_capacity import _port, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
from test_torch_vi import _port as _port_vi
from test_torch_vi import simulate

PIN = 0
# the reference's solvers and builders under jax.jit, compiled once per
# shape (eager, their loops compile per call)
_jrun_ba = jax.jit(jba.run_ba, static_argnames=("kind", "iters", "cg_iters",
                                                "robust"))
_jrun_window = jax.jit(jbw.run_window_ba, static_argnames=("kind", "iters",
                                                           "cg_iters"))
_jbuild = jax.jit(jsteps.build_window_problem,
                  static_argnames=("cam_cap", "pt_cap", "with_cm"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_problem(jprob):
    return convert.ba_problem_from_numpy(_np(jprob), "cpu")


def _agree(got, ref, pose_tol=1e-4, pt_tol=2e-3, pt_rtol=0.0):
    """Port and reference results: poses, points, cost and inliers."""
    np.testing.assert_allclose(got.cam_q.numpy(), np.asarray(ref.cam_q),
                               atol=pose_tol)
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(ref.cam_t),
                               atol=pose_tol)
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(ref.pts),
                               atol=pt_tol, rtol=pt_rtol)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-4 * float(ref.cost)
    inl = got.inlier if hasattr(got, "inlier") else got.pm_inlier
    ref_inl = ref.inlier if hasattr(ref, "inlier") else ref.pm_inlier
    assert (inl.numpy() != np.asarray(ref_inl)).mean() <= 5e-3


# ---------------------------------------------------------------------------
# run_ba on tests/test_ba.py's scenes
# ---------------------------------------------------------------------------

def test_run_ba_converges_as_reference():
    """tests/test_ba.py:108: six cameras, the last four and every point
    perturbed; 15 LM iterations x 40 CG steps.  The port within 1e-4 of
    the reference and, like it, back to the noise floor."""
    q, t, pts, oc, op, ouv = make_scene(n_cams=6, n_pts=300, noise_px=0.5,
                                        seed=1)
    rng = np.random.default_rng(2)
    qp, tp = q.copy(), t.copy()
    for k in range(2, len(q)):
        dq = jlie.so3_exp_quat(jnp.asarray(
            rng.normal(0, 0.015, 3).astype(np.float32)))
        qp[k] = np.asarray(jlie.quat_mul(dq, jnp.asarray(q[k])))
        tp[k] = t[k] + rng.normal(0, 0.05, 3)
    ptsp = pts + rng.normal(0, 0.10, pts.shape).astype(np.float32)
    jprob = _build_problem(qp, tp, ptsp, oc, op, ouv,
                           np.array([False, False] + [True] * 4),
                           np.ones(len(pts), bool))
    ref = _jrun_ba(jprob, kind=PIN, iters=15, cg_iters=40)
    got = tba.run_ba(_port_problem(jprob), PIN, iters=15, cg_iters=40)
    _agree(got, ref)
    rms, _ = _reproj_rms(got, oc, op, ouv)
    assert rms < 0.7, rms
    for k in range(2, len(q)):
        assert np.linalg.norm(got.cam_t[k].numpy() - t[k]) < 0.05


def test_run_ba_outliers_as_reference():
    """tests/test_ba.py:137: 1/12 of the edges moved 25-60 px; the robust
    pass, then the polish on its inliers without the kernel.  Both passes
    agree with the reference (the few points held mostly by outlier edges
    are ill-conditioned: within 1% relative, f32 sums in another order),
    the cost of each at the reference's, and the outliers are classified
    as the reference test demands."""
    q, t, pts, oc, op, ouv = make_scene(n_cams=4, n_pts=200, noise_px=0.3,
                                        seed=3)
    n = len(oc)
    rng = np.random.default_rng(4)
    out = rng.choice(n, n // 12, replace=False)
    ouv2 = ouv.copy()
    ouv2[out] += rng.uniform(25, 60, (len(out), 2))
    jprob = _build_problem(q, t, pts, oc, op, ouv2,
                           np.array([False, False, True, True]),
                           np.ones(len(pts), bool))
    tprob = _port_problem(jprob)
    run = _jrun_ba
    ref = run(jprob, kind=PIN, iters=5, cg_iters=30)
    got = tba.run_ba(tprob, PIN, iters=5, cg_iters=30)
    _agree(got, ref, pt_rtol=1e-2)
    ref = run(jprob._replace(cam_q=ref.cam_q, cam_t=ref.cam_t, pts=ref.pts),
              kind=PIN, iters=10, cg_iters=30, edge_mask=ref.inlier,
              robust=False)
    got = tba.run_ba(tprob._replace(cam_q=got.cam_q, cam_t=got.cam_t,
                                    pts=got.pts), PIN, iters=10, cg_iters=30,
                     edge_mask=got.inlier, robust=False)
    _agree(got, ref, pt_rtol=1e-2)
    inl = got.inlier.numpy()
    assert inl[out].mean() < 0.1
    assert np.delete(inl, out).mean() > 0.95
    cost, inlier = tba.ba_cost_and_inliers(tprob, PIN)
    rcost, rinlier = jba.ba_cost_and_inliers(jprob, PIN)
    assert abs(float(cost) - float(rcost)) <= 1e-5 * float(rcost)
    np.testing.assert_array_equal(inlier.numpy(), np.asarray(rinlier))


def test_run_ba_fixed_vertices_do_not_move():
    """tests/test_ba.py:157: a fixed camera and 20 fixed points keep their
    values bit for bit; the rest agrees with the reference."""
    q, t, pts, oc, op, ouv = make_scene(n_cams=4, n_pts=150, seed=5)
    pt_free = np.ones(len(pts), bool)
    pt_free[:20] = False
    jprob = _build_problem(q, t, pts, oc, op, ouv,
                           np.array([False, True, True, True]), pt_free)
    ref = _jrun_ba(jprob, kind=PIN, iters=5, cg_iters=20)
    got = tba.run_ba(_port_problem(jprob), PIN, iters=5, cg_iters=20)
    np.testing.assert_array_equal(got.cam_q[0].numpy(), q[0])
    np.testing.assert_array_equal(got.cam_t[0].numpy(), t[0])
    np.testing.assert_array_equal(got.pts[:20].numpy(), pts[:20])
    _agree(got, ref)


# ---------------------------------------------------------------------------
# the implicit-Schur PCG window solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_run_window_ba_cg_matches_reference(seed):
    """tests/test_ba_window_dense.py:73's toy window (2 fixed cameras of
    8, 256 points) through both packages' ``run_window_ba`` (10 x 40) and
    ``window_cost_and_inliers`` at the start and at the solution (poses
    within 5e-4: 40 f32 CG steps summed in another order); then the
    reference test's gates: the noise floor and the dense solver within
    1.25x of the CG one."""
    jprob, q_gt, t_gt, _ = _toy_problem(seed=seed)
    tprob = convert.window_problem_from_numpy(_np(jprob), "cpu")
    ref = _jrun_window(jprob, kind=PIN, iters=10, cg_iters=40)
    got = tbw.run_window_ba(tprob, PIN, iters=10, cg_iters=40)
    _agree(got, ref, pose_tol=5e-4)
    for state in ((tprob.cam_q, tprob.cam_t, tprob.pts),
                  (got.cam_q, got.cam_t, got.pts)):
        c, inl = tbw.window_cost_and_inliers(tprob, PIN, *state)
        rc, rinl = jbw.window_cost_and_inliers(
            jprob, PIN, *(jnp.asarray(x.numpy()) for x in state))
        assert abs(float(c) - float(rc)) <= 1e-5 * float(rc)
        assert (inl.numpy() != np.asarray(rinl)).mean() <= 5e-3
    dense = tbw.run_window_ba_dense(tprob, PIN, iters=10)

    def rms(res):
        r, _, _, dok = tbw.pm_linearize_all(tprob, PIN, res.cam_q, res.cam_t,
                                            res.pts)
        act = tprob.pm_valid & dok
        return float(torch.sqrt(torch.where(act, (r * r).sum(-1), 0.0).sum()
                                / act.sum()))

    assert rms(dense) < 0.6
    assert rms(dense) <= rms(got) * 1.25 + 0.05
    assert np.abs(got.cam_t[2:].numpy() - t_gt[2:]).max() < 0.05


def test_pm_linearize_all_and_cm_mask_match_reference():
    jprob, *_ = _toy_problem(seed=1)
    tprob = convert.window_problem_from_numpy(_np(jprob), "cpu")
    ref = jbw.pm_linearize_all(jprob, PIN, jprob.cam_q, jprob.cam_t,
                               jprob.pts)
    got = tbw.pm_linearize_all(tprob, PIN, tprob.cam_q, tprob.cam_t,
                               tprob.pts)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)
    mask = np.random.default_rng(0).random(jprob.pm_valid.shape) < 0.7
    np.testing.assert_array_equal(
        tbw.cm_mask_from_pm(tprob, torch.from_numpy(mask)).numpy(),
        np.asarray(jbw.cm_mask_from_pm(jprob, jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# the map-state wiring, on one live state in both packages
# ---------------------------------------------------------------------------

CFG = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
           n_levels=4, min_init_matches=60)


@functools.lru_cache(maxsize=None)
def live_state():
    """(port MapState, the reference's MapState of the same values,
    SlamConfig, map id): the port's SlamSystem on 40 frames."""
    world = SyntheticWorld(n_mp=600, seed=3)
    sys_ = tsys.SlamSystem(tsys.SlamConfig(**CFG), tcam.make_pinhole(
        FX, FY, CX, CY, device="cpu"))
    reference_draws(sys_, 0)
    aid = sys_.add_agent()
    for i, (R, t) in enumerate(make_trajectory(40)):
        f, _ = world.render(R, t)
        st, _ = sys_.track(aid, _port(f), float(i))
    assert st == tsys.OK
    jms = JS.MapState(**{k: jnp.asarray(np.array(v.numpy())) for k, v in
                         sys_.ms._asdict().items()})
    return sys_.ms, jms, sys_.cfg, sys_.agents[aid].map_id


@pytest.fixture(scope="module")
def live():
    return live_state()


def _opt_mask(ms, map_id):
    in_map = ms.kf_valid & (ms.kf_map == map_id)
    first = int(np.argmax(np.asarray(in_map)))
    mask = np.asarray(in_map).copy()
    mask[first] = False
    return mask


def test_build_window_problem_with_cm_matches_reference(live):
    """``with_cm=True`` (the camera-major view and its bridge) and the
    point-major problem of the production callers: every field equal."""
    ms, jms, cfg, map_id = live
    mask = _opt_mask(ms, map_id)
    is2 = np.asarray(cfg.inv_sigma2, np.float32)
    for with_cm in (True, False):
        ref = _jbuild(jms, jnp.asarray(mask), jnp.asarray(is2),
                      cam_cap=16, pt_cap=2048, with_cm=with_cm)
        got = tsteps.build_window_problem(ms, torch.from_numpy(mask),
                                          torch.from_numpy(is2), 16, 2048,
                                          with_cm=with_cm)
        for f in ref._fields:
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.cm_uv.shape[0] == 0 and got.pm_valid.any()
    # the camera-major view solves with the CG solver as the reference's
    tprob = tsteps.build_window_problem(ms, torch.from_numpy(mask),
                                        torch.from_numpy(is2), 16, 2048,
                                        with_cm=True)
    assert tprob.cm_valid.sum() == (tprob.pm_valid
                                    & (tprob.pm_cslot >= 0)).sum()
    jprob = _jbuild(jms, jnp.asarray(mask), jnp.asarray(is2), cam_cap=16,
                    pt_cap=2048, with_cm=True)
    _agree(tbw.run_window_ba(tprob, PIN, iters=5),
           _jrun_window(jprob, kind=PIN, iters=5, cg_iters=30),
           pose_tol=1e-3, pt_tol=1e-2)


def test_local_ba_problem_wiring_matches_reference(live):
    """``build_local_ba_problem`` (every field), ``compact_ba_problem``
    (with an extra row array) and ``apply_ba_result`` after ``run_ba`` on
    it, against the reference on the same state."""
    ms, jms, cfg, map_id = live
    mask = _opt_mask(ms, map_id)
    is2 = np.asarray(cfg.inv_sigma2, np.float32)
    ref = jsteps.build_local_ba_problem(jms, jnp.asarray(mask),
                                        jnp.asarray(is2))
    got = tsteps.build_local_ba_problem(ms, torch.from_numpy(mask),
                                        torch.from_numpy(is2))
    for f in ("cam_q", "cam_t", "cam_params", "pts", "cam_free", "pt_free"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ref.obs._fields:
        a, b = np.asarray(getattr(ref.obs, f)), getattr(got.obs, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    n_valid = int(got.obs.valid.sum())
    assert n_valid > 200
    extra = np.arange(got.obs.cam.shape[0], dtype=np.int32)
    for cap in (n_valid + 64, n_valid - 50):
        rc, rx = jsteps.compact_ba_problem(ref, cap, jnp.asarray(extra))
        gc, gx = tsteps.compact_ba_problem(got, cap, torch.from_numpy(extra))
        for f in rc.obs._fields:
            np.testing.assert_array_equal(getattr(gc.obs, f).numpy(),
                                          np.asarray(getattr(rc.obs, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    gc = tsteps.compact_ba_problem(got, n_valid + 64)
    rc = jsteps.compact_ba_problem(ref, n_valid + 64)
    gres = tba.run_ba(gc, PIN, iters=5, cg_iters=20)
    rres = _jrun_ba(rc, kind=PIN, iters=5, cg_iters=20)
    np.testing.assert_allclose(gres.cam_t.numpy(), np.asarray(rres.cam_t),
                               atol=1e-3)
    gms = tsteps.apply_ba_result(ms, gres, got.cam_free, got.pt_free)
    rms_ = jsteps.apply_ba_result(jms, rres, ref.cam_free, ref.pt_free)
    for f in ("kf_q", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(gms, f).numpy(),
                                   np.asarray(getattr(rms_, f)), atol=1e-2,
                                   err_msg=f)
    fixed = ~mask
    np.testing.assert_array_equal(gms.kf_t.numpy()[fixed],
                                  ms.kf_t.numpy()[fixed])
    assert float(gres.cost) <= float(tba.ba_cost_and_inliers(gc, PIN)[0])


# ---------------------------------------------------------------------------
# the VI solver's reduction hook
# ---------------------------------------------------------------------------

def test_run_vi_ba_world_of_one_is_bit_equal(tmp_path):
    """``run_vi_ba`` with a process group of one rank (gloo, this process)
    gives ``group=None``'s result bit for bit (its parity with the
    reference is tests/test_torch_vi.py's)."""
    sim = simulate()
    n_kf = sim["n_kf"]
    rng = np.random.default_rng(1)
    t0 = sim["t"].copy()
    t0[1:] += rng.normal(0, 0.03, t0[1:].shape)
    cam_free = np.ones(n_kf, bool)
    cam_free[0] = False
    f32 = dict(cam_q=sim["q"], cam_t=t0, vel=sim["v"],
               bg=np.tile(sim["bg"], (n_kf, 1)),
               ba=np.tile(sim["ba"], (n_kf, 1)),
               cam_params=np.broadcast_to(np.asarray(sim["cam"].params),
                                          (n_kf, 8)),
               pts=sim["pts"], gravity=np.array([0.0, 0.0, -9.81]))
    edges, calib = _port_vi(sim)
    prob = tvi.VIProblem(
        obs=convert.from_numpy(tba.Obs, sim["obs"], "cpu"), iedges=edges,
        cam_free=torch.from_numpy(cam_free),
        pt_free=torch.ones(len(sim["pts"]), dtype=torch.bool),
        **{k: torch.from_numpy(np.array(v, np.float32))
           for k, v in f32.items()})
    plain = tvi.run_vi_ba(prob, tcam.PINHOLE, calib, iters=2)
    mesh = tmesh.init_mesh((1,), ("edge",), "gloo",
                           f"file://{tmp_path}/store", device="cpu")
    try:
        grouped = tvi.run_vi_ba(prob, tcam.PINHOLE, calib, iters=2,
                                group=tmesh.axis_group(mesh, "edge"))
    finally:
        tmesh.close_mesh()
    for a, b in zip(grouped, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    walk = timu.calib_squares(calib, prob.cam_t)[2:]
    assert float(plain.cost) < float(tvi.vi_cost(prob, tcam.PINHOLE, *walk))
