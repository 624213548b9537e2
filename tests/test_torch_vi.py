"""Port parity of the visual-inertial solvers (mam3slam_tpu_torch.solvers
.vi) on tests/test_vi.py's closed-form circular trajectory: the same
problems through the reference's and the port's ``inertial_optimization``
(the IMU initialisation), ``pose_inertial_optimization`` and
``run_vi_ba``, each compared with the reference within the tolerances
stated below, and each held to the reference test's own gates against
the truth.  The reference runs under ``jax.jit``: one XLA compile
instead of one per loop."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.solvers import vi as jvi
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.solvers import ba as tba
from mam3slam_tpu_torch.solvers import vi as tvi
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
from test_vi import G
from test_vi import simulate as _simulate


@functools.lru_cache(maxsize=None)
def simulate(**kw):
    """tests/test_vi.py's scene, built once per configuration."""
    return _simulate(**kw)


def _T(x):
    return torch.from_numpy(np.array(x, copy=True))


def _ang(qa, qb):
    """Rotation angle between two quaternions (normalised in f64: an f32
    unit quaternion's norm alone is worth ~3e-4 rad of arccos)."""
    qa, qb = (np.asarray(x, np.float64) for x in (qa, qb))
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return 2 * np.arccos(min(d, 1.0))


def _port(sim):
    return (convert.inertial_edges_from_numpy(sim["iedges"], "cpu"),
            convert.imu_calib_from_numpy(sim["calib"], "cpu"))


def _vis_map(sim, s_true, phi0):
    """tests/test_vi.py's visual map: positions shrunk by s_true, world
    rotated by exp(phi0)."""
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(phi0)))
    q_vis, t_vis = [], []
    for k in range(sim["n_kf"]):
        R_cw = np.asarray(jlie.quat_to_matrix(jnp.asarray(sim["q"][k])))
        p_w = -R_cw.T @ sim["t"][k]
        R_cw2 = R_cw @ R0
        q_vis.append(np.asarray(jlie.quat_from_matrix(
            jnp.asarray(R_cw2, jnp.float32))))
        t_vis.append((-R_cw2 @ ((R0.T @ p_w) / s_true)).astype(np.float32))
    return np.array(q_vis), np.array(t_vis), R0


def test_inertial_optimization_matches_reference():
    """Scale within 1e-3 relative, gravity direction within 0.05 deg,
    biases within 1e-4, velocities within 1e-3 of the reference; then the
    reference test's gates against the truth (scale 2%, gravity 0.5 deg,
    gyro bias 1e-3)."""
    sim = simulate(n_kf=10, ba_true=(0.0, 0.0, 0.0))
    s_true = 2.4
    q_vis, t_vis, R0 = _vis_map(sim, s_true,
                                np.array([0.06, -0.09, 0.0], np.float32))
    ref = jax.jit(jvi.inertial_optimization)(
        jnp.asarray(q_vis), jnp.asarray(t_vis), jnp.ones(10, bool),
        sim["iedges"], sim["calib"])
    edges, calib = _port(sim)
    got = tvi.inertial_optimization(_T(q_vis), _T(t_vis),
                                    torch.ones(10, dtype=torch.bool), edges,
                                    calib)
    Rwg, s, bg, ba, vel = (x.numpy() for x in got)
    assert abs(float(s) / float(ref[1]) - 1) < 1e-3
    g_ref = np.asarray(ref[0]) @ [0.0, 0.0, -G]
    g_got = Rwg @ [0.0, 0.0, -G]
    cos = g_got @ g_ref / (np.linalg.norm(g_got) * np.linalg.norm(g_ref))
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.05
    np.testing.assert_allclose(bg, np.asarray(ref[2]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ba, np.asarray(ref[3]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(vel, np.asarray(ref[4]), rtol=0, atol=1e-3)
    # the reference test's gates, on the port
    assert abs(float(s) - s_true) / s_true < 0.02, float(s)
    g_true = R0.T @ np.array([0.0, 0.0, -G])
    cos = g_got @ g_true / (np.linalg.norm(g_got) * np.linalg.norm(g_true))
    assert np.arccos(np.clip(cos, -1, 1)) < np.deg2rad(0.5)
    assert np.abs(bg - sim["bg"]).max() < 1e-3


def test_inertial_optimization_fixed_scale_matches_reference():
    sim = simulate(n_kf=10, ba_true=(0.0, 0.0, 0.0))
    q_vis, t_vis, _ = _vis_map(sim, 1.0,
                               np.array([0.03, 0.05, 0.0], np.float32))
    ref = jax.jit(lambda *a: jvi.inertial_optimization(
        *a, fix_scale=True, iters=20))(
        jnp.asarray(q_vis), jnp.asarray(t_vis), jnp.ones(10, bool),
        sim["iedges"], sim["calib"])
    edges, calib = _port(sim)
    got = tvi.inertial_optimization(_T(q_vis), _T(t_vis),
                                    torch.ones(10, dtype=torch.bool), edges,
                                    calib, fix_scale=True, iters=20)
    assert float(got[1]) == float(ref[1]) == 1.0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), atol=1e-3)


def _pose_inputs(sim, rng):
    dq = jlie.so3_exp_quat(jnp.asarray([0.02, -0.015, 0.01]))
    q0 = np.asarray(jlie.quat_normalize(jlie.quat_mul(
        dq, jnp.asarray(sim["q"][1]))))
    t0 = (sim["t"][1] + rng.normal(0, 0.05, 3)).astype(np.float32)
    v0 = (sim["v"][1] + rng.normal(0, 0.2, 3)).astype(np.float32)
    pts = sim["pts"]
    Xc = np.asarray(jlie.quat_rotate(jnp.asarray(sim["q"][1])[None],
                                     jnp.asarray(pts))) + sim["t"][1]
    uv = np.array(jcam.project_ideal(sim["cam"], jnp.asarray(Xc)))
    out = rng.choice(len(uv), 12, replace=False)
    uv[out] += rng.uniform(30, 60, (12, 2))
    return q0, t0, v0, pts, uv.astype(np.float32), out


def test_pose_inertial_optimization_matches_reference():
    """Pose within 1e-4 rad / 1e-4, velocity within 1e-3 of the reference,
    the same inlier mask; then the reference test's gates.  Keyframes 0
    and 1 and the first edge of the default scene are those of
    tests/test_vi.py's ``simulate(n_kf=3)``."""
    sim = simulate()
    q0, t0, v0, pts, uv, out = _pose_inputs(sim, np.random.default_rng(3))
    n = len(uv)
    refs = (sim["q"][0], sim["t"][0], sim["v"][0], sim["bg"], sim["ba"])
    preint = jax.tree.map(lambda x: x[0], sim["iedges"].preint)
    ref = jax.jit(jvi.pose_inertial_optimization, static_argnums=6)(
        jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(v0),
        jnp.asarray(sim["bg"]), jnp.asarray(sim["ba"]), sim["cam"].params,
        jcam.PINHOLE, jnp.asarray(pts), jnp.asarray(uv), jnp.ones(n),
        jnp.ones(n, bool), *map(jnp.asarray, refs), preint, sim["calib"])
    edges, calib = _port(sim)
    tpre = type(edges.preint)(*(x[0] for x in edges.preint))
    cam = tcam.make_pinhole(300.0, 300.0, 320.0, 240.0, device="cpu")
    got = tvi.pose_inertial_optimization(
        _T(q0), _T(t0), _T(v0), _T(sim["bg"]), _T(sim["ba"]), cam.params,
        tcam.PINHOLE, _T(pts), _T(uv), torch.ones(n),
        torch.ones(n, dtype=torch.bool), *map(_T, refs), tpre, calib)
    q, t, v, bg, ba, inl = (x.numpy() for x in got)
    assert _ang(q, ref[0]) < 1e-4
    np.testing.assert_allclose(t, np.asarray(ref[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(v, np.asarray(ref[2]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(bg, np.asarray(ref[3]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ba, np.asarray(ref[4]), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(inl, np.asarray(ref[5]))
    # the reference test's gates, on the port
    assert _ang(q, sim["q"][1]) < 2e-3
    assert np.linalg.norm(t - sim["t"][1]) < 5e-3
    assert np.linalg.norm(v - sim["v"][1]) < 0.05
    assert not inl[out].any()
    keep = np.ones(n, bool)
    keep[out] = False
    assert inl[keep].mean() > 0.95


def test_run_vi_ba_matches_reference():
    """Every output field within 1e-4 rad / 1e-3 (points, velocities,
    poses) and 1e-4 (biases) of the reference, the cost within 1e-3
    relative; then the reference test's gates."""
    sim = simulate()
    n_kf = sim["n_kf"]
    rng = np.random.default_rng(1)
    q0, t0, v0 = sim["q"].copy(), sim["t"].copy(), sim["v"].copy()
    pts0 = (sim["pts"] + rng.normal(0, 0.01, sim["pts"].shape)).astype(
        np.float32)
    for k in range(1, n_kf):
        dq = jlie.so3_exp_quat(jnp.asarray(rng.normal(0, 0.01, 3),
                                           jnp.float32))
        q0[k] = np.asarray(jlie.quat_normalize(jlie.quat_mul(
            dq, jnp.asarray(q0[k]))))
        t0[k] += rng.normal(0, 0.03, 3)
        v0[k] += rng.normal(0, 0.1, 3)
    v0[0] = sim["v"][0]
    bg0 = np.tile(sim["bg"], (n_kf, 1))
    ba0 = np.tile(sim["ba"], (n_kf, 1))
    bg0[1:] += rng.normal(0, 0.002, (n_kf - 1, 3))
    ba0[1:] += rng.normal(0, 0.01, (n_kf - 1, 3))
    cam_free = np.ones(n_kf, bool)
    cam_free[0] = False
    arrays = dict(cam_q=q0, cam_t=t0, vel=v0, bg=bg0, ba=ba0,
                  cam_params=np.broadcast_to(np.asarray(sim["cam"].params),
                                             (n_kf, 8)),
                  pts=pts0, cam_free=cam_free,
                  pt_free=np.ones(len(pts0), bool),
                  gravity=np.array([0.0, 0.0, -G]))
    f32 = {k: (v.astype(np.float32) if v.dtype != bool else v)
           for k, v in arrays.items()}
    ref = jax.jit(lambda p, c: jvi.run_vi_ba(p, jcam.PINHOLE, c, iters=15))(
        jvi.VIProblem(obs=sim["obs"], iedges=sim["iedges"],
                      **{k: jnp.asarray(v) for k, v in f32.items()}),
        sim["calib"])
    edges, calib = _port(sim)
    got = tvi.run_vi_ba(tvi.VIProblem(
        obs=convert.from_numpy(tba.Obs, sim["obs"], "cpu"), iedges=edges,
        **{k: _T(v) for k, v in f32.items()}),
        tcam.PINHOLE, calib, iters=15)
    for k in range(n_kf):
        assert _ang(got.cam_q[k].numpy(), ref.cam_q[k]) < 1e-4, k
    for f, tol in (("cam_t", 1e-3), ("vel", 1e-3), ("pts", 1e-3),
                   ("bg", 1e-4), ("ba", 1e-3)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=tol, err_msg=f)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-3 * max(
        float(ref.cost), 1.0)
    # the reference test's gates, on the port
    for k in range(n_kf):
        assert _ang(got.cam_q[k].numpy(), sim["q"][k]) < 2e-3, k
        assert np.linalg.norm(got.cam_t[k].numpy() - sim["t"][k]) < 5e-3
    assert np.abs(got.vel.numpy() - sim["v"]).max() < 0.02
    assert np.abs(got.bg.numpy()[1:] - sim["bg"]).max() < 1e-3
    assert np.abs(got.ba.numpy()[1:] - sim["ba"]).max() < 2e-2


@pytest.mark.parametrize("bad", ["nan", "singular"])
def test_inertial_optimization_failure_matches_reference(bad):
    """A covariance that cannot be inverted or factored: the reference's
    linear algebra returns NaN where torch's plain calls raise; the port
    returns what the reference does (every LM step rejected)."""
    sim = simulate(n_kf=10, ba_true=(0.0, 0.0, 0.0))
    ie = sim["iedges"]
    cov = np.asarray(ie.preint.cov).copy()
    cov[1, :9, :9] = np.nan if bad == "nan" else -1.0
    ie = ie._replace(preint=ie.preint._replace(cov=jnp.asarray(cov)))
    q_vis, t_vis, _ = _vis_map(sim, 1.5,
                               np.array([0.02, 0.01, 0.0], np.float32))
    ref = jax.jit(lambda *a: jvi.inertial_optimization(*a, iters=5))(
        jnp.asarray(q_vis), jnp.asarray(t_vis), jnp.ones(10, bool), ie,
        sim["calib"])
    got = tvi.inertial_optimization(
        _T(q_vis), _T(t_vis), torch.ones(10, dtype=torch.bool),
        convert.inertial_edges_from_numpy(ie, "cpu"),
        convert.imu_calib_from_numpy(sim["calib"], "cpu"), iters=5)
    for x, y in zip(got, ref):
        y = np.asarray(y)
        np.testing.assert_array_equal(np.isfinite(x.numpy()), np.isfinite(y))
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4, atol=1e-5)
