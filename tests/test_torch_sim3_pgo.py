"""Port parity of the server's solvers: Horn / RANSAC / refined Sim3, the
essential-graph PGO, the map-point correction and RANSAC PnP with the
MLPnP polish, on the draws of tests/test_sim3_pgo.py and tests/test_pnp.py.
RANSAC runs take the reference's draws (``jax.random.uniform`` of the
reference's key) as ``probe``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.solvers import pgo as jpgo
from mam3slam_tpu.solvers import pnp as jpnp
from mam3slam_tpu.solvers import sim3 as jsim3
from mam3slam_tpu_torch import _build, convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.geometry import lie as tlie
from mam3slam_tpu_torch.ops import cuda_sim3
from mam3slam_tpu_torch.solvers import pgo as tpgo
from mam3slam_tpu_torch.solvers import pnp as tpnp
from mam3slam_tpu_torch.solvers import sim3 as tsim3
from test_sim3_pgo import _sim3_scene
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

JCAM = jcam.make_pinhole(300.0, 300.0, 320.0, 240.0)
TCAM = tcam.make_pinhole(300.0, 300.0, 320.0, 240.0, device="cpu")


def _T(x):
    return torch.from_numpy(np.array(x, copy=True))


def _ang(qa, qb):
    d = abs(float(np.dot(np.asarray(qa, np.float64),
                         np.asarray(qb, np.float64))))
    return 2 * np.arccos(min(d, 1.0))


def test_horn_matches_reference():
    rng = np.random.default_rng(17)
    p2 = rng.uniform(-3, 3, (5, 40, 3)).astype(np.float32)
    R = Rsc.from_euler("xyz", [20, -10, 35], degrees=True).as_matrix()
    p1 = (1.7 * p2 @ R.T + [0.4, -1.2, 2.0]).astype(np.float32)
    p1 += rng.normal(0, 0.01, p1.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (5, 40)).astype(np.float32)
    for fix in (False, True):
        ref = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2),
                              jnp.asarray(w), fix_scale=fix)
        got = tsim3.horn_sim3(_T(p1), _T(p2), _T(w), fix_scale=fix)
        for b in range(5):
            assert _ang(got[0][b], ref[0][b]) < 1e-4
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=1e-5)


def test_ransac_sim3_matches_reference():
    pc1, pc2, uv1, uv2, R, t, s, out = _sim3_scene()
    n = len(pc1)
    sig = np.linspace(1.0, 2.0, n).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ident, zero = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    ref = jax.jit(lambda *a: jsim3.ransac_sim3(
        *a[:5], JCAM, JCAM, *a[5:]))(
        jnp.asarray(pc1), jnp.asarray(pc2), jnp.ones(n, bool),
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(ident),
        jnp.asarray(zero), jnp.asarray(ident), jnp.asarray(zero), key,
        jnp.asarray(sig), jnp.asarray(sig))
    got = tsim3.ransac_sim3(
        _T(pc1), _T(pc2), torch.ones(n, dtype=torch.bool), _T(uv1), _T(uv2),
        TCAM, TCAM, _T(ident), _T(zero), _T(ident), _T(zero),
        _T(jax.random.uniform(key, (128, 3))), _T(sig), _T(sig))
    assert bool(ref.ok) and bool(got.ok)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert _ang(got.q, ref.q) < 1e-4
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    assert abs(float(got.s) - float(ref.s)) < 1e-4
    assert int(got.n_inliers) == int(ref.n_inliers) > 50


def _plain_counted(fn):
    """``fn()`` through the wrapper on CPU tensors: one plain call counted,
    no launch."""
    plain, launched = (_build.PLAIN_CALLS["sim3_opt"],
                       _build.LAUNCHES["sim3_opt"])
    out = fn()
    assert _build.PLAIN_CALLS["sim3_opt"] == plain + 1
    assert _build.LAUNCHES["sim3_opt"] == launched
    return out


def test_optimize_sim3_matches_reference():
    pc1, pc2, uv1, uv2, R, t, s, out = _sim3_scene(noise=0.0, n_out=0)
    n = len(pc1)
    valid = np.arange(n) % 11 != 0
    q0 = np.asarray(jlie.quat_mul(
        jlie.so3_exp_quat(jnp.asarray([0.02, -0.03, 0.01])),
        jlie.quat_from_matrix(jnp.asarray(R.astype(np.float32)))))
    t0 = (t + [0.05, -0.05, 0.02]).astype(np.float32)
    s0 = np.float32(s * 1.08)
    sig = np.full(n, 1.44, np.float32)
    ref = jax.jit(lambda *a: jsim3.optimize_sim3(*a[:8], JCAM, JCAM,
                                                 *a[8:]))(
        jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(s0), jnp.asarray(pc1),
        jnp.asarray(pc2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(valid), jnp.asarray(sig), jnp.asarray(sig))
    got = _plain_counted(lambda: cuda_sim3.optimize_sim3(
        _T(q0), _T(t0), _T(s0), _T(pc1), _T(pc2), _T(uv1), _T(uv2),
        _T(valid), TCAM, TCAM, _T(sig), _T(sig)))
    assert _ang(got[0], ref[0]) < 1e-3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(ref[1])).max())
    assert abs(float(got[2]) / float(ref[2]) - 1) < 1e-3
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) > 0.9 * valid.sum()
    # the wrapper's CPU path is the plain version itself
    plain = cuda_sim3.optimize_sim3_plain(
        _T(q0), _T(t0), _T(s0), _T(pc1), _T(pc2), _T(uv1), _T(uv2),
        _T(valid), TCAM, TCAM, _T(sig), _T(sig))
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_optimize_sim3_mixed_cameras_match_reference():
    """A pinhole keyframe against a KB8 one (two agents' maps merging):
    half the pairs valid, a fifth of them planted outliers, level sigmas
    that differ by pair and direction; the plain version against the
    reference with the tolerances of the pinhole test above."""
    rng = np.random.default_rng(5)
    n = 120
    pc2 = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(1.5, 9, n)], 1).astype(np.float32)
    R = Rsc.from_euler("xyz", [6, -9, 4], degrees=True).as_matrix()
    t, s = np.array([0.2, -0.3, 0.5]), 0.8
    pc1 = (s * pc2 @ R.T + t).astype(np.float32)
    jkb8 = jcam.make_kb8(352.65, 352.65, 359.925, 359.925, 0.0034823894,
                         0.00071503485, -0.0020532361, 0.00020293674)
    tkb8 = tcam.make_kb8(352.65, 352.65, 359.925, 359.925, 0.0034823894,
                         0.00071503485, -0.0020532361, 0.00020293674,
                         device="cpu")
    uv1 = np.asarray(jcam.project_ideal(JCAM, jnp.asarray(pc1)))
    uv2 = np.asarray(jcam.project_ideal(jkb8, jnp.asarray(pc2)))
    uv1 = (uv1 + rng.normal(0, 0.5, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.5, uv2.shape)).astype(np.float32)
    valid = rng.random(n) < 0.5
    out = rng.choice(n, n // 10, replace=False)
    uv1[out] += rng.uniform(15, 60, (len(out), 2)).astype(np.float32)
    q0 = np.asarray(jlie.quat_mul(
        jlie.so3_exp_quat(jnp.asarray([0.015, 0.02, -0.01])),
        jlie.quat_from_matrix(jnp.asarray(R.astype(np.float32)))))
    t0 = (t + [-0.04, 0.03, 0.05]).astype(np.float32)
    s0 = np.float32(s * 0.93)
    sig1 = (1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    sig2 = (1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    ref = jax.jit(lambda *a: jsim3.optimize_sim3(*a[:8], JCAM, jkb8,
                                                 *a[8:]))(
        jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(s0), jnp.asarray(pc1),
        jnp.asarray(pc2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(valid), jnp.asarray(sig1), jnp.asarray(sig2))
    got = _plain_counted(lambda: cuda_sim3.optimize_sim3(
        _T(q0), _T(t0), _T(s0), _T(pc1), _T(pc2), _T(uv1), _T(uv2),
        _T(valid), TCAM, tkb8, _T(sig1), _T(sig2)))
    assert _ang(got[0], ref[0]) < 1e-3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(ref[1])).max())
    assert abs(float(got[2]) / float(ref[2]) - 1) < 1e-3
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) > 0.8 * (valid.sum() - len(out))
    assert not got[3][~torch.from_numpy(valid)].any()


def _drifted_ring(K=40, radius=5.0):
    """The circular trajectory of test_sim3_pgo.test_pgo_closes_loop:
    exact odometry edges, a loop edge, drifting integrated poses."""
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        Rwc = Rsc.from_euler("y", ang).as_matrix()
        C = np.array([radius * np.sin(ang), 0.0, radius * (1 - np.cos(ang))])
        gt.append(jlie.Sim3(jlie.quat_from_matrix(jnp.asarray(Rwc.T,
                                                              jnp.float32)),
                            jnp.asarray(-Rwc.T @ C, jnp.float32),
                            jnp.asarray(1.0)))
    drift = np.random.default_rng(2)
    est = [gt[0]]
    ei, ej, meas = [], [], []
    for k in range(1, K):
        rel = jlie.sim3_compose(gt[k], jlie.sim3_inverse(gt[k - 1]))
        ei.append(k - 1)
        ej.append(k)
        meas.append(rel)
        noise = np.concatenate([drift.normal(0, 0.01, 3),
                                drift.normal(0, 0.004, 3), [0.004]])
        est.append(jlie.sim3_compose(
            jlie.sim3_compose(jlie.sim3_exp(jnp.asarray(noise, jnp.float32)),
                              rel), est[-1]))
    ei.append(K - 1)
    ej.append(0)
    meas.append(jlie.sim3_compose(gt[0], jlie.sim3_inverse(gt[K - 1])))
    E = len(ei)
    w = np.ones(E, np.float32)
    w[-1] = 5.0
    edges = dict(i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
                 q=np.stack([np.asarray(m.q) for m in meas]),
                 t=np.stack([np.asarray(m.t) for m in meas]),
                 s=np.asarray([float(m.s) for m in meas], np.float32),
                 w=w, valid=np.ones(E, bool))
    poses = [np.stack([np.asarray(getattr(S, f)) for S in est]).astype(
        np.float32) for f in ("q", "t", "s")]
    return poses, edges, gt


def test_essential_graph_matches_reference():
    (q0, t0, s0), edges, gt = _drifted_ring()
    K = q0.shape[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ref = jax.jit(lambda *a: jpgo.optimize_essential_graph(*a, iters=12))(
        jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(s0),
        jnp.asarray(fixed), jpgo.PGOEdges(**{k: jnp.asarray(v) for k, v in
                                             edges.items()}))
    got = tpgo.optimize_essential_graph(
        _T(q0), _T(t0), _T(s0), _T(fixed),
        convert.from_numpy(tpgo.PGOEdges, tpgo.PGOEdges(**edges),
                           device="cpu"), iters=12)
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() for x in got]
    assert max(_ang(a, b) for a, b in zip(got[0], ref[0])) < 1e-3
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3 * np.abs(ref[1]).max())
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3)
    # the loop closed: camera centres within the reference test's bound
    C = -np.asarray(jlie.quat_rotate(jlie.quat_conj(jnp.asarray(got[0])),
                                     jnp.asarray(got[1]))) / got[2][:, None]
    C_gt = np.stack([-np.asarray(jlie.quat_rotate(jlie.quat_conj(g.q), g.t))
                     for g in gt])
    assert np.linalg.norm(C - C_gt, axis=1).max() < 0.08


def test_correct_points_by_ref_matches_reference():
    (q0, t0, s0), _, _ = _drifted_ring()
    rng = np.random.default_rng(3)
    K, P = q0.shape[0], 300
    pos = rng.normal(0, 3, (P, 3)).astype(np.float32)
    ref_kf = rng.integers(-1, K, P).astype(np.int32)
    mask = rng.random(P) < 0.7
    q1 = np.roll(q0, 1, axis=0)
    t1 = (t0 + rng.normal(0, 0.1, t0.shape)).astype(np.float32)
    s1 = (s0 * 1.1).astype(np.float32)
    args = (pos, ref_kf, mask, q0, t0, s0, q1, t1, s1)
    ref = np.asarray(jpgo.correct_points_by_ref(*map(jnp.asarray, args)))
    got = tpgo.correct_points_by_ref(*map(_T, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[~mask], pos[~mask])


def _pnp_scene(rng, n=120, n_out=25, noise=0.4):
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 10, n)], axis=1).astype(np.float32)
    R = Rsc.from_euler("xyz", [8, -5, 12], degrees=True).as_matrix()
    t = np.array([0.3, -0.2, 0.5])
    pc = pts @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:3] * 300.0 + [320.0, 240.0]).astype(np.float32)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    uv[out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    return pts, uv, out


@pytest.mark.parametrize("seed", [23, 5])
def test_ransac_pnp_matches_reference(seed):
    pts, uv, out = _pnp_scene(np.random.default_rng(seed))
    n = len(pts)
    valid = np.ones(n, bool)
    valid[::13] = False
    isig = np.full(n, 1 / 1.44, np.float32)
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(lambda p, u, v, k, i: jpnp.ransac_pnp(p, u, v, JCAM, k, i))(
        jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), key,
        jnp.asarray(isig))
    got = tpnp.ransac_pnp(_T(pts), _T(uv), _T(valid), TCAM,
                          _T(jax.random.uniform(key, (128, 6))), _T(isig))
    assert bool(ref.ok) and bool(got.ok)
    assert _ang(got.q, ref.q) < 2e-3
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-3)
    assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 1
    assert got.inliers.numpy()[out].mean() < 0.1


def test_ml_refine_matches_reference():
    rng = np.random.default_rng(5)
    pts, uv, _ = _pnp_scene(rng, n=80, n_out=0, noise=1.2)
    rays = jcam.unproject(JCAM, jnp.asarray(uv))[:, :2]
    Rd, td = jpnp._dlt_pnp(jnp.asarray(pts)[None], rays[None])
    Rg, tg = tpnp._dlt_pnp(_T(pts)[None],
                           tcam.unproject(TCAM, _T(uv))[:, :2][None])
    q_d = jlie.quat_from_matrix(Rd[0])
    assert _ang(tlie.quat_from_matrix(Rg[0]), q_d) < 1e-3
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(td[0]), atol=5e-3)
    sig = np.full(80, 1.44, np.float32)
    ok = np.arange(80) % 7 != 0
    ref = jax.jit(lambda p, u, o, q, t, sg: jpnp.ml_refine(
        p, u, o, JCAM, q, t, sg))(jnp.asarray(pts), jnp.asarray(uv),
                                  jnp.asarray(ok), q_d, td[0],
                                  jnp.asarray(sig))
    got = tpnp.ml_refine(_T(pts), _T(uv), _T(ok), TCAM, _T(q_d), _T(td[0]),
                         _T(sig))
    assert _ang(got[0], ref[0]) < 2e-3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=5e-3)
    # and the bearing information itself
    ref_b = jax.jit(lambda u, sg: jpnp.bearing_information(JCAM, u, sg))(
        jnp.asarray(uv), jnp.asarray(sig))
    got_b = tpnp.bearing_information(TCAM, _T(uv), _T(sig))
    for r, g in zip(ref_b, got_b):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(r)).max())


def _drifted_ring_4dof(axis, K=40):
    """tests/test_sim3_pgo.py's 4DoF ring (tilted poses, exact chain and
    loop edges), drifted by a growing yaw about ``axis`` (world frame,
    right-composed) and a growing translation."""
    rng = np.random.default_rng(3)
    tilt = Rsc.from_euler("x", 0.15).as_matrix()
    qs, ts = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        c, s = np.cos(a), np.sin(a)
        R = (np.stack([[s, 0.0, -c], [0.0, 1.0, 0.0], [c, 0.0, s]])
             @ tilt).astype(np.float32)
        qs.append(np.asarray(jlie.quat_from_matrix(jnp.asarray(R))))
        ts.append(-R @ np.array([2.0 * c, 0.0, 2.0 * s], np.float32))
    qs, ts = np.stack(qs), np.stack(ts).astype(np.float32)
    ei = np.r_[np.arange(K - 1), [K - 1]].astype(np.int32)
    ej = np.r_[np.arange(1, K), [0]].astype(np.int32)
    qrel = np.asarray(jlie.quat_mul(jnp.asarray(qs[ej]),
                                    jlie.quat_conj(jnp.asarray(qs[ei]))))
    trel = ts[ej] - np.asarray(jlie.quat_rotate(jnp.asarray(qrel),
                                                jnp.asarray(ts[ei])))
    edges = dict(i=ei, j=ej, q=qrel, t=trel.astype(np.float32),
                 s=np.ones(K, np.float32), w=np.ones(K, np.float32),
                 valid=np.ones(K, bool))
    ax = np.array([0.0, 0.0, 1.0] if axis is None else axis, np.float32)
    ax /= np.linalg.norm(ax)
    qd, td = [qs[0]], [ts[0]]
    for k in range(1, K):
        half = 0.5 * 0.012 * k
        dq = np.r_[np.cos(half), np.sin(half) * ax].astype(np.float32)
        qd.append(np.asarray(jlie.quat_mul(jnp.asarray(qs[k]),
                                           jnp.asarray(dq))))
        td.append(ts[k] + np.asarray(jlie.quat_rotate(
            jnp.asarray(qs[k]), jnp.asarray(
                rng.normal(0, 0.01 * k, 3).astype(np.float32)))))
    return (np.stack(qd), np.stack(td).astype(np.float32)), edges, \
        (qs, ts), ax


@pytest.mark.parametrize("axis", [None, (0.2, -1.0, 0.1)],
                         ids=["z", "tilted"])
def test_essential_graph_4dof_matches_reference(axis):
    """The port's 4DoF PGO against the reference's on tests/
    test_sim3_pgo.py's ring, about world z and about a gravity axis that
    is not z: rotations within 1e-3 rad, translations within 1e-3 x the
    largest; then the reference test's gates on the port (poses within
    0.02 rad of the truth; every correction rotation leaves the gravity
    axis where it was)."""
    (qd, td), edges, (qs, _), ax = _drifted_ring_4dof(axis)
    K = qd.shape[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ref = jax.jit(lambda *a: jpgo.optimize_essential_graph_4dof(
        *a, iters=25, gravity_axis=axis))(
        jnp.asarray(qd), jnp.asarray(td), jnp.asarray(fixed),
        jpgo.PGOEdges(**{k: jnp.asarray(v) for k, v in edges.items()}))
    got = tpgo.optimize_essential_graph_4dof(
        _T(qd), _T(td), _T(fixed),
        convert.from_numpy(tpgo.PGOEdges, tpgo.PGOEdges(**edges),
                           device="cpu"), iters=25, gravity_axis=axis)
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() for x in got]
    assert max(_ang(a, b) for a, b in zip(got[0], ref[0])) < 1e-3
    np.testing.assert_allclose(got[1], ref[1],
                               atol=1e-3 * np.abs(ref[1]).max())
    # the reference test's gates, on the port
    assert max(_ang(a, b) for a, b in zip(got[0], qs)) < 0.02
    for k in range(K):
        R_i = np.asarray(jlie.quat_to_matrix(jnp.asarray(qd[k])))
        R_o = np.asarray(jlie.quat_to_matrix(jnp.asarray(got[0][k])))
        np.testing.assert_allclose(R_o.T @ R_i @ ax, ax, atol=1e-4)
