"""Port parity of IMU preintegration (mam3slam_tpu_torch.solvers.imu):
the same seeded windows through the reference's ``preintegrate`` (one
window, and a padded batch under ``jax.vmap``) and the port's (batched
over the leading axis), field by field; the bias-corrected getters,
``inertial_residual`` and ``predict_state``; and the assertions of
tests/test_imu.py applied to the port.

Tolerances: 1e-5 absolute on the deltas, the bias jacobians and dt, and
1e-4 of the largest covariance entry (the port reaches ~1e-7 and ~1e-6
of it on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mam3slam_tpu.solvers import imu as jimu
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.solvers import imu as timu
from test_imu import CAL, simulate

TCAL = convert.imu_calib_from_numpy(CAL, "cpu")
DELTAS = ("dt", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
          "bias_g", "bias_a")


def _T(x):
    return torch.from_numpy(np.array(x, copy=True))


def _window(rng, n):
    """A noisy IMU window with biases, as the tracking path feeds it."""
    gyro = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    acc = (rng.normal(0, 1.0, (n, 3)) + [0, 0, 9.81]).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, n).astype(np.float32)
    return gyro, acc, dts


def _assert_preint_match(got, ref):
    for f in DELTAS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    cov = np.asarray(ref.cov)
    np.testing.assert_allclose(got.cov.numpy(), cov, rtol=0,
                               atol=1e-4 * np.abs(cov).max(), err_msg="cov")


def test_preintegrate_matches_reference():
    rng = np.random.default_rng(5)
    g, a, d = _window(rng, 40)
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    ref = jimu.preintegrate(jnp.asarray(g), jnp.asarray(a), jnp.asarray(d),
                            jnp.ones(40, bool), jnp.asarray(bg),
                            jnp.asarray(ba), CAL)
    got = timu.preintegrate(_T(g), _T(a), _T(d),
                            torch.ones(40, dtype=torch.bool), _T(bg), _T(ba),
                            TCAL)
    _assert_preint_match(got, ref)


def test_preintegrate_padded_batch_matches_reference():
    """Three windows of 7, 12 and 16 samples padded to 16, as the IMU
    initialisation batches its segments."""
    rng = np.random.default_rng(6)
    n = (7, 12, 16)
    G = np.zeros((3, 16, 3), np.float32)
    A = np.zeros((3, 16, 3), np.float32)
    D = np.zeros((3, 16), np.float32)
    V = np.zeros((3, 16), bool)
    for m, k in enumerate(n):
        G[m, :k], A[m, :k], D[m, :k] = _window(rng, k)
        G[m, k:], A[m, k:], D[m, k:] = 1.0, 1.0, 0.005   # padding junk
        V[m, :k] = True
    z3 = jnp.zeros(3)
    ref = jax.vmap(lambda g, a, d, v: jimu.preintegrate(
        g, a, d, v, z3, z3, CAL))(jnp.asarray(G), jnp.asarray(A),
                                  jnp.asarray(D), jnp.asarray(V))
    got = timu.preintegrate(_T(G), _T(A), _T(D), _T(V), torch.zeros(3),
                            torch.zeros(3), TCAL)
    assert got.dR.shape == (3, 3, 3) and got.cov.shape == (3, 15, 15)
    _assert_preint_match(got, ref)


def _pair(seed=7, n=30):
    rng = np.random.default_rng(seed)
    g, a, d = _window(rng, n)
    ref = jimu.preintegrate(jnp.asarray(g), jnp.asarray(a), jnp.asarray(d),
                            jnp.ones(n, bool), jnp.zeros(3), jnp.zeros(3),
                            CAL)
    got = timu.preintegrate(_T(g), _T(a), _T(d),
                            torch.ones(n, dtype=torch.bool), torch.zeros(3),
                            torch.zeros(3), TCAL)
    return rng, ref, got


def test_bias_corrected_getters_match_reference():
    rng, ref, got = _pair()
    bg = rng.normal(0, 3e-3, 3).astype(np.float32)
    ba = rng.normal(0, 3e-2, 3).astype(np.float32)
    for name, args in (("delta_rotation", (bg,)),
                       ("delta_velocity", (bg, ba)),
                       ("delta_position", (bg, ba))):
        r = getattr(jimu, name)(ref, *map(jnp.asarray, args))
        o = getattr(timu, name)(got, *map(_T, args))
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_residual_and_prediction_match_reference():
    rng, ref, got = _pair(seed=8)
    R_i = np.asarray(jimu.lie.so3_exp(jnp.asarray(rng.normal(0, 0.5, 3),
                                                  jnp.float32)))
    v_i = rng.normal(0, 1, 3).astype(np.float32)
    p_i = rng.normal(0, 2, 3).astype(np.float32)
    bg = rng.normal(0, 3e-3, 3).astype(np.float32)
    ba = rng.normal(0, 3e-2, 3).astype(np.float32)
    grav = np.array([0.3, -9.7, 1.1], np.float32)
    for gravity in (None, grav):
        jg = None if gravity is None else jnp.asarray(gravity)
        tg = None if gravity is None else _T(gravity)
        pr = jimu.predict_state(ref, *map(jnp.asarray, (R_i, v_i, p_i, bg,
                                                         ba)), gravity=jg)
        po = timu.predict_state(got, *map(_T, (R_i, v_i, p_i, bg, ba)),
                                gravity=tg)
        for x, y in zip(po, pr):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=1e-5)
        # the residual at a perturbed end state
        Rj = np.asarray(pr[0]) @ np.asarray(jimu.lie.so3_exp(
            jnp.asarray([0.01, -0.02, 0.015])))
        vj = np.asarray(pr[1]) + 0.05
        pj = np.asarray(pr[2]) - 0.03
        rr = jimu.inertial_residual(ref, *map(jnp.asarray, (
            R_i, v_i, p_i, Rj, vj, pj, bg, ba)), gravity=jg)
        ro = timu.inertial_residual(got, *map(_T, (
            R_i, v_i, p_i, Rj, vj, pj, bg, ba)), gravity=tg)
        np.testing.assert_allclose(ro.numpy(), np.asarray(rr), rtol=0,
                                   atol=1e-5)
        assert np.abs(np.asarray(rr)).max() > 0.01


# --- the assertions of tests/test_imu.py, on the port ---------------------

def _port_preint(gyro, acc, dts, valid=None, bg=None, ba=None):
    valid = np.ones(len(dts), bool) if valid is None else valid
    z = np.zeros(3, np.float32)
    return timu.preintegrate(_T(gyro), _T(acc), _T(dts), _T(valid),
                             _T(z if bg is None else bg),
                             _T(z if ba is None else ba), TCAL)


def test_port_preintegration_matches_ground_truth():
    gyro, acc, dts, dR_gt, dV_gt, dP_gt = simulate()
    p = _port_preint(gyro, acc, dts)
    assert abs(float(p.dt) - len(dts) * 0.005) < 1e-6
    np.testing.assert_allclose(p.dR.numpy(), dR_gt, atol=2e-3)
    np.testing.assert_allclose(p.dV.numpy(), dV_gt, atol=2e-3)
    np.testing.assert_allclose(p.dP.numpy(), dP_gt, atol=2e-3)
    assert np.linalg.eigvalsh(p.cov.numpy().astype(np.float64)).min() \
        > -1e-12


def test_port_bias_jacobians_first_order():
    gyro, acc, dts, *_ = simulate(seed=1)
    db = np.array([3e-3, -2e-3, 1e-3], np.float32)
    p0 = _port_preint(gyro, acc, dts)
    p1 = _port_preint(gyro, acc, dts, bg=db, ba=db)
    np.testing.assert_allclose(timu.delta_rotation(p0, _T(db)).numpy(),
                               p1.dR.numpy(), atol=5e-4)
    np.testing.assert_allclose(
        timu.delta_velocity(p0, _T(db), _T(db)).numpy(), p1.dV.numpy(),
        atol=2e-3)
    np.testing.assert_allclose(
        timu.delta_position(p0, _T(db), _T(db)).numpy(), p1.dP.numpy(),
        atol=2e-3)


def test_port_masked_padding_is_noop():
    gyro, acc, dts, *_ = simulate(n=100, seed=2)
    pad = 28
    g2 = np.concatenate([gyro, np.ones((pad, 3), np.float32)])
    a2 = np.concatenate([acc, np.ones((pad, 3), np.float32)])
    d2 = np.concatenate([dts, np.full(pad, 0.005, np.float32)])
    v2 = np.concatenate([np.ones(100, bool), np.zeros(pad, bool)])
    p_full = _port_preint(gyro, acc, dts)
    p_pad = _port_preint(g2, a2, d2, valid=v2)
    np.testing.assert_allclose(p_pad.dR.numpy(), p_full.dR.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(p_pad.dP.numpy(), p_full.dP.numpy(),
                               atol=1e-6)
    assert abs(float(p_pad.dt) - float(p_full.dt)) < 1e-6


def test_port_inertial_residual_zero_at_truth():
    gyro, acc, dts, *_ = simulate(seed=4)
    p = _port_preint(gyro, acc, dts)
    z3, g0, eye = torch.zeros(3), torch.zeros(3), torch.eye(3)
    R_j, v_j, p_j = timu.predict_state(p, eye, z3, z3, z3, z3, gravity=g0)
    r = timu.inertial_residual(p, eye, z3, z3, R_j, v_j, p_j, z3, z3,
                               gravity=g0)
    assert float(r.abs().max()) < 1e-4
    r2 = timu.inertial_residual(p, eye, z3, z3, R_j, v_j + 0.1, p_j, z3,
                                z3, gravity=g0)
    assert float(r2.abs().max()) > 0.05
    # differentiable (inertial BA takes its jacobians)
    grad = torch.func.grad(lambda vj: (timu.inertial_residual(
        p, eye, z3, z3, R_j, vj, p_j, z3, z3, gravity=g0) ** 2).sum())(v_j)
    assert bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_port_preintegrate_leading_axes(lead):
    """Windows batched over any leading axes equal one call per window."""
    rng = np.random.default_rng(9)
    G = rng.normal(0, 0.5, lead + (9, 3)).astype(np.float32)
    A = (rng.normal(0, 1, lead + (9, 3)) + [0, 0, 9.81]).astype(np.float32)
    D = rng.uniform(0.004, 0.006, lead + (9,)).astype(np.float32)
    V = rng.uniform(size=lead + (9,)) > 0.2
    got = timu.preintegrate(_T(G), _T(A), _T(D), _T(V), torch.zeros(3),
                            torch.zeros(3), TCAL)
    for idx in np.ndindex(*lead):
        one = _port_preint(G[idx], A[idx], D[idx], valid=V[idx])
        for f in ("dt", "dR", "dV", "dP", "cov", "JRg", "JPa"):
            np.testing.assert_allclose(getattr(got, f).numpy()[idx],
                                       getattr(one, f).numpy(), rtol=0,
                                       atol=1e-6, err_msg=f)
