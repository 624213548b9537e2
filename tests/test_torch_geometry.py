"""Port parity: Lie-group ops and camera models (mam3slam_tpu_torch.geometry)
against the JAX reference, on the same numpy draws."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.geometry import lie as tlie

RNG = np.random.default_rng(3)
N = 64

# EuRoC cam0 (radial-tangential) and the reference fixture's KB8 camera
PINHOLE = (458.654, 457.296, 367.215, 248.375,
           -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
KB8 = (470.2, 470.2, 479.9, 479.9,
       0.0034823894022493434, 0.0007150348452162257,
       -0.0020532361418706202, 0.00020293673591811182)


def _quats(n):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


PHI = np.concatenate([RNG.normal(0, 0.5, (N - 4, 3)),
                      RNG.normal(0, 1e-5, (4, 3))]).astype(np.float32)
Q1, Q2 = _quats(N), _quats(N)
V3 = RNG.normal(size=(N, 3)).astype(np.float32)
TAN = np.concatenate([RNG.normal(size=(N, 3)), PHI], 1).astype(np.float32)
# Sim3: scales around 1; sigma with a share under the 1e-4 Taylor cutoff
S7 = np.exp(RNG.normal(0, 0.4, 2 * N)).astype(np.float32)
SIG = np.concatenate([RNG.normal(0, 0.5, N - 8),
                      RNG.normal(0, 1e-5, 8)]).astype(np.float32)
TAN7 = np.concatenate([RNG.normal(size=(N, 3)), PHI, SIG[:, None]],
                      1).astype(np.float32)

LIE_CASES = {
    "quat_mul": (lambda L, T: L.quat_mul(T(Q1), T(Q2))),
    "quat_conj": (lambda L, T: L.quat_conj(T(Q1))),
    "quat_normalize": (lambda L, T: L.quat_normalize(T(3.0 * Q1))),
    "quat_rotate": (lambda L, T: L.quat_rotate(T(Q1), T(V3))),
    "quat_to_matrix": (lambda L, T: L.quat_to_matrix(T(Q1))),
    "quat_from_matrix": (lambda L, T: L.quat_from_matrix(
        L.quat_to_matrix(T(Q1)))),
    "hat": (lambda L, T: L.hat(T(V3))),
    "so3_exp": (lambda L, T: L.so3_exp(T(PHI))),
    "so3_exp_quat": (lambda L, T: L.so3_exp_quat(T(PHI))),
    "so3_left_jacobian": (lambda L, T: L.so3_left_jacobian(T(PHI))),
    "se3_exp": (lambda L, T: tuple(L.se3_exp(T(TAN)))),
    "se3_compose": (lambda L, T: tuple(L.se3_compose(
        L.SE3(T(Q1), T(V3)), L.SE3(T(Q2), T(-V3))))),
    "se3_inverse": (lambda L, T: tuple(L.se3_inverse(L.SE3(T(Q1),
                                                           T(V3))))),
    "vee": (lambda L, T: L.vee(L.hat(T(V3)))),
    "so3_log_quat": (lambda L, T: L.so3_log_quat(L.so3_exp_quat(T(PHI)))),
    "so3_log": (lambda L, T: L.so3_log(L.so3_exp(T(PHI)))),
    "so3_left_jacobian_inv": (lambda L, T: L.so3_left_jacobian_inv(T(PHI))),
    "se3_log": (lambda L, T: L.se3_log(L.SE3(T(Q1), T(V3)))),
    "se3_apply": (lambda L, T: L.se3_apply(L.SE3(T(Q1), T(V3)), T(V3))),
    "se3_matrix": (lambda L, T: L.se3_matrix(L.SE3(T(Q1), T(V3)))),
    "se3_from_Rt": (lambda L, T: tuple(L.se3_from_Rt(
        L.quat_to_matrix(T(Q1)), T(V3)))),
    "se3_identity": (lambda L, T: tuple(L.se3_identity((3,)))),
    "sim3_identity": (lambda L, T: tuple(L.sim3_identity((3,)))),
    "sim3_from_se3": (lambda L, T: tuple(L.sim3_from_se3(
        L.SE3(T(Q1), T(V3)), T(S7[:N])))),
    "sim3_compose": (lambda L, T: tuple(L.sim3_compose(
        L.Sim3(T(Q1), T(V3), T(S7[:N])), L.Sim3(T(Q2), T(-V3),
                                                T(S7[N:]))))),
    "sim3_inverse": (lambda L, T: tuple(L.sim3_inverse(
        L.Sim3(T(Q1), T(V3), T(S7[:N]))))),
    "sim3_apply": (lambda L, T: L.sim3_apply(L.Sim3(T(Q1), T(V3),
                                                    T(S7[:N])), T(-V3))),
    "sim3_matrix": (lambda L, T: L.sim3_matrix(L.Sim3(T(Q1), T(V3),
                                                      T(S7[:N])))),
    "sim3_W": (lambda L, T: L._sim3_W(T(PHI), T(SIG))),
    "sim3_exp": (lambda L, T: tuple(L.sim3_exp(T(TAN7)))),
    "sim3_log": (lambda L, T: L.sim3_log(L.sim3_exp(T(TAN7)))),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_reference(name):
    fn = LIE_CASES[name]
    ref = fn(jlie, jnp.asarray)
    got = fn(tlie, torch.tensor)
    if isinstance(ref, tuple):
        for r, g in zip(ref, got):
            _close(g, r)
    else:
        _close(got, ref)


def _camera_points(kind):
    if kind == tcam.PINHOLE:
        xc = np.stack([RNG.uniform(-2, 2, N), RNG.uniform(-1.5, 1.5, N),
                       RNG.uniform(2, 8, N)], 1)
    else:  # KB8 sees up to ~80 degrees off axis
        th = RNG.uniform(0, 1.3, N)
        ph = RNG.uniform(-np.pi, np.pi, N)
        r = RNG.uniform(1, 6, N)
        xc = np.stack([r * np.sin(th) * np.cos(ph),
                       r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1)
    return xc.astype(np.float32)


@pytest.mark.parametrize("kind", [tcam.PINHOLE, tcam.KANNALA_BRANDT8])
@pytest.mark.parametrize("fn", ["project", "project_ideal", "project_jac",
                                "unproject", "undistort_points"])
def test_camera_matches_reference(kind, fn):
    params = np.asarray(PINHOLE if kind == tcam.PINHOLE else KB8, np.float32)
    jc = jcam.Camera(jnp.asarray(params), kind)
    tc = tcam.Camera(torch.tensor(params), kind)
    xc = _camera_points(kind)
    if fn in ("unproject", "undistort_points"):
        arg = np.asarray(jcam.project(jc, jnp.asarray(xc)))
    else:
        arg = xc
    ref = np.asarray(getattr(jcam, fn)(jc, jnp.asarray(arg)))
    got = getattr(tcam, fn)(tc, torch.tensor(arg)).numpy()
    # pixels: 1e-4 px; rays and jacobians: relative 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


# the round trips and identities of tests/test_lie.py, on the port alone

def test_sim3_exp_log_roundtrip():
    tau = (np.random.default_rng(7).normal(size=(64, 7)) * 0.6).astype(
        np.float32)
    tau[0] = 0
    tau2 = tlie.sim3_log(tlie.sim3_exp(torch.tensor(tau))).numpy()
    np.testing.assert_allclose(tau2, tau, atol=2e-4)


def test_se3_and_so3_log_roundtrip():
    rng = np.random.default_rng(4)
    tau = (rng.normal(size=(64, 6)) * 0.6).astype(np.float32)
    tau[0] = 0
    np.testing.assert_allclose(
        tlie.se3_log(tlie.se3_exp(torch.tensor(tau))).numpy(), tau,
        atol=1e-4)
    phi = tau[:, 3:]
    np.testing.assert_allclose(
        tlie.so3_log(tlie.so3_exp(torch.tensor(phi))).numpy(), phi,
        atol=1e-4)


def test_sim3_compose_inverse_apply():
    tau = (np.random.default_rng(8).normal(size=(32, 7)) * 0.5).astype(
        np.float32)
    a = tlie.sim3_exp(torch.tensor(tau[:16]))
    b = tlie.sim3_exp(torch.tensor(tau[16:]))
    got = tlie.sim3_matrix(tlie.sim3_compose(a, b)).numpy()
    want = tlie.sim3_matrix(a).numpy() @ tlie.sim3_matrix(b).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    ident = tlie.sim3_matrix(tlie.sim3_compose(a, tlie.sim3_inverse(a)))
    np.testing.assert_allclose(ident.numpy(),
                               np.broadcast_to(np.eye(4), ident.shape),
                               atol=1e-4)
    pts = np.random.default_rng(6).normal(size=(16, 3)).astype(np.float32)
    M = tlie.sim3_matrix(a).numpy()
    np.testing.assert_allclose(
        tlie.sim3_apply(a, torch.tensor(pts)).numpy(),
        np.einsum("nij,nj->ni", M[:, :3, :3], pts) + M[:, :3, 3], atol=1e-4)


def test_forward_jacobians_finite_at_zero():
    """Forward mode through the Taylor branches (the PGO's and
    optimize_sim3's linearisation point is the zero tangent)."""
    S = tlie.sim3_exp(torch.tensor(TAN7[:4]))
    J = torch.func.jacfwd(lambda x: tlie.sim3_log(tlie.sim3_compose(
        tlie.sim3_exp(x), S)))(torch.zeros(4, 7))
    assert torch.isfinite(J).all()
    Jq = torch.func.jacfwd(tlie.so3_exp_quat)(torch.zeros(3))
    assert torch.isfinite(Jq).all()
