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
