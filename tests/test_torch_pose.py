"""Port parity: motion-only pose optimisation (mam3slam_tpu_torch.solvers.ba
and the plain version of ops/cuda_pose.py) against the JAX XLA solver and
the Pallas pose kernel in interpret mode, on the draws of
tests/test_pallas_pose.py and with its tolerances."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.ops import pallas_pose
from mam3slam_tpu.solvers import ba as jba
from mam3slam_tpu_torch.ops import cuda_pose
from mam3slam_tpu_torch.solvers import ba as tba


def _problem(seed, n=512, n_out=60, noise=0.6, kind=jcam.PINHOLE):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(3, 12, n)], axis=1).astype(np.float32)
    q_true = jlie.so3_exp_quat(jnp.asarray(rng.normal(0, 0.05, 3),
                                           jnp.float32))
    t_true = jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)
    if kind == jcam.PINHOLE:
        cam = jcam.make_pinhole(458.0, 457.0, 376.0, 240.0)
    else:
        cam = jcam.make_kb8(470.2, 470.2, 479.9, 479.9, 0.0035, 0.0007,
                            -0.002, 0.0002)
    Xc = jlie.quat_rotate(q_true[None, :], jnp.asarray(pts)) + t_true[None]
    uv = np.array(jcam.project_ideal(cam, Xc))
    uv += rng.normal(0, noise, uv.shape)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice(
        [-1, 1], (n_out, 2))
    valid = np.ones(n, bool)
    valid[::29] = False
    q0 = jlie.quat_normalize(jlie.quat_mul(
        jlie.so3_exp_quat(jnp.asarray([0.02, -0.03, 0.01])), q_true))
    t0 = t_true + jnp.asarray([0.05, -0.04, 0.08])
    return dict(cam=cam, pts=pts, uv=uv.astype(np.float32),
                w=np.ones(n, np.float32), valid=valid, q0=np.asarray(q0),
                t0=np.asarray(t0), q_true=np.asarray(q_true),
                t_true=np.asarray(t_true), out_idx=out_idx)


def _ang(qa, qb):
    d = abs(float(np.dot(np.asarray(qa, np.float64),
                         np.asarray(qb, np.float64))))
    return 2 * np.arccos(min(d, 1.0))


def _port(p, **kw):
    res = tba.pose_optimization(
        torch.tensor(p["q0"]), torch.tensor(p["t0"]),
        torch.tensor(np.asarray(p["cam"].params)), p["cam"].kind,
        torch.tensor(p["pts"]), torch.tensor(p["uv"]), torch.tensor(p["w"]),
        torch.tensor(p["valid"]), **kw)
    return [x.numpy() for x in res]


def _check(q, t, inl, ref_q, ref_t, ref_inl):
    assert _ang(q, ref_q) < 2e-3
    assert np.linalg.norm(t - np.asarray(ref_t)) < 5e-3
    assert (inl == np.asarray(ref_inl)).mean() >= 0.99


@pytest.mark.parametrize("seed,kind", [(7, jcam.PINHOLE), (8, jcam.PINHOLE),
                                       (9, jcam.KANNALA_BRANDT8)])
def test_pose_matches_xla_reference(seed, kind):
    p = _problem(seed, kind=kind)
    q, t, inl, n = _port(p)
    ref = jba.pose_optimization(
        jnp.asarray(p["q0"]), jnp.asarray(p["t0"]), p["cam"].params,
        p["cam"].kind, jnp.asarray(p["pts"]), jnp.asarray(p["uv"]),
        jnp.asarray(p["w"]), jnp.asarray(p["valid"]))
    _check(q, t, inl, ref.q, ref.t, ref.inlier)
    _check(q, t, inl, p["q_true"], p["t_true"], np.asarray(ref.inlier))
    assert int(n) == int(inl.sum())
    assert not inl[p["out_idx"]].any() and not inl[~p["valid"]].any()


def test_pose_matches_pallas_interpret():
    p = _problem(7)
    q, t, inl, _ = _port(p)
    R, rt, rinl, _ = pallas_pose.pose_optimization_pinhole(
        jlie.quat_to_matrix(jnp.asarray(p["q0"])), jnp.asarray(p["t0"]),
        p["cam"].params[:4], jnp.asarray(p["pts"]), jnp.asarray(p["uv"]),
        jnp.asarray(p["w"]), jnp.asarray(p["valid"]), interpret=True)
    _check(q, t, inl, jlie.quat_from_matrix(R), rt, rinl)


def test_pose_all_inliers_exact():
    p = _problem(7, n=256, n_out=0, noise=0.0)
    Xc = jlie.quat_rotate(jnp.asarray(p["q_true"])[None],
                          jnp.asarray(p["pts"])) + jnp.asarray(p["t_true"])
    p["uv"] = np.asarray(jcam.project_ideal(p["cam"], Xc))
    p["valid"][:] = True
    q, t, inl, n = _port(p)
    assert _ang(q, p["q_true"]) < 1e-4
    assert np.linalg.norm(t - p["t_true"]) < 1e-4
    assert int(n) == 256


def _batched_matches_single(ps):
    stack = lambda k: torch.tensor(np.stack([p[k] for p in ps]))
    params = torch.tensor(np.stack([np.asarray(p["cam"].params) for p in ps]))
    q, t, inl, n = cuda_pose.pose_optimization_batched(
        stack("q0"), stack("t0"), params, ps[0]["cam"].kind, stack("pts"),
        stack("uv"), stack("w"), stack("valid"))
    for b, p in enumerate(ps):
        q1, t1, inl1, n1 = _port(p)
        np.testing.assert_array_equal(q[b].numpy(), q1)
        np.testing.assert_array_equal(t[b].numpy(), t1)
        np.testing.assert_array_equal(inl[b].numpy(), inl1)
        assert int(n[b]) == int(n1)


def test_batched_pinhole_entry_matches_single():
    """cuda_pose.pose_optimization_batched on a CPU batch = per-problem
    plain solves (the kernel's batch axis is one problem per agent)."""
    _batched_matches_single([_problem(s) for s in (7, 8)])


def test_batched_kb8_entry_matches_single():
    """The same for KB8 cameras: the batched entry carries all 8 camera
    parameters and the kind to each problem's solve."""
    ps = [_problem(s, kind=jcam.KANNALA_BRANDT8) for s in (9, 10)]
    _batched_matches_single(ps)
    with pytest.raises(ValueError):
        cuda_pose.pose_optimization_batched(
            *(torch.zeros(1, *s) for s in ((4,), (3,), (8,))), 2,
            torch.zeros(1, 4, 3), torch.zeros(1, 4, 2), torch.ones(1, 4),
            torch.ones(1, 4, dtype=torch.bool))
