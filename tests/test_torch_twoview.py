"""Port parity of monocular initialisation: the windowed initial
matching, two-view reconstruction with the reference's RANSAC draws
passed in, and the whole init path (match -> reconstruct -> initial map
-> BA and rescale) on the SyntheticWorld of tests/test_slam_e2e.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.ops import matching as JM
from mam3slam_tpu.slam.system import SlamConfig, _compiled
from mam3slam_tpu.solvers import twoview as jtv
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.geometry import lie as tlie
from mam3slam_tpu_torch.mapstate import state as TS
from mam3slam_tpu_torch.ops import matching as TM
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.solvers import twoview as ttv
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)
from test_torch_mapping import _T, _np, assert_maps_match
from test_twoview import K, synth_pair


def _ang_R(Ra, Rb):
    """Angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(a/2)
    (stable near 0, unlike the trace)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


@pytest.mark.parametrize("planar,seed", [(False, 1), (True, 2), (False, 4)])
def test_reconstruct_two_views_matches_reference(planar, seed):
    uv1, uv2, *_ = synth_pair(planar=planar, seed=seed)
    valid = np.ones(len(uv1), bool)
    valid[::17] = False
    key = jax.random.PRNGKey(seed)
    probe = np.asarray(jax.random.uniform(key, (200, 8)))
    ref = _np(jax.jit(jtv.reconstruct_two_views)(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
        jnp.asarray(K), key))
    got = convert.to_numpy(ttv.reconstruct_two_views(
        _T(uv1), _T(uv2), _T(valid), _T(K), _T(probe)))
    assert bool(ref.ok) and bool(got.ok)
    assert bool(got.used_homography) == bool(ref.used_homography) == planar
    assert _ang_R(got.R21, ref.R21) < 1e-3
    np.testing.assert_allclose(got.t21, ref.t21, atol=1e-3)
    tri = ref.is_triangulated & got.is_triangulated
    assert (got.is_triangulated == ref.is_triangulated).mean() >= 0.99
    assert tri.sum() > 150
    np.testing.assert_allclose(got.points3d[tri], ref.points3d[tri],
                               rtol=1e-3, atol=1e-3)


def test_triangulate_dlt_non_finite_rows_match_reference():
    """A batch with non-finite pixels (a KB8 undistortion that diverged):
    the port does not raise, its rows are NaN exactly where the
    reference's are, and every other row is within 1e-5 (relative and
    absolute) of the reference's."""
    rng = np.random.default_rng(0)
    n = 64
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(2, 9, n)], axis=1)
    R = jlie.quat_to_matrix(jnp.asarray([0.99, 0.0, 0.1, 0.02]) / np.sqrt(
        0.99 ** 2 + 0.1 ** 2 + 0.02 ** 2))
    P1 = np.concatenate([K, np.zeros((3, 1))], axis=1).astype(np.float32)
    P2 = (K @ np.concatenate([np.asarray(R), [[0.4], [0.0], [0.02]]],
                             axis=1)).astype(np.float32)

    def proj(P):
        uv = np.concatenate([pts, np.ones((n, 1))], axis=1) @ P.T
        return (uv[:, :2] / uv[:, 2:3]).astype(np.float32)

    uv1, uv2 = proj(P1), proj(P2)
    uv1[3, 0], uv1[17, 1], uv2[40, 0], uv2[41, 1] = (np.nan, np.inf,
                                                     -np.inf, np.nan)
    args = (np.broadcast_to(P1, (n, 3, 4)), np.broadcast_to(P2, (n, 3, 4)),
            uv1, uv2)
    ref = np.asarray(jtv.triangulate_dlt(*map(jnp.asarray, args)))
    got = ttv.triangulate_dlt(*map(_T, args)).numpy()
    bad = np.isnan(ref).any(1)
    assert sorted(np.flatnonzero(bad)) == [3, 17, 40, 41]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[~bad], ref[~bad], rtol=1e-5, atol=1e-5)


def test_reconstruct_refuses_pure_rotation():
    uv1, uv2, *_ = synth_pair(baseline=0.0, noise=0.3, n_outliers=0, seed=3)
    probe = torch.rand((200, 8), generator=torch.Generator().manual_seed(0))
    res = ttv.reconstruct_two_views(_T(uv1), _T(uv2),
                                    torch.ones(len(uv1), dtype=torch.bool),
                                    _T(K), probe)
    assert not bool(res.ok)


@pytest.mark.parametrize("check_rotation", [True, False])
def test_search_for_initialization_matches_reference(check_rotation):
    world = SyntheticWorld(seed=0)
    poses = make_trajectory(6)
    f1, _ = world.render(*poses[0])
    f2, _ = world.render(*poses[5])
    rng = np.random.default_rng(0)
    # feature angles: mostly consistent, some off, to exercise the
    # rotation histogram
    a1 = rng.uniform(-np.pi, np.pi, N_FEAT).astype(np.float32)
    a2 = (a1 + np.where(rng.random(N_FEAT) < 0.8, 0.05,
                        rng.uniform(-3, 3, N_FEAT))).astype(np.float32)
    args = (np.asarray(f1.uv), np.asarray(f1.desc), a1, np.asarray(f1.valid),
            np.asarray(f2.uv), np.asarray(f2.desc), a2, np.asarray(f2.valid))
    ref = _np(JM.search_for_initialization(
        jnp.asarray(args[0]), JM.unpack_desc(jnp.asarray(args[1])),
        jnp.asarray(a1), jnp.asarray(args[3]), jnp.asarray(args[4]),
        JM.unpack_desc(jnp.asarray(args[5])), jnp.asarray(a2),
        jnp.asarray(args[7]), check_rotation=check_rotation))
    got = convert.to_numpy(TM.search_for_initialization(
        *(_T(x) for x in args), check_rotation=check_rotation))
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert ref.ok.sum() > 100


def test_initialization_path_matches_reference():
    """init_match -> reconstruct (the reference's draws) ->
    create_initial_map -> initial_gba_and_rescale in both packages, on
    frames 0 and 4 of the synthetic trajectory (where the reference
    SlamSystem initialises)."""
    world = SyntheticWorld(seed=0)
    poses = make_trajectory(5)
    fr1, _ = world.render(*poses[0])
    fr2, _ = world.render(*poses[4])
    kw = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
              n_levels=4)
    jf = _compiled(SlamConfig(**kw), jcam.PINHOLE)
    tf = tsys.programs(tsys.SlamConfig(**kw), tcam.PINHOLE)
    jcam_ = jcam.make_pinhole(FX, FY, CX, CY)
    tcam_ = tcam.make_pinhole(FX, FY, CX, CY, device="cpu")
    t1 = tsteps.FrameObs(*(_T(np.asarray(getattr(fr1, k)))
                           for k in tsteps.FrameObs._fields))
    t2 = tsteps.FrameObs(*(_T(np.asarray(getattr(fr2, k)))
                           for k in tsteps.FrameObs._fields))

    res_j = jf["init_match"](fr1, fr2)
    res_t = tf["init_match"](t1, t2)
    np.testing.assert_array_equal(res_t.idx.numpy(), np.asarray(res_j.idx))
    np.testing.assert_array_equal(res_t.ok.numpy(), np.asarray(res_j.ok))
    idx = jnp.clip(res_j.idx, 0)
    key = jax.random.PRNGKey(7)
    rec_j = jf["reconstruct"](fr1.uv, fr2.uv[idx], res_j.ok, jcam_.K(), key)
    rec_t = tf["reconstruct"](
        t1.uv, t2.uv[res_t.idx.clamp(min=0).long()], res_t.ok, tcam_.K(),
        _T(jax.random.uniform(key, (200, 8))))
    assert bool(rec_j.ok) and bool(rec_t.ok)

    ms_j = JS.init_map_state(SlamConfig(**kw).map_config())
    ms_t = TS.init_map_state(tsys.SlamConfig(**kw).map_config(), device="cpu")
    ms_j, kf1_j, _ = jf["create_initial_map"](
        ms_j, fr1, fr2, jlie.quat_from_matrix(rec_j.R21), rec_j.t21,
        jnp.arange(N_FEAT, dtype=jnp.int32), idx,
        rec_j.is_triangulated & res_j.ok, rec_j.points3d, jcam_.params, 0, 0,
        jnp.asarray(0.0), jnp.asarray(4.0))
    ms_t, kf1_t, _ = tf["create_initial_map"](
        ms_t, t1, t2, tlie.quat_from_matrix(rec_t.R21), rec_t.t21,
        torch.arange(N_FEAT, dtype=torch.int32), res_t.idx.clamp(min=0),
        rec_t.is_triangulated & res_t.ok, rec_t.points3d, tcam_.params, 0,
        0, 0.0, 4.0)
    assert_maps_match(ms_t, ms_j, rtol=1e-3, skip=("mp_normal",))
    ms_j, ok_j = jf["initial_gba_and_rescale"](ms_j, kf1_j, jnp.asarray(0))
    ms_t, ok_t = tf["initial_gba_and_rescale"](ms_t, kf1_t, 0)
    assert bool(ok_j) and bool(ok_t)
    assert_maps_match(ms_t, ms_j, rtol=1e-3, skip=("mp_normal", "kf_q"))
    np.testing.assert_allclose(ms_t.mp_normal.numpy(),
                               np.asarray(ms_j.mp_normal), atol=1e-3)
    np.testing.assert_allclose(ms_t.kf_q.numpy(), np.asarray(ms_j.kf_q),
                               atol=1e-3)
    assert int(ms_t.mp_valid.sum()) > 200
