"""Port parity of the map-state mutators and the local-mapping steps.

The mutators run in both packages on a small random map built the way
tests/test_mapstate.py builds its draws.  The mapping steps run on the
state a JAX SlamSystem holds on the SyntheticWorld of
tests/test_slam_e2e.py just before its third keyframe's mapping epoch,
carried into the port by convert.py: integer tables must agree exactly,
positions within 1e-4 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mam3slam_tpu.geometry import cameras
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.ops import matching as JM
from mam3slam_tpu.slam import steps as jsteps
from mam3slam_tpu.slam.system import SlamConfig, SlamSystem
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.mapstate import state as TS
from mam3slam_tpu_torch.ops import matching as TM
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)

CFG = JS.MapConfig(max_kf=16, max_mp=128, n_feat=32, max_obs=8, n_levels=8)
SCALES = np.asarray([1.2 ** i for i in range(8)], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _T(x):
    return torch.from_numpy(np.array(x, copy=True))


def assert_maps_match(got, ref, rtol=1e-4, skip=()):
    """Exact on integer and bool fields, ``rtol`` (and atol = rtol times
    the field's scale) on float fields."""
    got, ref = convert.to_numpy(got), _np(ref)
    for f in JS.MapState._fields:
        if f in skip:
            continue
        g, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.dtype == r.dtype and g.shape == r.shape, f
        if np.issubdtype(r.dtype, np.floating):
            scale = max(float(np.abs(r).max()), 1.0)
            np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


# ---------------------------------------------------------------------------
# mutators on a random map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_map():
    """5 keyframes with random poses over 60 of 128 points, each KF
    observing 20 distinct points with 32 feature slots."""
    rng = np.random.default_rng(5)
    F = CFG.n_feat
    ms = JS.init_map_state(CFG)
    ms = ms._replace(
        mp_valid=ms.mp_valid.at[:60].set(True),
        mp_map=ms.mp_map.at[:60].set(0),
        mp_pos=jnp.asarray(np.stack([rng.uniform(-2, 2, 128),
                                     rng.uniform(-2, 2, 128),
                                     rng.uniform(3, 8, 128)], 1),
                           jnp.float32))
    add = jax.jit(JS.add_keyframe)
    for k in range(5):
        fmp = np.full(F, -1)
        fmp[rng.choice(F, 20, replace=False)] = rng.choice(60, 20,
                                                           replace=False)
        axis = rng.normal(0, 0.1, 3)
        q = np.concatenate([[1.0], axis / 2])
        ms, _ = add(ms, jnp.asarray(q / np.linalg.norm(q), jnp.float32),
                    jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32), 0, 0,
                    float(k), k,
                    jnp.asarray(rng.uniform(0, 100, (F, 2)), jnp.float32),
                    jnp.asarray(rng.integers(0, 8, F), jnp.int32),
                    jnp.zeros((F,), jnp.float32),
                    jnp.asarray(rng.integers(0, 256, (F, 32)), jnp.uint8),
                    jnp.arange(F) < 30, jnp.asarray(fmp, jnp.int32))
    ms = ms._replace(
        loop_i=ms.loop_i.at[0].set(1), loop_j=ms.loop_j.at[0].set(3),
        loop_valid=ms.loop_valid.at[0].set(True),
        mp_found=jnp.asarray(rng.integers(0, 5, 128), jnp.float32),
        mp_visible=jnp.asarray(rng.integers(0, 9, 128), jnp.float32))
    return ms, convert.map_state_from_numpy(_np(ms), device="cpu"), rng


def _kill_mask(rng):
    m = np.zeros(128, bool)
    m[rng.choice(60, 12, replace=False)] = True
    return m


def _relinked(rng, ms):
    """A kill mask, and a forward table where every link to point 7 goes
    to point 9 instead (repeats of 9 in one keyframe, links to killed
    points left behind)."""
    fmp = np.asarray(ms.kf_feat_mp)
    return _kill_mask(rng), np.where(fmp == 7, 9, fmp).astype(np.int32)


# name -> (mutator(S, ms, *args), args(rng, ms) as numpy arrays)
MUTATORS = {
    "refresh_mp_stats": (
        lambda S, ms, mask, sf: S.refresh_mp_stats(ms, mask, sf),
        lambda rng, ms: (np.arange(128) % 3 != 0, SCALES)),
    "refresh_mp_stats_compact": (
        lambda S, ms, idx, sf: S.refresh_mp_stats_compact(ms, idx, sf),
        lambda rng, ms: (np.array([5, 70, 0, -1, 59, 33, -1, 12], np.int32),
                         SCALES)),
    "remove_map_points": (
        lambda S, ms, kill: S.remove_map_points(ms, kill),
        lambda rng, ms: (_kill_mask(rng),)),
    "replace_map_points": (
        lambda S, ms, src, dst, ok: S.replace_map_points(ms, src, dst, ok),
        lambda rng, ms: (np.arange(20, 40, dtype=np.int32),
                         rng.integers(0, 20, 20).astype(np.int32),
                         rng.random(20) < 0.7)),
    "rebuild_reverse_obs": (
        lambda S, ms, kill, fmp: S.rebuild_reverse_obs(
            S.remove_map_points(ms, kill)._replace(kf_feat_mp=fmp)),
        _relinked),
    "remove_keyframe": (
        lambda S, ms: S.remove_keyframe(ms, 3),
        lambda rng, ms: ()),
}


@pytest.mark.parametrize("name", sorted(MUTATORS))
def test_mutator_matches_reference(small_map, name):
    ms_j, ms_t, _ = small_map
    fn, make_args = MUTATORS[name]
    args = make_args(np.random.default_rng(len(name)), ms_t)
    ref = jax.jit(lambda ms, *a: fn(JS, ms, *a))(
        ms_j, *(jnp.asarray(a) for a in args))
    got = fn(TS, ms_t, *(_T(a) for a in args))
    assert_maps_match(got, ref, rtol=1e-5)


def test_alloc_and_compact_match_reference(small_map):
    ms_j, ms_t, _ = small_map
    ms_j = JS.remove_map_points(ms_j, jnp.zeros(128, bool).at[
        jnp.asarray([3, 17, 40])].set(True))
    ms_t = convert.map_state_from_numpy(_np(ms_j), device="cpu")
    want = np.random.default_rng(2).random(80) < 0.9
    ref = _np(JS.alloc_mp_slots(ms_j, jnp.asarray(want)))
    got = convert.to_numpy(TS.alloc_mp_slots(ms_t, _T(want)))
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0][ref[1]], ref[0][ref[1]])
    assert ref[1].sum() == 71            # 68 free + 3 freed
    mask = np.random.default_rng(3).random(128) < 0.3
    for cap in (16, 64):
        np.testing.assert_array_equal(
            TS.compact_indices(_T(mask), cap).numpy(),
            np.asarray(JS.compact_indices(jnp.asarray(mask), cap)))


def test_mp_add_observation_ranks_repeats(small_map):
    """Several observations of one point in a batch take consecutive
    reverse slots (the port ranks them by a stable sort)."""
    ms_j, ms_t, _ = small_map
    mp = np.array([50, 51, 50, 52, 50, 51], np.int32)
    kf = np.array([0, 1, 2, 3, 4, 0], np.int32)
    feat = np.array([31, 31, 31, 31, 31, 30], np.int32)
    ok = np.array([True, True, True, False, True, True])
    ref = jax.jit(JS.mp_add_observation)(ms_j, *(jnp.asarray(x) for x in
                                                 (mp, kf, feat, ok)))
    got = TS.mp_add_observation(ms_t, *(_T(x) for x in (mp, kf, feat, ok)))
    assert_maps_match(got, ref)
    assert int(got.mp_nobs[50]) == int(ms_t.mp_nobs[50]) + 3


class _ReverseWrites(TorchDispatchMode):
    """Record the (row, slot) indices of every write into a reverse
    table (an int32 [P + 1, M] tensor: the table with its scratch row)."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.cells = tuple(shape), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (str(func).startswith(("aten.index_put", "aten._index_put"))
                and tuple(args[0].shape) == self.shape
                and args[0].dtype == torch.int32):
            self.cells.append(torch.stack([i.long() for i in args[1]], 1))
        return func(*args, **kwargs)


def collision_batch(ms_j):
    """A map where point 50 holds all M reverse slots and point 51 all
    but one, and a batch of three ok observations of each (so that they
    clamp onto one slot), a non-ok row between them, and distinct (kf,
    feat) pairs."""
    M = CFG.max_obs
    obs = np.arange(M, dtype=np.int32)
    ms_j = ms_j._replace(
        mp_nobs=ms_j.mp_nobs.at[50].set(M).at[51].set(M - 1),
        mp_obs_kf=ms_j.mp_obs_kf.at[50].set(obs % 5)
        .at[51, :M - 1].set(obs[:M - 1] % 5),
        mp_obs_feat=ms_j.mp_obs_feat.at[50].set(obs)
        .at[51, :M - 1].set(obs[:M - 1] + 8))
    batch = (np.array([50, 51, 50, 52, 51, 50, 51], np.int32),
             np.array([0, 1, 2, 3, 4, 0, 2], np.int32),
             np.arange(20, 27, dtype=np.int32),
             np.array([True, True, True, False, True, True, True]))
    return ms_j, batch


def test_mp_add_observation_clamped_writes_have_one_winner(small_map):
    """Observations of points at M and M - 1 observations clamp onto
    their last reverse slot: the port keeps the last in batch order, as
    the reference's scatter does, and no two of its writes into the
    reverse tables share a (row, slot) outside the scratch row, so no
    device can pick another winner."""
    ms_j, batch = collision_batch(small_map[0])
    ms_t = convert.map_state_from_numpy(_np(ms_j), device="cpu")
    ref = jax.jit(JS.mp_add_observation)(ms_j, *map(jnp.asarray, batch))
    P, M = ms_t.mp_obs_kf.shape
    with _ReverseWrites((P + 1, M)) as rec:
        got = TS.mp_add_observation(ms_t, *map(_T, batch))
    assert_maps_match(got, ref)
    assert len(rec.cells) == 2
    for cells in rec.cells:
        mine = cells[cells[:, 0] < P]
        assert len(mine) == len(torch.unique(mine, dim=0))
    assert got.mp_obs_kf[50, M - 1] == 0 and got.mp_obs_feat[50, M - 1] == 25
    assert got.mp_obs_kf[51, M - 1] == 2 and got.mp_obs_feat[51, M - 1] == 26


# ---------------------------------------------------------------------------
# mapping steps on a JAX-built map
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def jax_map_before_epoch(n_kf: int) -> dict:
    """Track the SyntheticWorld with a JAX SlamSystem until its ``n_kf``-th
    keyframe is inserted and stop before that keyframe's mapping epoch.
    Returns the reference programs and config, the port's programs, and
    ``pre``: the map, the new KF, its map id and the protected slots."""
    world = SyntheticWorld(seed=0)
    cam = cameras.make_pinhole(FX, FY, CX, CY)
    kw = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
              n_levels=4, kf_max_interval=12, min_init_matches=60)
    sys_ = SlamSystem(SlamConfig(**kw), cam)
    aid = sys_.add_agent()
    run_epoch = sys_._local_mapping
    pre = {}

    def capture(a, kf):
        if int(np.asarray(sys_.ms.kf_valid).sum()) < n_kf:
            return run_epoch(a, kf)
        pre.update(ms=sys_.ms, kf=kf, map_id=a.map_id,
                   prot=np.asarray(sys_._protected_refs()))
        raise _Stop

    sys_._local_mapping = capture
    try:
        for i, (R, t) in enumerate(make_trajectory(60)):
            sys_.track(aid, world.render(R, t)[0], ts=float(i))
    except _Stop:
        pass
    assert pre, "no keyframe epoch captured"
    return dict(fns=sys_.fns, cfg=sys_.cfg, pre=pre,
                tfns=tsys.programs(tsys.SlamConfig(**kw), cameras.PINHOLE))


@pytest.fixture(scope="module")
def jax_map():
    return jax_map_before_epoch(3)


def _t_map(ms):
    return convert.map_state_from_numpy(_np(ms), device="cpu")


def test_search_for_triangulation_matches_reference(jax_map):
    ms = jax_map["pre"]["ms"]
    kf1 = jax_map["pre"]["kf"]
    s2 = np.asarray(jax_map["cfg"].sigma2)
    others = [k for k in range(3) if k != kf1]
    got_b = None
    refs = []
    for kf2 in others:
        F12 = jsteps._fundamental_from_poses(
            ms.kf_q[kf1], ms.kf_t[kf1], ms.kf_q[kf2], ms.kf_t[kf2],
            cameras.Camera(ms.kf_cam[kf1]).K(),
            cameras.Camera(ms.kf_cam[kf2]).K())
        args = [ms.kf_feat_uv[kf1], ms.kf_feat_desc[kf1],
                ms.kf_feat_level[kf1], ms.kf_feat_valid[kf1],
                ms.kf_feat_uv[kf2], ms.kf_feat_desc[kf2],
                ms.kf_feat_level[kf2], ms.kf_feat_valid[kf2], F12]
        ref = _np(JM.search_for_triangulation(
            args[0], JM.unpack_desc(args[1]), args[2], args[3], args[4],
            JM.unpack_desc(args[5]), args[6], args[7], F12,
            jnp.asarray(s2)))
        got = convert.to_numpy(TM.search_for_triangulation(
            *(_T(x) for x in args), _T(s2)))
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f)
        assert ref.ok.sum() > 20
        refs.append((args, ref))
    # the batched search is the per-frame one, frame by frame
    stack = [np.stack([np.asarray(a[i]) for a, _ in refs])
             for i in range(4, 9)]
    args0 = [_T(x) for x in refs[0][0][:4]]
    got_b = convert.to_numpy(TM.search_for_triangulation(
        *args0, *(_T(x) for x in stack), _T(s2)))
    for b, (_, ref) in enumerate(refs):
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got_b, f)[b],
                                          getattr(ref, f), err_msg=f)


def test_cull_map_points_matches_reference(jax_map):
    pre = jax_map["pre"]
    ref, n_ref = jax_map["fns"]["cull_map_points"](pre["ms"], pre["kf"])
    got, n_got = jax_map["tfns"]["cull_map_points"](_t_map(pre["ms"]),
                                                     pre["kf"])
    assert int(n_got) == int(n_ref)
    assert_maps_match(got, ref)


def test_triangulate_multi_step_matches_reference(jax_map):
    pre, fns = jax_map["pre"], jax_map["fns"]
    ms, _ = fns["cull_map_points"](pre["ms"], pre["kf"])
    nb, _, nb_ok = JS.best_covisible(ms, pre["kf"], 8)
    ref, n_ref, d_ref = fns["triangulate_multi_step"](ms, pre["kf"], nb,
                                                      nb_ok, pre["map_id"])
    got, n_got, d_got = jax_map["tfns"]["triangulate_multi_step"](
        _t_map(ms), pre["kf"], _T(nb), _T(nb_ok), pre["map_id"])
    assert int(n_got) == int(n_ref) > 0
    assert int(d_got) == int(d_ref) == 0
    assert_maps_match(got, ref)


def test_fuse_and_rebuild_match_reference(jax_map):
    pre, fns = jax_map["pre"], jax_map["fns"]
    ms, _ = fns["cull_map_points"](pre["ms"], pre["kf"])
    nb, _, nb_ok = JS.best_covisible(ms, pre["kf"], 8)
    ms, _, _ = fns["triangulate_multi_step"](ms, pre["kf"], nb, nb_ok,
                                             pre["map_id"])
    mask = fns["local_mp_mask"](ms, jnp.asarray(pre["kf"]), 16)
    ref, n_ref = fns["fuse_step"](ms, pre["kf"], mask)
    sf = _T(jax_map["cfg"].scale_factors)
    got, n_got, touched = tsteps.fuse_into_kf(
        _t_map(ms), pre["kf"], _T(mask), cameras.PINHOLE, float(W),
        float(H), sf)
    got = TS.update_covis_for_kf(TS.rebuild_reverse_obs(got), pre["kf"])
    assert int(n_got) == int(n_ref)
    assert_maps_match(got, ref)
    assert int(touched.sum()) >= int(n_got)


def test_triangulate_step_matches_reference(jax_map):
    """The one-neighbour ``triangulate_step`` (which no path calls) on the
    pre-epoch map with the new keyframe's best covisible: the same points
    created, the same drops, the same map."""
    pre, fns = jax_map["pre"], jax_map["fns"]
    ms, _ = fns["cull_map_points"](pre["ms"], pre["kf"])
    nb, _, nb_ok = JS.best_covisible(ms, pre["kf"], 8)
    kf2 = int(np.asarray(nb)[np.argmax(np.asarray(nb_ok))])
    ref, n_ref, d_ref = fns["triangulate_step"](ms, pre["kf"], kf2,
                                                pre["map_id"])
    got, n_got, d_got = jax_map["tfns"]["triangulate_step"](
        _t_map(ms), pre["kf"], kf2, pre["map_id"])
    assert int(n_got) == int(n_ref) > 0
    assert int(d_got) == int(d_ref)
    assert_maps_match(got, ref)


def test_kf_redundancy_batch_matches_reference(jax_map):
    """``kf_redundancy_batch`` over every keyframe slot, some masked off
    and one index negative: the reference's fractions and counts."""
    pre = jax_map["pre"]
    K = pre["ms"].kf_valid.shape[0]
    cands = np.arange(-1, K - 1, dtype=np.int32)
    cand_ok = (cands >= 0) & (np.arange(K) % 3 != 1)
    frac_r, n_r = jax_map["fns"]["kf_redundancy_batch"](
        pre["ms"], jnp.asarray(cands), jnp.asarray(cand_ok))
    frac, n = jax_map["tfns"]["kf_redundancy_batch"](
        _t_map(pre["ms"]), _T(cands), _T(cand_ok))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_r))
    np.testing.assert_allclose(frac.numpy(), np.asarray(frac_r), atol=1e-6)
    assert np.asarray(n_r)[cand_ok].max() > 0
