"""Port parity: matching (mam3slam_tpu_torch.ops.matching) and the plain
versions of the match kernels (ops/cuda_match.py) against the JAX
reference — the Pallas kernels in interpret mode and the XLA search
routines.  Every comparison is exact, with planted ties."""

import numpy as np
import jax.numpy as jnp
import torch

from mam3slam_tpu.ops import matching as JM
from mam3slam_tpu.ops import pallas_match as PM
from mam3slam_tpu_torch.ops import cuda_match as CM
from mam3slam_tpu_torch.ops import matching as TM


def _draw(seed, Q, F):
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    q_uv = rng.uniform(0, 640, (Q, 2)).astype(np.float32)
    t_uv = rng.uniform(0, 640, (F, 2)).astype(np.float32)
    n = min(Q, F) // 3
    dt[:n] = dq[:n]                               # planted matches
    dt[:n, 3] ^= rng.integers(0, 256, n).astype(np.uint8)
    t_uv[:n] = q_uv[:n] + rng.uniform(-3, 3, (n, 2))
    k = n // 4                                    # exact ties: duplicates
    dt[n:n + k], t_uv[n:n + k] = dt[n - k:n], t_uv[n - k:n]
    radius = rng.uniform(2.5, 12.0, Q).astype(np.float32)
    q_lvl = rng.integers(0, 4, Q).astype(np.int32)
    t_lvl = q_lvl[np.arange(F) % Q].astype(np.int32)
    q_valid = np.ones(Q, bool)
    q_valid[::17] = False
    t_valid = np.ones(F, bool)
    t_valid[::13] = False
    angle_q = rng.uniform(-np.pi, np.pi, Q).astype(np.float32)
    angle_t = angle_q[np.arange(F) % Q] + rng.normal(0, 0.05, F).astype(
        np.float32)
    return dict(dq=dq, dt=dt, q_uv=q_uv, t_uv=t_uv, radius=radius,
                q_lvl=q_lvl, t_lvl=t_lvl, q_valid=q_valid, t_valid=t_valid,
                angle_q=angle_q, angle_t=angle_t)


def _t(d, *keys):
    return tuple(torch.tensor(d[k]) for k in keys)


def _j(d, *keys):
    return tuple(jnp.asarray(d[k]) for k in keys)


def test_fused_masked_match_plain_matches_pallas_interpret():
    d = _draw(41, 512, 384)
    idx, d1, d2 = CM.fused_masked_match_plain(
        *_t(d, "dq", "q_uv", "radius", "q_lvl", "q_valid", "dt", "t_uv",
            "t_lvl", "t_valid"))
    bq = JM.unpack_desc(jnp.asarray(d["dq"]))
    bt = JM.unpack_desc(jnp.asarray(d["dt"]))
    ridx, rd1, rd2 = PM.fused_masked_match(
        bq, *_j(d, "q_uv", "radius", "q_lvl", "q_valid"), bt,
        *_j(d, "t_uv", "t_lvl", "t_valid"), interpret=True, tile_q=256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(rd1).astype(int))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(rd2).astype(int))
    assert (d1.numpy() < 64).sum() > 100              # plants found
    assert (d1.numpy() == d2.numpy()).sum() > 10      # ties exercised


def test_min_hamming2_plain_matches_pallas_interpret():
    d = _draw(11, 256, 300)
    q_valid = np.ones(256, bool)       # the Pallas kernel masks targets only
    idx, d1, d2 = CM.min_hamming2_plain(
        torch.tensor(d["dq"]), torch.tensor(q_valid), torch.tensor(d["dt"]),
        torch.tensor(d["t_valid"]))
    ridx, rd1, rd2 = PM.min_hamming2(
        JM.unpack_desc(jnp.asarray(d["dq"])),
        JM.unpack_desc(jnp.asarray(d["dt"])), jnp.asarray(d["t_valid"]),
        interpret=True, tile_m=128)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(rd1).astype(int))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(rd2).astype(int))
    assert (d1.numpy() == d2.numpy()).sum() > 10


def _same(got, ref):
    for f in ("idx", "dist", "dist2", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_search_by_projection_frame_matches_reference():
    d = _draw(5, 600, 512)
    got = TM.search_by_projection_frame(
        *_t(d, "q_uv", "q_lvl", "radius", "dq", "q_valid", "t_uv", "t_lvl",
            "dt", "t_valid"), max_dist=TM.TH_HIGH, ratio=0.8)
    ref = JM.search_by_projection_frame(
        *_j(d, "q_uv", "q_lvl", "radius"),
        JM.unpack_desc(jnp.asarray(d["dq"])),
        *_j(d, "q_valid", "t_uv", "t_lvl"),
        JM.unpack_desc(jnp.asarray(d["dt"])), jnp.asarray(d["t_valid"]),
        max_dist=JM.TH_HIGH, ratio=0.8)
    _same(got, ref)
    assert got.ok.sum() > 50


def test_search_by_brute_force_matches_reference():
    d = _draw(9, 384, 384)
    got = TM.search_by_brute_force(
        *_t(d, "dq", "q_valid", "angle_q", "dt", "t_valid", "angle_t"))
    ref = JM.search_by_brute_force(
        JM.unpack_desc(jnp.asarray(d["dq"])), *_j(d, "q_valid", "angle_q"),
        JM.unpack_desc(jnp.asarray(d["dt"])), *_j(d, "t_valid", "angle_t"))
    _same(got, ref)
    assert got.ok.sum() > 50


def test_rotation_consistency_and_duplicates_match_reference():
    rng = np.random.default_rng(2)
    Q, F = 300, 200
    angle_q = rng.uniform(-7, 7, Q).astype(np.float32)
    angle_t = rng.uniform(-7, 7, F).astype(np.float32)
    idx = rng.integers(0, F, Q).astype(np.int32)
    ok = rng.random(Q) > 0.3
    angle_q[:150] = angle_t[idx[:150]] + 0.3        # a dominant bin
    got = TM.rotation_consistency_mask(*(torch.tensor(x) for x in
                                         (angle_q, angle_t, idx, ok)))
    ref = JM.rotation_consistency_mask(*(jnp.asarray(x) for x in
                                         (angle_q, angle_t, idx, ok)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    dist = rng.integers(0, 60, Q).astype(np.int32)
    res_t = TM.MatchResult(*(torch.tensor(x) for x in (idx, dist, dist, ok)))
    res_j = JM.MatchResult(*(jnp.asarray(x) for x in (idx, dist, dist, ok)))
    _same(TM.resolve_duplicates(res_t, F), JM.resolve_duplicates(res_j, F))


def test_masks_and_best_in_mask_match_reference():
    d = _draw(3, 200, 150)
    mask_t = (TM.radius_mask(*_t(d, "q_uv", "t_uv", "radius"))
              & TM.level_window_mask(*_t(d, "q_lvl", "t_lvl"), 1, 1))
    mask_j = (JM.radius_mask(*_j(d, "q_uv", "t_uv", "radius"))
              & JM.level_window_mask(*_j(d, "q_lvl", "t_lvl"), 1, 1))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    ham_t = TM.hamming_matrix(*_t(d, "dq", "dt"))
    ham_j = JM.hamming_matrix(JM.unpack_desc(jnp.asarray(d["dq"])),
                              JM.unpack_desc(jnp.asarray(d["dt"])))
    np.testing.assert_array_equal(ham_t.numpy(), np.asarray(ham_j))
    _same(TM.best_in_mask(ham_t, mask_t, 80), JM.best_in_mask(ham_j, mask_j,
                                                               80))
