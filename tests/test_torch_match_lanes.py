"""The masked-match kernel's reduction, on the CPU: targets split
lane-strided over 32 lanes (and in passes of the shared-memory tile),
each lane's best two merged by the kernel's xor-butterfly rule, held
exactly against the plain version (``fused_masked_match_plain``) and the
reference's ``matching.best_in_mask`` on seeded masked matrices, with
equal distances planted across lanes, rows with no candidate or a single
one, and M not a multiple of 32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.ops import matching as JM
from mam3slam_tpu_torch.ops import cuda_match as CM


def _masked_matrix(seed, Q, M):
    rng = np.random.default_rng(seed)
    ham = rng.integers(0, 257, (Q, M)).astype(np.int32)
    mask = rng.random((Q, M)) < 0.05
    # equal distances in other lanes of one row: the lowest index wins and
    # d2 equals d1
    for r in range(0, Q, 7):
        cols = rng.choice(M, size=min(M, 4), replace=False)
        ham[r, cols] = rng.integers(0, 40)
        mask[r, cols] = True
    mask[1::11] = False                                    # no candidate
    single = np.arange(2, Q, 13)
    mask[single] = False
    mask[single, rng.integers(0, M, len(single))] = True   # one candidate
    return ham, mask


def _reference(ham, mask):
    ref = JM.best_in_mask(jnp.asarray(ham), jnp.asarray(mask))
    return [np.asarray(x) for x in (ref.idx, ref.dist, ref.dist2)]


@pytest.mark.parametrize("Q,M,tile", [(64, 1024, 2048), (50, 1000, 2048),
                                      (40, 77, 2048), (33, 31, 2048),
                                      (45, 2500, 2048), (30, 700, 256)])
def test_lane_merge_equals_best_in_mask(Q, M, tile):
    ham, mask = _masked_matrix(Q * 1000 + M, Q, M)
    d = torch.where(torch.tensor(mask), torch.tensor(ham), CM.BIG)
    got = [x.numpy() for x in CM.best_two_lanes(d, tile=tile)]
    plain = [x.numpy() for x in CM.best_two(d)]
    for g, p, r in zip(got, plain, _reference(ham, mask)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(p, r)
    # the planted cases occur
    assert (got[1] == CM.BIG).any() and (got[2] == CM.BIG).any()
    assert ((got[1] == got[2]) & (got[1] < CM.BIG)).any()


def _planted_descriptors(seed, Q, M):
    """Seeded queries and targets: query i near target (7 i) % M, and
    copies of those targets 2 columns on (another lane group), 8 on
    (another warp) and 128 on (the same warp's next round), so that equal
    distances land in other lanes, warps and rounds."""
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    near = (7 * np.arange(Q)) % M
    dq[:] = dt[near]
    flip = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dq ^= flip & rng.integers(0, 256, (Q, 32), dtype=np.uint8) & 0x11
    for step in (2, 8, 128):
        src = near[near + step < M][::3]
        dt[src + step] = dt[src]
    return dq, dt


def _mma_check(dq, dt, qv, tv):
    """best_two_mma of the masked Hamming matrix against the reference's
    best_in_mask and min_hamming2_plain; returns the result."""
    q, t = torch.tensor(dq), torch.tensor(dt)
    qv_t, tv_t = torch.tensor(qv), torch.tensor(tv)
    ham = CM.hamming_matrix(q, t)
    mask = qv_t[:, None] & tv_t[None, :]
    got = [x.numpy() for x in CM.best_two_mma(torch.where(mask, ham, CM.BIG))]
    plain = [x.numpy() for x in CM.min_hamming2_plain(q, qv_t, t, tv_t)]
    for g, p, r in zip(got, plain, _reference(ham.numpy(), mask.numpy())):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(p, r)
    return got


@pytest.mark.parametrize("Q,M", [(1, 1), (33, 77), (1000, 1024),
                                 (1024, 2500)])
def test_mma_reduction_equals_best_in_mask(Q, M):
    """Q and M not multiples of 16 or 8, invalid rows and columns, and
    equal distances planted in other lanes, warps and rounds."""
    rng = np.random.default_rng(Q + M)
    dq, dt = _planted_descriptors(Q * 7 + M, Q, M)
    qv, tv = rng.random(Q) > 0.1, rng.random(M) > 0.1
    qv[0] = tv[0] = True
    got = _mma_check(dq, dt, qv, tv)
    if M >= 77:
        assert ((got[1] == got[2]) & (got[1] < CM.BIG)).sum() >= 3
        assert (got[1][~qv] == CM.BIG).all() and (got[0][~qv] == 0).all()


@pytest.mark.parametrize("case", ["rows_invalid", "columns_invalid",
                                  "single_target", "ties_across_warps"])
def test_mma_reduction_edge_masks(case):
    """All queries or all targets invalid, one valid target, and a row
    whose best distance repeats in every warp and round."""
    Q, M = 40, 300
    rng = np.random.default_rng(11)
    dq, dt = _planted_descriptors(5, Q, M)
    qv, tv = np.ones(Q, bool), np.ones(M, bool)
    if case == "rows_invalid":
        qv[:] = False
    elif case == "columns_invalid":
        tv[:] = False
    elif case == "single_target":
        tv[:] = False
        tv[rng.integers(0, M)] = True
    else:
        dt[13::5] = dq[3]          # d = 0 from column 13 on, every 5th
    got = _mma_check(dq, dt, qv, tv)
    if case in ("rows_invalid", "columns_invalid"):
        assert (got[0] == 0).all() and (got[1] == CM.BIG).all()
    elif case == "single_target":
        assert (got[1] < CM.BIG).all() and (got[2] == CM.BIG).all()
    else:
        assert got[0][3] == 13 and got[1][3] == 0 and got[2][3] == 0


def test_lane_merge_equals_fused_masked_match_plain():
    rng = np.random.default_rng(7)
    Q, M = 300, 1000
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    dt[:100] = dq[:100]
    dt[100:164] = dt[36:100]               # ties 64 columns apart
    dt[500:532] = dt[68:100]               # and in other lanes
    q_uv = rng.uniform(0, 300, (Q, 2)).astype(np.float32)
    t_uv = q_uv[np.arange(M) % Q] + rng.uniform(-3, 3, (M, 2)).astype(
        np.float32)
    t_uv[100:164], t_uv[500:532] = t_uv[36:100], t_uv[68:100]
    args = [torch.tensor(x) for x in (
        dq, q_uv, rng.uniform(2, 9, Q).astype(np.float32),
        rng.integers(0, 4, Q).astype(np.int32), rng.random(Q) > 0.1, dt,
        t_uv, rng.integers(0, 4, M).astype(np.int32), rng.random(M) > 0.1)]
    dq_t, quv, rad, ql, qv, dt_t, tuv, tl, tv = args
    mask = (CM.radius_mask(quv, tuv, rad) & CM.level_window_mask(ql, tl, 1, 1)
            & qv[:, None] & tv[None, :])
    d = torch.where(mask, CM.hamming_matrix(dq_t, dt_t), CM.BIG)
    plain = CM.fused_masked_match_plain(*args)
    for tile in (2048, 96):
        for g, p in zip(CM.best_two_lanes(d, tile=tile), plain):
            assert torch.equal(g, p)
    assert int(((plain[1] == plain[2]) & (plain[1] < CM.BIG)).sum()) > 10
