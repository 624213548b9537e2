"""Port parity of BoW place recognition (mam3slam_tpu_torch.ops.bow):
vocabulary training, quantization, sparse rows and scoring, grouped
candidate ranking with planted covisibility ties, and the carry-over of
reference vocabularies, on the draws of tests/test_bow.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.ops import bow as jbow
from mam3slam_tpu.ops import matching as JM
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.ops import bow as tbow

RNG = np.random.default_rng(31)
DESCS = RNG.integers(0, 256, (3000, 32), dtype=np.uint8)


def _voc_pair(backend, k=6, depth=3):
    ref = jbow.build_vocabulary(DESCS, k=k, depth=depth, iters=3,
                                backend=backend)
    got = tbow.build_vocabulary(DESCS, k=k, depth=depth, iters=3,
                                backend=backend)
    return ref, got


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_build_vocabulary_matches_reference(backend):
    if backend == "native" and jbow._load_native() is None:
        pytest.skip("native/libvocab.so does not load here")
    ref, got = _voc_pair(backend)
    assert (got.k, got.depth, got.n_words) == (ref.k, ref.depth, 216)
    for r, g in zip(ref.centroid_bits, got.centroid_bits):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(ref.idf))


@pytest.fixture(scope="module")
def vocs():
    return _voc_pair("numpy")


def _noisy(d, n_flips, rng):
    d = d.copy()
    for _ in range(n_flips):
        byte = rng.integers(0, 32, len(d))
        bit = rng.integers(0, 8, len(d)).astype(np.uint8)
        d[np.arange(len(d)), byte] ^= (1 << bit).astype(np.uint8)
    return d


def test_quantize_and_rows_match_reference(vocs):
    ref_voc, voc = vocs
    rng = np.random.default_rng(2)
    d = np.concatenate([DESCS[:300], _noisy(DESCS[:300], 4, rng),
                        rng.integers(0, 256, (200, 32), dtype=np.uint8)])
    # exact ties: a descriptor equidistant to two children
    d[-1] = 0
    ref_w = np.asarray(jbow.quantize(ref_voc, JM.unpack_desc(jnp.asarray(d))))
    got_w = tbow.quantize(voc, torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got_w, ref_w)
    assert len(np.unique(got_w)) > 100

    valid = rng.random(len(d)) < 0.9
    for cap in (1000, 64):
        rw, rv = jbow.sparse_bow_row(ref_voc, ref_w, valid, cap)
        gw, gv = tbow.sparse_bow_row(voc, got_w, valid, cap)
        np.testing.assert_array_equal(gw, rw)
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(tbow.dense_query(voc, gw, gv),
                                      jbow.dense_query(ref_voc, rw, rv))


def test_sparse_scores_match_reference(vocs):
    ref_voc, voc = vocs
    rng = np.random.default_rng(3)
    K, F = 24, 200
    rows = []
    for k in range(K):
        d = _noisy(DESCS[(k % 6) * 200:(k % 6) * 200 + F], k % 5, rng)
        w = tbow.quantize(voc, torch.from_numpy(d)).numpy()
        rows.append(tbow.sparse_bow_row(voc, w, rng.random(F) < 0.95, F))
    db_w = np.stack([r[0] for r in rows])
    db_v = np.stack([r[1] for r in rows])
    db_w[5] = -1                       # an empty (unindexed) row
    q = tbow.dense_query(voc, *rows[7])
    ref_s = np.asarray(jbow.l1_scores_sparse(jnp.asarray(q), jnp.asarray(db_w),
                                             jnp.asarray(db_v)))
    got_s = tbow.l1_scores_sparse(torch.from_numpy(q), torch.from_numpy(db_w),
                                  torch.from_numpy(db_v)).numpy()
    np.testing.assert_allclose(got_s, ref_s, atol=1e-6)
    assert abs(got_s[7] - 1.0) < 1e-5 and got_s[5] == 0
    ref_c = np.asarray(jbow.shared_words_sparse(jnp.asarray(q),
                                                jnp.asarray(db_w)))
    got_c = tbow.shared_words_sparse(torch.from_numpy(q),
                                     torch.from_numpy(db_w)).numpy()
    np.testing.assert_array_equal(got_c, ref_c)


def _grouped_case(seed):
    """Scores with repeats, covisibility with many equal weights, and a
    gate that keeps most keyframes."""
    rng = np.random.default_rng(seed)
    K = 40
    scores = rng.choice([0.1, 0.2, 0.3, 0.35], K).astype(np.float32)
    shared = rng.choice([0, 30, 40, 50], K).astype(np.int32)
    eligible = rng.random(K) < 0.8
    covis = rng.choice([0, 0, 15, 30], (K, K)).astype(np.int32)
    covis = np.triu(covis, 1)
    covis = covis + covis.T
    return scores, shared, eligible, covis


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_out", [9, 5])
def test_detect_candidates_grouped_matches_reference(seed, n_out):
    args = _grouped_case(seed)
    reps, acc, ok = (np.asarray(x) for x in jbow.detect_candidates_grouped(
        *(jnp.asarray(a) for a in args), n_out=n_out))
    g_reps, g_acc, g_ok = (x.numpy() for x in tbow.detect_candidates_grouped(
        *(torch.from_numpy(a) for a in args), n_out=n_out))
    np.testing.assert_array_equal(g_ok, ok)
    np.testing.assert_array_equal(g_reps[ok], reps[ok])
    np.testing.assert_allclose(g_acc[ok], acc[ok], atol=1e-6)
    assert ok.sum() >= 2


def test_grouped_rejects_isolated_hit():
    """test_bow.py's scenario on the port: the covisible group outranks
    the isolated best raw score, the weak group is dropped."""
    K = 16
    scores = np.zeros(K, np.float32)
    shared = np.zeros(K, np.int32)
    eligible = np.zeros(K, bool)
    covis = np.zeros((K, K), np.int32)
    scores[3], shared[3], eligible[3] = 0.5, 40, True
    for i in (7, 8, 9, 12, 13):
        scores[i] = 0.4 if i < 10 else 0.15
        shared[i], eligible[i] = 40, True
    for i, j in ((7, 8), (7, 9), (8, 9), (12, 13)):
        covis[i, j] = covis[j, i] = 50
    reps, acc, ok = tbow.detect_candidates_grouped(
        *(torch.from_numpy(a) for a in (scores, shared, eligible, covis)),
        n_out=6)
    reps, acc = reps[ok].numpy(), acc[ok].numpy()
    assert reps[0] in (7, 8, 9) and abs(acc[0] - 1.2) < 1e-5
    assert not {3, 12, 13} & set(reps.tolist())


@pytest.mark.parametrize("k, depth", [(6, 3), (4, 2)])
def test_vocabulary_carry_over(vocs, k, depth):
    """A reference vocabulary carried over by ``convert`` quantizes as the
    reference does."""
    ref_voc = vocs[0] if (k, depth) == (6, 3) else jbow.build_vocabulary(
        DESCS, k=k, depth=depth, iters=3, backend="numpy")
    carried = convert.vocabulary_from_numpy(ref_voc, device="cpu")
    assert carried.leaf_map is None and carried.n_words == ref_voc.n_words
    d = DESCS[:300]
    np.testing.assert_array_equal(
        tbow.quantize(carried, torch.from_numpy(d)).numpy(),
        np.asarray(jbow.quantize(ref_voc, JM.unpack_desc(jnp.asarray(d)))))


def test_orbvoc_incomplete_tree_matches_reference(tmp_path):
    """A DBoW2 tree with missing children and a leaf above the bottom
    level, imported by the reference and carried over by ``convert``:
    the port quantizes through its leaf_map as the reference does."""
    rng = np.random.default_rng(4)
    lines = ["3 2 0 0"]

    def node(parent, leaf, w):
        b = " ".join(str(v) for v in rng.integers(0, 256, 32))
        lines.append(f"{parent} {leaf} {b} {w}")

    node(0, 0, 0.0)        # 1
    node(0, 1, 0.7)        # 2: early leaf
    node(0, 0, 0.0)        # 3
    for p, n in ((1, 3), (3, 2)):
        for _ in range(n):
            node(p, 1, round(rng.uniform(0.1, 2.0), 6))
    path = tmp_path / "inc.txt"
    path.write_text("\n".join(lines) + "\n")
    ref = jbow.load_orbvoc_text(str(path))
    got = convert.vocabulary_from_numpy(ref, device="cpu")
    for r, g in zip(ref.centroid_bits, got.centroid_bits):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got.leaf_map.numpy(),
                                  np.asarray(ref.leaf_map))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(ref.idf))
    d = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    np.testing.assert_array_equal(
        tbow.quantize(got, torch.from_numpy(d)).numpy(),
        np.asarray(jbow.quantize(ref, JM.unpack_desc(jnp.asarray(d)))))
