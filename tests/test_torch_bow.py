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


def test_dense_bow_vectors_and_scores_match_reference(vocs):
    """``bow_vector``, ``l1_scores`` and ``shared_word_counts`` (the dense
    forms, tests/test_bow.py:60 and tests/test_vocab_scale.py:100): the
    reference's vectors within 1e-7, scores within 1e-6, counts equal;
    a noisy copy scores above an unrelated frame by > 0.3, and the dense
    scores equal the sparse ones the server uses."""
    ref_voc, voc = vocs
    rng = np.random.default_rng(4)
    frames = [DESCS[:200], _noisy(DESCS[:200], 1, rng),
              rng.integers(0, 256, (200, 32), dtype=np.uint8)]
    valid = rng.random(200) < 0.9
    vecs, rvecs, words = [], [], []
    for d in frames:
        w = tbow.quantize(voc, torch.from_numpy(d))
        words.append(w)
        vecs.append(tbow.bow_vector(voc, w, torch.from_numpy(valid)))
        rvecs.append(jbow.bow_vector(ref_voc, jnp.asarray(w.numpy()),
                                     jnp.asarray(valid)))
        np.testing.assert_allclose(vecs[-1].numpy(), np.asarray(rvecs[-1]),
                                   atol=1e-7)
    db, rdb = torch.stack(vecs[1:]), jnp.stack(rvecs[1:])
    got = tbow.l1_scores(vecs[0], db).numpy()
    np.testing.assert_allclose(got, np.asarray(jbow.l1_scores(rvecs[0], rdb)),
                               atol=1e-6)
    assert got[0] > got[1] + 0.3, got
    mask = torch.stack([torch.zeros(voc.n_words, dtype=torch.bool)
                        .index_fill_(0, w.long(), True) for w in words[1:]])
    np.testing.assert_array_equal(
        tbow.shared_word_counts(words[0], torch.from_numpy(valid),
                                mask).numpy(),
        np.asarray(jbow.shared_word_counts(jnp.asarray(words[0].numpy()),
                                           jnp.asarray(valid),
                                           jnp.asarray(mask.numpy()))))
    rows = [tbow.sparse_bow_row(voc, w.numpy(), valid, 200) for w in words]
    sparse = tbow.l1_scores_sparse(
        torch.from_numpy(tbow.dense_query(voc, *rows[0])),
        torch.from_numpy(np.stack([r[0] for r in rows[1:]])),
        torch.from_numpy(np.stack([r[1] for r in rows[1:]])))
    np.testing.assert_allclose(sparse.numpy(), got, atol=1e-5)


@pytest.mark.parametrize("case", ["planted", "random"])
def test_detect_candidates_matches_reference(case):
    """``detect_candidates`` (tests/test_bow.py:77's planted gate and
    split, and a draw with ties): every output equal to the reference's;
    the planted case's own gates."""
    if case == "planted":
        K = 10
        scores = np.linspace(0.1, 0.9, K).astype(np.float32)
        shared = np.array([50, 45, 44, 10, 44, 44, 3, 44, 50, 44], np.int32)
        eligible = np.ones(K, bool)
        eligible[9] = False
        same_map = np.array([True] * 5 + [False] * 5)
    else:
        rng = np.random.default_rng(5)
        K = 40
        scores = rng.choice([0.1, 0.2, 0.3], K).astype(np.float32)
        shared = rng.choice([0, 30, 40, 50], K).astype(np.int32)
        eligible = rng.random(K) < 0.8
        same_map = rng.random(K) < 0.5
    args = (scores, shared, eligible, same_map)
    for n_best in (3, 5):
        ref = jbow.detect_candidates(*(jnp.asarray(x) for x in args),
                                     n_best=n_best)
        got = tbow.detect_candidates(*(torch.from_numpy(x) for x in args),
                                     n_best=n_best)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if case == "planted":
        li, lok, mi, mok = (x.numpy() for x in tbow.detect_candidates(
            *(torch.from_numpy(x) for x in args)))
        assert 3 not in set(li[lok])
        assert 6 not in set(mi[mok]) and 9 not in set(mi[mok])
        assert mi[0] == 8 and mok[0]


def test_synthesized_vocabulary_matches_reference():
    """``synthesize_vocabulary`` at the reference's scale (10^6 leaves,
    tests/test_vocab_scale.py:198): every level's centroids equal to the
    reference's, ~35.5 MB packed; a frame of 768 descriptors quantises to
    the reference's words and the first 64 leaf centroids to themselves."""
    ref = jbow.synthesize_vocabulary(k=10, depth=6, seed=1)
    voc = tbow.synthesize_vocabulary(k=10, depth=6, seed=1)
    assert voc.n_leaves == voc.n_words == 10 ** 6
    for r, g in zip(ref.centroid_bits, voc.centroid_bits):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(voc.idf.numpy(), np.asarray(ref.idf))
    assert sum(c.numel() for c in voc.centroid_bits) < 40e6
    desc = np.random.default_rng(0).integers(0, 256, (768, 32),
                                             dtype=np.uint8)
    words = tbow.quantize(voc, torch.from_numpy(desc)).numpy()
    np.testing.assert_array_equal(words, np.asarray(jbow.quantize(
        ref, JM.unpack_desc(jnp.asarray(desc)))))
    leaves = tbow.quantize(voc, voc.centroid_bits[-1][:64]).numpy()
    assert (leaves == np.arange(64)).mean() > 0.9
