"""Bag-of-words place recognition: vocabulary tree and keyframe scoring.

Port of the parts of ``mam3slam_tpu.ops.bow`` that the loop server and
relocalization call.  The vocabulary is a flat per-level table of packed
binary centroids (the children of node ``n`` at slots ``n*k .. n*k+k-1``
of the next level); a descriptor descends by ``depth`` batched
Hamming-argmin steps, the lowest child winning equal distances.  A
keyframe's BoW row is sparse: its word ids and L1-normalised tf-idf
values (at most F of them), kept on the host as the reference keeps them.
Candidate ranking takes the top-k of the reference as a stable descending
sort, so equal values keep the lower index first.

The vocabulary is trained by hierarchical k-majority, through the native
trainer (``native/libvocab.so``, ctypes) when it loads, else in numpy.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from mam3slam_tpu_torch.ops import cuda_match

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


class Vocabulary(NamedTuple):
    """``centroid_bits[l]``: [k^(l+1), 32] packed u8 centroids of level l;
    ``idf`` [n_words] f32; ``leaf_map`` (incomplete trees the reference
    imports from ORBvoc text, carried over by ``convert``): [k^depth] i32
    leaf slot -> word id, None for trained complete trees."""

    centroid_bits: tuple
    idf: torch.Tensor
    k: int
    depth: int
    leaf_map: Optional[torch.Tensor] = None

    @property
    def n_leaves(self) -> int:
        return self.k ** self.depth

    @property
    def n_words(self) -> int:
        return int(self.idf.shape[0])

    def to(self, device) -> "Vocabulary":
        return self._replace(
            centroid_bits=tuple(c.to(device) for c in self.centroid_bits),
            idf=self.idf.to(device),
            leaf_map=None if self.leaf_map is None
            else self.leaf_map.to(device))


def _vocabulary(levels, idf, k, depth) -> Vocabulary:
    """Vocabulary of CPU tensors from numpy arrays."""
    return Vocabulary(
        centroid_bits=tuple(torch.from_numpy(np.ascontiguousarray(lv))
                            for lv in levels),
        idf=torch.from_numpy(np.asarray(idf, np.float32)), k=k, depth=depth)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _unpack_bits_np(desc: np.ndarray) -> np.ndarray:
    return np.unpackbits(desc, axis=-1, bitorder="little").astype(np.uint8)


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=-1, bitorder="little")


def _kmajority(bits: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """Binary k-means (majority-vote centroids) on [N, 256] 0/1 arrays.
    Returns [k, 256] centroids."""
    n = bits.shape[0]
    if n == 0:
        return rng.integers(0, 2, (k, 256)).astype(np.uint8)
    init = rng.choice(n, size=min(k, n), replace=False)
    cent = bits[init].astype(np.uint8)
    if len(init) < k:
        cent = np.concatenate(
            [cent, rng.integers(0, 2, (k - len(init), 256)).astype(np.uint8)])
    for _ in range(iters):
        d = (bits.astype(np.float32) @ (1 - 2 * cent.astype(np.float32)).T
             + cent.sum(axis=1)[None, :])
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel) == 0:
                cent[c] = bits[rng.integers(0, n)]
            else:
                cent[c] = (sel.mean(axis=0) >= 0.5).astype(np.uint8)
    return cent


def _load_native():
    """ctypes handle of native/libvocab.so (native/build.sh), or None."""
    try:
        lib = ctypes.CDLL(os.path.abspath(
            os.path.join(_REPO, "native", "libvocab.so")))
    except OSError:
        return None
    lib.build_vocab.restype = ctypes.c_int
    lib.build_vocab.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _idf(leaf: np.ndarray, n: int, n_leaves: int) -> np.ndarray:
    counts = np.bincount(leaf, minlength=n_leaves).astype(np.float64)
    return np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)


def _build_vocabulary_native(lib, descs, k, depth, iters, seed):
    n = len(descs)
    offsets = np.cumsum([0] + [k ** (lv + 1) for lv in range(depth)])
    cents = np.zeros((offsets[-1], 32), np.uint8)
    leaf = np.zeros(n, np.int32)
    descs = np.ascontiguousarray(descs, np.uint8)
    rc = lib.build_vocab(descs.ctypes.data, n, k, depth, iters, seed,
                         cents.ctypes.data, leaf.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"native build_vocab failed rc={rc}")
    levels = [cents[offsets[lv]:offsets[lv + 1]] for lv in range(depth)]
    return _vocabulary(levels, _idf(leaf, n, k ** depth), k, depth)


def build_vocabulary(descs: np.ndarray, k: int = 10, depth: int = 3,
                     iters: int = 4, seed: int = 0,
                     backend: str = "auto") -> Vocabulary:
    """Hierarchical k-majority vocabulary from [N, 32] u8 descriptors, with
    DBoW2 TF-IDF weights from the training set; CPU tensors.  ``backend``:
    "auto" takes the native trainer when it loads, else numpy; "native"
    or "numpy" insist on one."""
    lib = _load_native() if backend in ("auto", "native") else None
    if lib is not None:
        return _build_vocabulary_native(lib, descs, k, depth, iters, seed)
    if backend == "native":
        raise RuntimeError("native vocab library unavailable "
                           "(run native/build.sh)")
    rng = np.random.default_rng(seed)
    bits = _unpack_bits_np(descs)
    n = bits.shape[0]
    levels = []
    assignments = np.zeros(n, np.int64)
    for lv in range(depth):
        cents = np.zeros((k ** (lv + 1), 256), np.uint8)
        new_assign = np.zeros(n, np.int64)
        for p in range(k ** lv):
            sel = assignments == p
            c = _kmajority(bits[sel], k, iters, rng)
            cents[p * k:(p + 1) * k] = c
            if sel.any():
                sub = bits[sel].astype(np.float32)
                d = (sub @ (1 - 2 * c.astype(np.float32)).T
                     + c.sum(axis=1)[None, :])
                new_assign[sel] = p * k + d.argmin(axis=1)
        assignments = new_assign
        levels.append(_pack_bits_np(cents))
    return _vocabulary(levels, _idf(assignments, n, k ** depth), k, depth)


# ---------------------------------------------------------------------------
# quantization and scoring
# ---------------------------------------------------------------------------

def quantize(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """[N, 32] packed u8 descriptors -> [N] i32 word ids: at each level the
    k children of the current node are gathered and the nearest by
    Hamming distance taken (exact f32 bit products, first minimum)."""
    n = desc.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    x = cuda_match.unpack_bits(desc)                        # [N, 256]
    pop_x = x.sum(-1)
    ks = torch.arange(voc.k, device=desc.device)
    for lv in range(voc.depth):
        child0 = node * voc.k
        c = cuda_match.unpack_bits(
            voc.centroid_bits[lv][child0[:, None] + ks[None, :]])  # [N,k,256]
        dot = (c * x[:, None, :]).sum(-1)
        d = pop_x[:, None] + c.sum(-1) - 2.0 * dot
        node = child0 + torch.argmin(d, dim=-1)
    if voc.leaf_map is not None:
        node = voc.leaf_map[node].long()
    return node.to(torch.int32)


def sparse_bow_row(voc: Vocabulary, words_np: np.ndarray,
                   valid_np: np.ndarray, cap: int):
    """Host: word ids [F] + mask -> (unique words [cap] i32, -1 padded;
    their L1-normalised tf-idf values [cap] f32)."""
    uw, counts = np.unique(words_np[valid_np], return_counts=True)
    idf = voc.idf.cpu().numpy()
    vals = counts.astype(np.float32) * idf[uw]
    s = np.abs(vals).sum()
    if s > 1e-9:
        vals = vals / s
    out_w = np.full(cap, -1, np.int32)
    out_v = np.zeros(cap, np.float32)
    n = min(len(uw), cap)
    out_w[:n] = uw[:n]
    out_v[:n] = vals[:n]
    return out_w, out_v


def dense_query(voc: Vocabulary, q_words: np.ndarray,
                q_vals: np.ndarray) -> np.ndarray:
    """Host: sparse query row -> dense [n_words] f32."""
    q = np.zeros(voc.n_words, np.float32)
    sel = q_words >= 0
    q[q_words[sel]] = q_vals[sel]
    return q


def l1_scores_sparse(q_dense: torch.Tensor, db_words: torch.Tensor,
                     db_vals: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of the query against every db row: for
    L1-normalised non-negative vectors 1 - 0.5|q - d|_1 = sum min(q, d)
    over the row's own words.  [W], [K, F], [K, F] -> [K]."""
    at = q_dense[torch.clamp(db_words, min=0).long()]
    return torch.where(db_words >= 0, torch.minimum(at, db_vals),
                       0.0).sum(-1)


def shared_words_sparse(q_dense: torch.Tensor,
                        db_words: torch.Tensor) -> torch.Tensor:
    """Count of the query's words in each db row's word set -> [K] i64."""
    present = q_dense[torch.clamp(db_words, min=0).long()] > 0
    return (present & (db_words >= 0)).sum(-1)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, equal values in
    index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def detect_candidates_grouped(scores: torch.Tensor, shared: torch.Tensor,
                              eligible: torch.Tensor, covis: torch.Tensor,
                              n_out: int = 9, n_group: int = 10):
    """Covisibility-group accumulated candidates (the reference's
    DetectNBestCandidates core): keyframes sharing >= 0.8x the most common
    words get their L1 score, accumulate the scores of their top
    ``n_group`` covisibles that share words, are represented by their
    group's best-scoring member, and groups under 0.75x the best
    accumulated score are dropped.  Returns (best_kf [n_out] i32, acc
    [n_out], ok [n_out]) ranked by accumulated score."""
    K = covis.shape[0]
    n_group = min(n_group, K)
    n_out = min(n_out, K)
    sharing = eligible & (shared > 0)
    max_common = torch.where(sharing, shared, 0).max()
    scored = sharing & (shared.to(torch.float32)
                        > 0.8 * max_common.to(torch.float32))
    s = torch.where(scored, scores, 0.0)

    nb_w, nb_idx = _top_k(covis, n_group)                  # [K, n_group]
    nb_sharing = sharing[nb_idx] & (nb_w > 0)
    acc = s + torch.where(nb_sharing, s[nb_idx], 0.0).sum(1)
    acc = torch.where(scored, acc, -torch.inf)
    member_s = torch.cat([scores[:, None],
                          torch.where(nb_sharing & scored[nb_idx],
                                      scores[nb_idx], -torch.inf)], dim=1)
    best_m = torch.argmax(member_s, dim=1)
    rows = torch.arange(K, device=covis.device)
    best_kf = torch.where(best_m == 0, rows,
                          nb_idx[rows, torch.clamp(best_m - 1, min=0)])
    ok_thresh = acc >= 0.75 * acc.max()
    ranked_acc, ranked = _top_k(torch.where(ok_thresh, acc, -torch.inf),
                                n_out)
    return (best_kf[ranked].to(torch.int32), ranked_acc,
            torch.isfinite(ranked_acc))
