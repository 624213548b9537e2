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
trainer (``native/libvocab.so``, ctypes) when it loads, else in numpy, or
read from a DBoW2 text file (``load_orbvoc_text``, the reference's
ORBvoc.txt format; ``default_vocabulary`` looks for one).
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


# ---------------------------------------------------------------------------
# DBoW2 ORBvoc.txt import / export, and the default vocabulary
# ---------------------------------------------------------------------------

def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (the reference's ORBvoc.txt format)
    into CPU tensors.

    Format: header ``k L scoring weighting``; one line per node (breadth
    order): ``parentId isLeaf b0 .. b31 weight``.  Node ids are implicit
    (1 + line index; node 0 is the root).  Word ids are assigned to leaves
    in file order (DBoW2 createWords()).  DBoW2 trees are incomplete:
    missing child slots of the complete k-ary layout are padded with a
    copy of the group's first sibling, and early leaves (a leaf above the
    bottom level) propagate their centroid down so every descent ends at
    the bottom; ``leaf_map`` folds the bottom slots back onto word ids.
    """
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]))
            descs.append([int(v) for v in parts[2:34]])
            weights.append(float(parts[34]))
    n_nodes = len(parents)
    parents = np.asarray(parents, np.int64)
    is_leaf = np.asarray(leaves, bool)
    descs = np.asarray(descs, np.uint8)
    weights = np.asarray(weights, np.float64)

    levels = [np.zeros((k ** (lv + 1), 32), np.uint8) for lv in range(L)]
    word_of_node = np.full(n_nodes + 1, -1, np.int64)
    word_of_node[1:][is_leaf] = np.arange(int(is_leaf.sum()))
    idf = weights[is_leaf].astype(np.float32)
    node_level = np.full(n_nodes + 1, -1, np.int64)   # depth of each node
    node_slot = np.full(n_nodes + 1, -1, np.int64)    # complete-tree slot
    node_slot[0] = 0
    child_count = np.zeros(n_nodes + 1, np.int64)
    leaf_map = np.full(k ** L, 0, np.int64)

    # nodes appear after their parent in the file (breadth order)
    pending_fill = []   # (level, slot, packed desc, word) of each leaf
    for i in range(n_nodes):
        nid = i + 1
        p = parents[i]
        lv = node_level[p] + 1
        ci = child_count[p]
        if ci >= k:
            raise ValueError(f"node {nid}: parent {p} has > k children")
        child_count[p] += 1
        slot = node_slot[p] * k + ci
        node_level[nid] = lv
        node_slot[nid] = slot
        levels[lv][slot] = descs[i]
        if is_leaf[i]:
            pending_fill.append((lv, slot, descs[i], word_of_node[nid]))

    # pad missing children with a copy of the group's first filled
    # sibling, which sits before the copy and so wins an exact tie
    for lv in range(L):
        cnt = k ** (lv + 1)
        filled = np.zeros(cnt, bool)
        sel = node_level[1:] == lv
        filled[node_slot[1:][sel]] = True
        groups = filled.reshape(-1, k)
        first = groups.argmax(axis=1)
        has = groups.any(axis=1)
        src_full = np.repeat(np.arange(cnt // k) * k + first, k)
        need = ~filled & np.repeat(has, k)
        levels[lv][need] = levels[lv][src_full[need]]

    # propagate early leaves down to the bottom level and build leaf_map
    bottom_filled = np.zeros(k ** L, bool)
    for lv, slot, d, w in pending_fill:
        lo, hi = slot, slot + 1
        for l2 in range(lv + 1, L):
            lo, hi = lo * k, hi * k
            levels[l2][lo:hi] = d
        leaf_map[lo:hi] = w
        bottom_filled[lo:hi] = True
    # padded bottom slots inherit their group's first real word
    groups = bottom_filled.reshape(-1, k)
    first = groups.argmax(axis=1)
    has = groups.any(axis=1)
    src_full = np.repeat(np.arange(k ** (L - 1)) * k + first, k)
    need = ~bottom_filled & np.repeat(has, k)
    leaf_map[need] = leaf_map[src_full[need]]

    return _vocabulary(levels, idf, k, L)._replace(
        leaf_map=torch.from_numpy(leaf_map.astype(np.int32)))


def save_orbvoc_text(voc: Vocabulary, path: str) -> None:
    """Export a trained (complete-tree) vocabulary in the DBoW2 text
    format, so that it round-trips through ``load_orbvoc_text`` (either
    package's)."""
    if voc.leaf_map is not None:
        raise ValueError("export of imported (remapped) vocabularies is "
                         "not supported")
    k, L = voc.k, voc.depth
    idf = voc.idf.cpu().numpy()
    lines = [f"{k} {L} 0 0"]
    # breadth order; node ids: root = 0, then level by level
    level_base = [1]
    for lv in range(L - 1):
        level_base.append(level_base[-1] + k ** (lv + 1))
    for lv in range(L):
        cents = voc.centroid_bits[lv].cpu().numpy()
        for s in range(k ** (lv + 1)):
            parent = 0 if lv == 0 else level_base[lv - 1] + s // k
            leaf = 1 if lv == L - 1 else 0
            w = float(idf[s]) if leaf else 0.0
            b = " ".join(str(int(v)) for v in cents[s])
            lines.append(f"{parent} {leaf} {b} {w:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


_DEFAULT_VOC = None


def default_vocabulary() -> Optional[Vocabulary]:
    """The vocabulary used when callers pass none: ``$MAM3_VOCAB`` (an
    ORBvoc.txt-format file) if set, else ``data/ORBvoc.txt`` in the
    repository if present, else None (the server then trains a bootstrap
    vocabulary from the stream).  Cached per process, keyed on the path,
    so a file that appears after a miss is found by the next lookup."""
    global _DEFAULT_VOC
    cand = os.environ.get("MAM3_VOCAB") or os.path.join(_REPO, "data",
                                                         "ORBvoc.txt")
    if isinstance(_DEFAULT_VOC, tuple) and _DEFAULT_VOC[0] == cand:
        return _DEFAULT_VOC[1]
    if os.path.exists(cand):
        _DEFAULT_VOC = (cand, load_orbvoc_text(cand))
        return _DEFAULT_VOC[1]
    return None
