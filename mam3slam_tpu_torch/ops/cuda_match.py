"""Match kernels: masked projection search and unmasked best-two search.

Wrappers of ``csrc/match.cu`` and their plain PyTorch versions:

* ``fused_masked_match`` replaces the Pallas kernel
  ``mam3slam_tpu/ops/pallas_match.py:fused_masked_match``: per query, the
  best and second-best Hamming distance (and the best's index) over the
  targets inside the query's radius, with level in [pred-1, pred+1], valid
  on both sides.
* ``min_hamming2`` replaces ``pallas_match.py:min_hamming2``: the same
  over every valid target, with no spatial or level mask.

Both return exact int32 (idx, d1, d2) with the semantics of
``mam3slam_tpu.ops.matching.best_in_mask``: the lowest index wins ties,
d2 is the best over the other targets (it may equal d1), and a query with
no qualifying target gets (0, BIG, BIG).  Descriptors stay packed
(u8[32]); the plain versions use the exact f32 bit-matmul identity
|a| + |b| - 2 a.b, the masked kernel XOR + popcount, the unmasked one
binary tensor-core products.  ``best_two_lanes`` and ``best_two_mma``
replay the two kernels' orders of reduction on the CPU for the tests.
"""

from __future__ import annotations

import torch

from mam3slam_tpu_torch import _build

BIG = 1 << 20


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] f32 0/1 bits (bit 8j + k = bit k of
    byte j, OpenCV order)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.float32)


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """[..., Q, 32], [..., M, 32] packed descriptors -> [..., Q, M] int32
    distances (leading axes broadcast).

    Exact: 0/1 products summed in f32 stay integers <= 256 (TF32 off)."""
    bq = unpack_bits(desc_q)
    bt = unpack_bits(desc_t)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dot = bq @ bt.transpose(-1, -2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (bq.sum(-1)[..., :, None] + bt.sum(-1)[..., None, :]
            - 2.0 * dot).to(torch.int32)


def best_two(d: torch.Tensor):
    """Best + second-best per row of a masked distance matrix [Q, M]
    (masked entries hold BIG): (idx, d1, d2) int32, first minimum wins."""
    i1 = torch.argmin(d, dim=1)
    d1 = torch.gather(d, 1, i1[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    d2 = torch.where(cols[None, :] == i1[:, None], BIG, d).amin(dim=1)
    return i1.to(torch.int32), d1.to(torch.int32), d2.to(torch.int32)


def _merge_best2(a, b):
    """The masked-match kernel's exact merge of two disjoint target sets'
    (d1, idx, d2): the lexicographically smaller (d1, idx) wins and d2 is
    the best of what it leaves."""
    take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return (torch.where(take, b[0], a[0]), torch.where(take, b[1], a[1]),
            torch.where(take, torch.minimum(a[0], b[2]),
                        torch.minimum(a[2], b[0])))


def best_two_lanes(d: torch.Tensor, tile: int = 2048):
    """``best_two`` of a masked distance matrix [Q, M] (masked entries
    hold BIG) reduced as ``csrc/match.cu:masked_match_kernel`` reduces it,
    for the tests: targets in passes of ``tile``; in a pass, target e goes
    to lane e % 32, each lane keeps the best two of its targets in
    ascending order (an empty lane holds (BIG, INT_MAX, BIG)), the lanes
    merge by an xor butterfly and the passes merge in turn, all by the
    same exact rule; idx = 0 where d1 == BIG."""
    Q, M = d.shape
    imax = torch.iinfo(torch.int32).max
    out = None
    for base in range(0, M, tile):
        dt = d[:, base:base + tile]
        n = dt.shape[1]
        pad = torch.full((Q, (-n) % 32), BIG, dtype=d.dtype,
                         device=d.device)
        # [Q * 32, S]: row (q, l) holds lane l's targets l, l + 32, ...
        dl = torch.cat([dt, pad], 1).reshape(Q, -1, 32).transpose(1, 2)
        s1, d1, d2 = (x.reshape(Q, 32)
                      for x in best_two(dl.reshape(Q * 32, -1)))
        lane = torch.arange(32, device=d.device)
        idx = torch.where(d1 < BIG, base + s1 * 32 + lane, imax)
        best = (d1, idx, d2)
        for o in (16, 8, 4, 2, 1):
            best = _merge_best2(best, tuple(x[:, lane ^ o] for x in best))
        best = tuple(x[:, 0] for x in best)
        out = best if out is None else _merge_best2(out, best)
    d1, idx, d2 = out
    return (torch.where(d1 < BIG, idx, 0).to(torch.int32), d1.to(torch.int32),
            d2.to(torch.int32))


def best_two_mma(d: torch.Tensor):
    """``best_two`` of a masked distance matrix [Q, M] (masked entries
    hold BIG) reduced as ``csrc/match.cu:best2_mma_kernel`` reduces it,
    for the tests: the targets in tiles of 8; warp w of 16 takes the
    tiles w, w + 16, ... in ascending order (the kernel's chunks of 8
    tiles do not change that order); lane group t (= lane % 4) owns
    columns 2t and 2t + 1 of each tile and keeps the best two of its
    columns in ascending order (an empty lane holds (BIG, INT_MAX, BIG));
    the 4 lanes of a row merge by an xor butterfly, then the warps in
    turn, all by the exact rule; idx = 0 where d1 == BIG."""
    Q, M = d.shape
    warps = 16                      # kB2Warps
    imax = torch.iinfo(torch.int32).max
    rounds = -(-M // (8 * warps))
    pad = torch.full((Q, rounds * 8 * warps - M), BIG, dtype=d.dtype,
                     device=d.device)
    # column 8 (r warps + w) + 2t + c -> [Q, warp, lane group, (round, c)]
    dl = torch.cat([d, pad], 1).reshape(Q, rounds, warps, 4, 2)
    dl = dl.permute(0, 2, 3, 1, 4).reshape(Q * warps * 4, rounds * 2)
    s1, d1, d2 = (x.reshape(Q, warps, 4) for x in best_two(dl))
    w = torch.arange(warps, device=d.device)[:, None]
    t = torch.arange(4, device=d.device)
    col = 8 * ((s1 // 2) * warps + w) + 2 * t + s1 % 2
    best = (d1, torch.where(d1 < BIG, col, imax), d2)
    for o in (1, 2):
        best = _merge_best2(best, tuple(x[:, :, t ^ o] for x in best))
    best = tuple(x[:, :, 0] for x in best)
    out = tuple(x[:, 0] for x in best)
    for k in range(1, warps):
        out = _merge_best2(out, tuple(x[:, k] for x in best))
    d1, idx, d2 = out
    return (torch.where(d1 < BIG, idx, 0).to(torch.int32), d1.to(torch.int32),
            d2.to(torch.int32))


def radius_mask(query_uv, target_uv, radius) -> torch.Tensor:
    """[Q, 2], [M, 2], radius [Q] -> bool [Q, M]: |q - t|^2 <= r^2."""
    d2 = torch.sum((query_uv[:, None, :] - target_uv[None, :, :]) ** 2, -1)
    return d2 <= (radius[:, None] ** 2)


def level_window_mask(pred_level, target_level, lo: int = 0, hi: int = 1):
    """Target level in [pred - lo, pred + hi]."""
    lv = target_level[None, :]
    pl = pred_level[:, None]
    return (lv >= pl - lo) & (lv <= pl + hi)


def fused_masked_match_plain(desc_q, q_uv, q_radius, q_level, q_valid,
                             desc_t, t_uv, t_level, t_valid):
    _build.count_plain("masked_match")
    mask = (radius_mask(q_uv, t_uv, q_radius)
            & level_window_mask(q_level, t_level, 1, 1)
            & q_valid[:, None] & t_valid[None, :])
    return best_two(torch.where(mask, hamming_matrix(desc_q, desc_t), BIG))


def min_hamming2_plain(desc_q, q_valid, desc_t, t_valid):
    _build.count_plain("min_hamming2")
    mask = q_valid[:, None] & t_valid[None, :]
    return best_two(torch.where(mask, hamming_matrix(desc_q, desc_t), BIG))


def _words(desc: torch.Tensor, name: str) -> torch.Tensor:
    """[N, 32] u8 -> [N, 8] int32 view (the kernels read u32 words)."""
    _build.check(desc, name, torch.uint8, (None, 32))
    if desc.data_ptr() % 16:
        desc = desc.clone()
    return desc.view(torch.int32)


def fused_masked_match(desc_q, q_uv, q_radius, q_level, q_valid,
                       desc_t, t_uv, t_level, t_valid):
    """Masked best-two Hamming search.  desc_q [Q, 32] u8, q_uv [Q, 2]
    f32, q_radius [Q] f32, q_level [Q] i32, q_valid [Q] bool; the same
    for the M targets (no radius).  Returns (idx, d1, d2) int32 [Q]."""
    args = (desc_q, q_uv, q_radius, q_level, q_valid,
            desc_t, t_uv, t_level, t_valid)
    if not _build.is_cuda(*args):
        return fused_masked_match_plain(*args)
    Q, M = desc_q.shape[0], desc_t.shape[0]
    wq, wt = _words(desc_q, "desc_q"), _words(desc_t, "desc_t")
    _build.check(q_uv, "q_uv", torch.float32, (Q, 2))
    _build.check(q_radius, "q_radius", torch.float32, (Q,))
    _build.check(q_level, "q_level", torch.int32, (Q,))
    _build.check(q_valid, "q_valid", torch.bool, (Q,))
    _build.check(t_uv, "t_uv", torch.float32, (M, 2))
    _build.check(t_level, "t_level", torch.int32, (M,))
    _build.check(t_valid, "t_valid", torch.bool, (M,))
    idx, d1, d2 = (torch.empty(Q, dtype=torch.int32, device=desc_q.device)
                   for _ in range(3))
    if Q:
        _build.launch("mam3_masked_match", wq.data_ptr(), q_uv.data_ptr(),
                      q_radius.data_ptr(), q_level.data_ptr(),
                      q_valid.data_ptr(), Q, wt.data_ptr(), t_uv.data_ptr(),
                      t_level.data_ptr(), t_valid.data_ptr(), M,
                      idx.data_ptr(), d1.data_ptr(), d2.data_ptr())
    return idx, d1, d2


def min_hamming2(desc_q, q_valid, desc_t, t_valid):
    """Unmasked best-two Hamming search of every valid query over every
    valid target.  Returns (idx, d1, d2) int32 [Q]."""
    if not _build.is_cuda(desc_q, q_valid, desc_t, t_valid):
        return min_hamming2_plain(desc_q, q_valid, desc_t, t_valid)
    Q, M = desc_q.shape[0], desc_t.shape[0]
    wq, wt = _words(desc_q, "desc_q"), _words(desc_t, "desc_t")
    _build.check(q_valid, "q_valid", torch.bool, (Q,))
    _build.check(t_valid, "t_valid", torch.bool, (M,))
    idx, d1, d2 = (torch.empty(Q, dtype=torch.int32, device=desc_q.device)
                   for _ in range(3))
    if Q:
        _build.launch("mam3_min_hamming2", wq.data_ptr(), q_valid.data_ptr(),
                      Q, wt.data_ptr(), t_valid.data_ptr(), M,
                      idx.data_ptr(), d1.data_ptr(), d2.data_ptr())
    return idx, d1, d2
