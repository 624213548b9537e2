"""Segment sums in a fixed order: the solvers' float sums over an index.

Wrapper of ``csrc/segsum.cu`` and its plain PyTorch version.  No Pallas
kernel matches it: the reference's solvers reduce per-edge rows onto
vertices with one-hot matmuls (``mam3slam_tpu/solvers/ba_window.py``)
or XLA scatters, whose order on the CPU is fixed.  On the card an
``index_add_`` sums duplicate indices with atomics in an order that
changes from run to run, so the same inputs could round otherwise and
the map split between runs.  Here every sum takes one order, whatever
the grid, the stream or the timing:

* ``segment_plan(index, n_out)`` is built once per solve, since the
  index (an edge's camera, point or vertex pair) stays fixed over its LM
  iterations: a stable sort of the index gives the rows of each output
  row (a segment) in their original order.  Rows whose index lies
  outside ``[0, n_out)`` are the caller's scratch rows and are summed
  nowhere.
* ``segment_sum(plan, vals)`` sums ``vals [E, ...]`` into
  ``[n_out, ...]``: in segment s, lane l of 32 adds the segment's rows
  l, l + 32, l + 64, ... in turn, starting from 0; then the lanes fold
  as ``x[:off] + x[off:2 off]`` for off = 16, 8, 4, 2, 1.  The sums are
  carried in float64 and rounded once to the values' dtype, so a float32
  segment sum is the correctly rounded sum of its rows but where that
  lies within ~1e-9 of a rounding boundary: the result barely depends on
  the order at all.  Rows no segment holds are 0.

The plain version sums in exactly that order, so the two agree bit for
bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mam3slam_tpu_torch import _build

LANES = 32


class SegmentPlan(NamedTuple):
    """The rows of every non-empty output row, in order.  S = min(E,
    n_out) segments at most: segment s holds sorted positions
    ``[start[s], end[s])`` and writes output row ``key[s]``; a segment
    past the last non-empty one is empty (``start == end``)."""

    perm: torch.Tensor    # [E] i32 input rows by (index, row); dropped last
    start: torch.Tensor   # [S] i32
    end: torch.Tensor     # [S] i32
    key: torch.Tensor     # [S] i32 output row, -1 for an empty segment
    n_out: int


def segment_plan(index: torch.Tensor, n_out: int) -> SegmentPlan:
    """The plan of summing rows by ``index [E]`` into ``n_out`` rows; rows
    with an index outside ``[0, n_out)`` are dropped.  Integer ops only,
    with no host read."""
    idx = index.reshape(-1).long()
    E, dev = idx.shape[0], idx.device
    S = min(E, n_out)
    key = torch.where((idx >= 0) & (idx < n_out), idx, n_out)
    sk, perm = torch.sort(key, stable=True)
    kept = sk < n_out
    head = kept.clone()
    head[1:] &= sk[1:] != sk[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    pos = torch.arange(E, device=dev)
    n_kept = kept.sum()
    # each head writes its position to its segment (the others to a
    # scratch entry S, dropped)
    start = torch.full((S + 1,), 0, dtype=torch.int64, device=dev)
    start[torch.where(head, seg, S)] = pos
    used = torch.arange(S, device=dev) < head.sum()
    start = torch.where(used, start[:S], n_kept)
    end = torch.cat([start[1:], n_kept[None]]) if S else start
    seg_key = torch.where(used, sk[torch.clamp(start, max=max(E - 1, 0))],
                          -1) if S else start
    i32 = torch.int32
    return SegmentPlan(perm=perm.to(i32), start=start.to(i32),
                       end=end.to(i32), key=seg_key.to(i32), n_out=n_out)


def segment_sum(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """``vals [E, ...]`` summed by the plan into ``[n_out, ...]``: CUDA
    tensors launch ``csrc/segsum.cu``, CPU tensors take the plain
    version; both in the order the module docstring gives."""
    if not _build.is_cuda(vals, plan.perm):
        return segment_sum_plain(plan, vals)
    E = plan.perm.shape[0]
    if vals.shape[0] != E:
        raise ValueError(f"segment_sum: {vals.shape[0]} rows, plan of {E}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_sum: dtype {vals.dtype}")
    flat = vals.reshape(E, math.prod(vals.shape[1:])).contiguous()
    C, S = flat.shape[1], plan.start.shape[0]
    out = torch.zeros((plan.n_out, C), dtype=vals.dtype, device=vals.device)
    if S and C:
        for name, t in (("perm", plan.perm), ("start", plan.start),
                        ("end", plan.end), ("key", plan.key)):
            _build.check(t, name, torch.int32, (E if name == "perm" else S,))
        _build.launch("mam3_segsum", flat.data_ptr(),
                      int(vals.dtype == torch.float64), C,
                      plan.perm.data_ptr(), plan.start.data_ptr(),
                      plan.end.data_ptr(), plan.key.data_ptr(), S,
                      out.data_ptr())
    return out.reshape((plan.n_out,) + vals.shape[1:])


def segment_sum_plain(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``segment_sum`` in the kernel's order.  Segments are
    taken in groups of one padded width: a segment of n <= 32 rows fills
    lanes 0..n-1 (the other lanes hold 0, and x + 0 = x for every lane
    sum, which is never -0), so it folds from the least power of two >=
    n; a longer one sums its chunks of 32 in turn (absent rows add 0; the
    chunk count padded to a power of two), then folds all 32 lanes; all
    in float64, rounded once at the end."""
    _build.count_plain("segsum")
    E = plan.perm.shape[0]
    flat = vals.reshape(E, math.prod(vals.shape[1:]))
    C = flat.shape[1]
    out = torch.zeros((plan.n_out, C), dtype=vals.dtype, device=vals.device)
    used = torch.nonzero(plan.end > plan.start)[:, 0]
    if used.numel() == 0 or C == 0:
        return out.reshape((plan.n_out,) + vals.shape[1:])
    start = plan.start[used].long()
    length = plan.end[used].long() - start
    chunks = (length + LANES - 1) // LANES
    width = torch.where(
        length <= LANES, 1 << torch.ceil(torch.log2(length.double())).long(),
        LANES << torch.ceil(torch.log2(chunks.double())).long())
    order = torch.argsort(width, stable=True)
    widths, counts = torch.unique_consecutive(width[order],
                                              return_counts=True)
    perm = plan.perm.long()
    first = 0
    for wd, n in zip(widths.tolist(), counts.tolist()):
        sel = order[first:first + n]
        first += n
        j = torch.arange(wd, device=vals.device)
        if wd > LANES:   # [n, chunk, lane]: row = start + 32 chunk + lane
            j = j.reshape(wd // LANES, LANES)
        shape = (-1,) + (1,) * j.dim()
        at = start[sel].reshape(shape) + j
        ok = j < length[sel].reshape(shape)
        x = torch.where(ok[..., None], flat[perm[torch.clamp(
            at, max=E - 1)]].double(), 0.0)
        if wd > LANES:
            acc = torch.zeros_like(x[:, 0])
            for k in range(x.shape[1]):
                acc = acc + x[:, k]
            x = acc
        else:
            x = x + 0.0         # the lane sums start from 0, as the kernel's
        off = min(wd, LANES) // 2
        while off:
            x = x[:, :off] + x[:, off:2 * off]
            off //= 2
        out[plan.key[used[sel]].long()] = x[:, 0].to(vals.dtype)
    return out.reshape((plan.n_out,) + vals.shape[1:])
