"""Operations and bytes of each of the program's hand-written kernels, and
the card's published peaks.

Copied from ``chip_smoke.py`` at commit 5e65ee5 (``masked_work``,
``best2_work``, ``describe_work``, ``POSE_OPS`` / ``pose_work``,
``bound_ms``, ``segsum_work`` and the peaks above them), rewritten to
take the arguments and results of one recorded launch as plain tensors,
with the masks and taps computed here (``radius_mask`` and
``level_window_mask`` are copies of ``mam3slam_tpu_torch/ops/
cuda_match.py``'s; the describe taps are ``ref/orb.py``'s).  It imports
nothing of the program.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: f32 (and
f64) on the CUDA cores, where every SIMT op of a kernel is counted; int8
on the tensor cores (the rate of a binary AND-popc product); HBM3.
"""

from __future__ import annotations

import math

import torch

from slambench.ref import orb as ref_orb

F32_OPS = 67e12
F64_OPS = 34e12
INT8_TC_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, rate: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    their peak rate and bytes over the memory rate, in seconds."""
    return max(ops / rate, nbytes / HBM_BYTES_PER_S)


def radius_mask(query_uv, target_uv, radius) -> torch.Tensor:
    d2 = torch.sum((query_uv[:, None, :] - target_uv[None, :, :]) ** 2, -1)
    return d2 <= (radius[:, None] ** 2)


def level_window_mask(pred_level, target_level, lo: int = 0, hi: int = 1):
    lv = target_level[None, :]
    pl = pred_level[:, None]
    return (lv >= pl - lo) & (lv <= pl + hi)


def masked_work(quv, rad, ql, qv, tuv, tl, tv):
    """8 SIMT ops per (valid query, valid target) pair (2 level compares;
    dx, dy, 2 mul, add, compare), 24 per pair inside the mask (8 XOR,
    8 popc, 8 add); each valid query's 48-byte record and each valid
    target's 44 bytes read once, every valid flag read, 12 bytes written
    per query."""
    mask = (radius_mask(quv, tuv, rad) & level_window_mask(ql, tl, 1, 1)
            & qv[:, None] & tv[None, :])
    nq, nqv, nt, ntv = len(qv), int(qv.sum()), len(tv), int(tv.sum())
    return (8 * nqv * ntv + 24 * int(mask.sum()), F32_OPS,
            nq + 48 * nqv + nt + 44 * ntv + 12 * nq)


def best2_work(qv, tv):
    """2 ops (AND, popc-add) per bit of each (valid query, valid target)
    pair at the int8 tensor-core rate; descriptors of the valid rows and
    every flag read once, 12 bytes written per query."""
    nq, nqv, nt, ntv = len(qv), int(qv.sum()), len(tv), int(tv.sum())
    return (2 * 256 * nqv * ntv, INT8_TC_OPS,
            nq + 32 * nqv + nt + 32 * ntv + 12 * nq)


def describe_work(shape, xy, lvl, hw, angle):
    """Per keypoint 749 raw pixels of the r=15 circle (4 ops each) and 512
    blurred taps (8 ops each); each distinct f32 pixel the keypoints
    touch read once, the 4 KB pattern, 20 bytes of keypoint in and 36
    out."""
    n = len(xy)
    pixels = (ref_orb.ic_taps(xy, lvl, shape)[0].unique().numel()
              + ref_orb.brief_taps(xy, lvl, hw, angle, shape).unique().numel())
    return (n * (749 * 4 + 512 * 8), F32_OPS,
            4 * pixels + ref_orb.load_pattern().nbytes + n * (20 + 36))


# f32 ops an edge of a pose linearisation and of a projection + chi2:
# pinhole (kind 0); KB8 (kind 1)
POSE_OPS = {0: (150, 35), 1: (250, 75)}


def pose_work(n_valid: int, n_in: int, n: int, kind: int = 0,
              rounds: int = 4, iters: int = 5):
    """Round 0 linearises the valid edges iters + 1 times; each later round
    classifies the valid edges and linearises its active ones (counted as
    the returned inliers) iters + 1 times; a last chi2 pass; each edge's
    25 bytes read and its flag written, 60 bytes of pose and camera in,
    32 out."""
    lin, chi2 = POSE_OPS[kind]
    ops = ((iters + 1) * n_valid * lin
           + (rounds - 1) * ((iters + 1) * n_in * lin
                             + (n_valid - n_in) * chi2)
           + n_valid * chi2)
    return ops, F32_OPS, 26 * n + 92


def segsum_work(start, end, n_out: int, vals_shape, vals_dtype):
    """An add per kept value and 31 per used segment and column (the lane
    fold); each kept row's values and its sorted index read once, the
    segment table read once, each output row written once."""
    C = math.prod(vals_shape[1:])
    es = torch.empty((), dtype=vals_dtype).element_size()
    length = end - start
    kept, used = int(length.sum()), int((length > 0).sum())
    return (kept * C + 31 * used * C,
            F32_OPS if vals_dtype == torch.float32 else F64_OPS,
            kept * (C * es + 4) + 12 * start.shape[0] + n_out * C * es)
