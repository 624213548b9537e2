"""ORB descriptor matching on torch tensors.

Port of ``mam3slam_tpu.ops.matching``: dense masked matching over packed
u8[32] descriptors, the 30-bin rotation-consistency histogram, one-to-one
resolution of duplicate claims, and the search routines of tracking
(projection, brute force: the kernels of ``ops/cuda_match.py``) and of
initialisation and mapping (windowed initial matching, epipolar search:
plain PyTorch, as in the reference, whose masks these kernels do not
take).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mam3slam_tpu_torch.ops import cuda_match

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
BIG = cuda_match.BIG

hamming_matrix = cuda_match.hamming_matrix
radius_mask = cuda_match.radius_mask
level_window_mask = cuda_match.level_window_mask


class MatchResult(NamedTuple):
    """Per-query best match into a target feature set."""

    idx: torch.Tensor    # [Q] int32 target index (undefined where not ok)
    dist: torch.Tensor   # [Q] int32 best Hamming distance
    dist2: torch.Tensor  # [Q] int32 second-best distance
    ok: torch.Tensor     # [Q] bool


def best_in_mask(ham: torch.Tensor, mask: torch.Tensor,
                 max_dist: int = TH_HIGH) -> MatchResult:
    """Best + second-best target per query within a candidate mask."""
    i1, d1, d2 = cuda_match.best_two(torch.where(mask, ham, BIG))
    return MatchResult(idx=i1, dist=d1, dist2=d2, ok=d1 <= max_dist)


def rotation_consistency_mask(angle_q, angle_t, idx, ok) -> torch.Tensor:
    """Keep matches in the 3 most populated bins of the 30-bin histogram of
    angle differences (reference ComputeThreeMaxima)."""
    diff = angle_q - angle_t[idx.long()]
    x = diff / (2.0 * math.pi)
    # floor-mod 1.0 with fmod's exact remainder (the reference's `% 1.0`)
    frac = torch.fmod(x, 1.0)
    frac = torch.where(frac < 0, frac + 1.0, frac)
    bins = torch.clamp((frac * HISTO_BINS + 0.5).to(torch.int32) % HISTO_BINS,
                       0, HISTO_BINS - 1).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=ok.device)
    hist.index_add_(0, bins, ok.to(torch.int32))
    top3 = torch.sort(hist, descending=True).values[:3]
    keep = torch.stack([
        top3[0],
        torch.where(top3[1] > 0.1 * top3[0], top3[1], BIG),
        torch.where(top3[2] > 0.1 * top3[0], top3[2], BIG),
    ])
    good = ((hist[:, None] == keep[None, :]).any(dim=1)) & (hist > 0)
    return ok & good[bins]


def resolve_duplicates(res: MatchResult, num_targets: int) -> MatchResult:
    """One-to-one: of several queries claiming one target keep the lowest
    distance, ties to the lowest query index."""
    dev = res.idx.device
    idx = res.idx.long()
    d = torch.where(res.ok, res.dist, BIG)
    best = torch.full((num_targets,), BIG, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, idx, d, "amin")
    q = torch.arange(idx.shape[0], dtype=torch.int32, device=dev)
    is_best = res.ok & (d == best[idx])
    claim = torch.full((num_targets,), 1 << 30, dtype=torch.int32, device=dev)
    claim = claim.scatter_reduce(0, idx, torch.where(is_best, q, 1 << 30),
                                 "amin")
    return res._replace(ok=is_best & (claim[idx] == q))


def _ratio_ok(res: MatchResult, ratio: float) -> torch.Tensor:
    return res.ok & (res.dist.to(torch.float32)
                     <= ratio * res.dist2.to(torch.float32))


def search_by_projection_frame(pred_uv, pred_level, pred_radius, desc_q,
                               valid_q, feat_uv, feat_level, desc_f, valid_f,
                               max_dist: int = TH_HIGH,
                               ratio: Optional[float] = None) -> MatchResult:
    """Guided projection search of map points into a frame (reference
    SearchByProjection): radius + level window [pred-1, pred+1] + validity,
    best/second-best through ``cuda_match.fused_masked_match``, then the
    distance and ratio tests and one-to-one resolution."""
    idx, d1, d2 = cuda_match.fused_masked_match(
        desc_q, pred_uv, pred_radius, pred_level, valid_q,
        desc_f, feat_uv, feat_level, valid_f)
    res = MatchResult(idx=idx, dist=d1, dist2=d2, ok=d1 <= max_dist)
    if ratio is not None:
        res = res._replace(ok=_ratio_ok(res, ratio))
    return resolve_duplicates(res, feat_uv.shape[0])


def search_by_brute_force(desc_q, valid_q, angle_q, desc_t, valid_t, angle_t,
                          max_dist: int = TH_LOW, ratio: float = 0.75,
                          check_rotation: bool = True,
                          mutual: bool = True) -> MatchResult:
    """Dense descriptor matching with ratio, mutual-best and rotation
    checks (the role of the reference's SearchByBoW); both directions run
    ``cuda_match.min_hamming2``."""
    idx, d1, d2 = cuda_match.min_hamming2(desc_q, valid_q, desc_t, valid_t)
    res = MatchResult(idx=idx, dist=d1, dist2=d2, ok=d1 <= max_dist)
    ok = _ratio_ok(res, ratio)
    if mutual:
        b_idx, b_d1, _ = cuda_match.min_hamming2(desc_t, valid_t, desc_q,
                                                 valid_q)
        q = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
        i = idx.long()
        ok = ok & (b_d1[i] <= max_dist) & (b_idx[i] == q)
    res = res._replace(ok=ok)
    if check_rotation:
        res = res._replace(
            ok=rotation_consistency_mask(angle_q, angle_t, res.idx, res.ok))
    return resolve_duplicates(res, desc_t.shape[0])


def search_for_initialization(uv1, desc1, angle1, valid1,
                              uv2, desc2, angle2, valid2,
                              window: float = 100.0, ratio: float = 0.9,
                              check_rotation: bool = True) -> MatchResult:
    """Windowed first-to-second-frame matching for monocular
    initialisation (reference SearchForInitialization): a ``window``-pixel
    radius and no level window, TH_LOW, ratio and rotation tests."""
    ham = hamming_matrix(desc1, desc2)
    radius = torch.full((uv1.shape[0],), window, dtype=uv1.dtype,
                        device=uv1.device)
    mask = (radius_mask(uv1, uv2, radius)
            & valid1[:, None] & valid2[None, :])
    res = best_in_mask(ham, mask, TH_LOW)
    res = res._replace(ok=_ratio_ok(res, ratio))
    if check_rotation:
        res = res._replace(
            ok=rotation_consistency_mask(angle1, angle2, res.idx, res.ok))
    return resolve_duplicates(res, uv2.shape[0])


def epipolar_distance_sq(uv1, uv2, F12) -> torch.Tensor:
    """Squared distance of every kp2 to the epipolar line of every kp1:
    uv1 [N, 2], uv2 [..., M, 2], F12 [..., 3, 3] with x2^T F12 x1 = 0
    -> [..., N, M]."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    lines = x1 @ F12.transpose(-1, -2)                     # [..., N, 3]
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * uv2[..., None, :, 0] + b * uv2[..., None, :, 1] + c
    return (num * num) / torch.clamp(a * a + b * b, min=1e-12)


def search_for_triangulation(uv1, desc1, level1, valid1,
                             uv2, desc2, level2, valid2,
                             F12, sigma2_per_level,
                             max_dist: int = TH_LOW,
                             epi_chi2: float = 3.84) -> MatchResult:
    """Epipolar-constrained matching for new map points (reference
    SearchForTriangulation): a candidate lies within a level-scaled band
    of the epipolar line.  The second frame may carry a leading batch
    axis (``uv2 [B, M, 2]``, ``F12 [B, 3, 3]``, ...): each of the B
    frames is searched on its own and the results are [B, N]."""
    batched = F12.dim() == 3
    if not batched:
        uv2, desc2, level2, valid2, F12 = (
            x[None] for x in (uv2, desc2, level2, valid2, F12))
    B, T = uv2.shape[:2]
    N = uv1.shape[0]
    ham = hamming_matrix(desc1, desc2)                     # [B, N, T]
    epi2 = epipolar_distance_sq(uv1, uv2, F12)
    sig2 = sigma2_per_level[level2.long()]
    mask = ((epi2 < epi_chi2 * sig2[:, None, :])
            & valid1[None, :, None] & valid2[:, None, :])
    res = best_in_mask(ham.reshape(B * N, T), mask.reshape(B * N, T),
                       max_dist)
    # one-to-one within each frame: offset the targets by frame
    off = (torch.arange(B, dtype=torch.int32, device=uv1.device)
           * T).repeat_interleave(N)
    res = resolve_duplicates(res._replace(idx=res.idx + off), B * T)
    res = MatchResult(*(x.reshape(B, N) for x in
                        res._replace(idx=res.idx - off)))
    return res if batched else MatchResult(*(x[0] for x in res))
