"""Struct-of-arrays map state: keyframes, map points, observations, graph.

Port of ``mam3slam_tpu.mapstate.state``: the same ``MapState`` fields,
shapes and dtypes, as torch tensors on one device, and its mutators.
Mutators return a new ``MapState`` and leave the one they were given
unchanged (the tracking step keeps the map it read beside the one it
returns); a tensor they change is copied first.  Where the reference
routes no-op scatter rows to slot ``P - 1`` and writes the old value
back, the port writes them to a scratch row past the arena and drops it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import matching as M

NO_MP = -1
NO_KF = -1
BIG_SEQ = 1 << 30  # kf_seq of a free slot


@dataclass(frozen=True)
class MapConfig:
    max_kf: int = 512
    max_mp: int = 24576
    n_feat: int = 768
    max_obs: int = 16
    max_maps: int = 8
    max_loop_edges: int = 64
    n_levels: int = 8
    scale_factor: float = 1.2


class MapState(NamedTuple):
    """The shared multi-map arena (field meanings as in the reference)."""

    # keyframes
    kf_q: torch.Tensor             # [K, 4] T_cw rotation
    kf_t: torch.Tensor             # [K, 3]
    kf_valid: torch.Tensor         # [K] bool
    kf_agent: torch.Tensor         # [K] i32
    kf_map: torch.Tensor           # [K] i32
    kf_ts: torch.Tensor            # [K] f32
    kf_parent: torch.Tensor        # [K] i32 spanning-tree parent
    kf_agent_kf_id: torch.Tensor   # [K] i32
    kf_seq: torch.Tensor           # [K] i32 insertion sequence / BIG_SEQ
    kf_cam: torch.Tensor           # [K, 8] f32
    # per-KF features
    kf_feat_uv: torch.Tensor       # [K, F, 2] f32
    kf_feat_level: torch.Tensor    # [K, F] i32
    kf_feat_angle: torch.Tensor    # [K, F] f32
    kf_feat_desc: torch.Tensor     # [K, F, 32] u8
    kf_feat_valid: torch.Tensor    # [K, F] bool
    kf_feat_mp: torch.Tensor       # [K, F] i32 -> mp slot or -1
    # map points
    mp_pos: torch.Tensor           # [P, 3] f32
    mp_valid: torch.Tensor         # [P] bool
    mp_map: torch.Tensor           # [P] i32
    mp_desc: torch.Tensor          # [P, 32] u8
    mp_normal: torch.Tensor        # [P, 3] f32
    mp_min_dist: torch.Tensor      # [P] f32
    mp_max_dist: torch.Tensor      # [P] f32
    mp_first_agent: torch.Tensor   # [P] i32
    mp_first_agent_kf: torch.Tensor  # [P] i32
    mp_ref_kf: torch.Tensor        # [P] i32
    mp_first_kf: torch.Tensor      # [P] i32
    mp_found: torch.Tensor         # [P] f32
    mp_visible: torch.Tensor       # [P] f32
    # reverse observations
    mp_obs_kf: torch.Tensor        # [P, M] i32
    mp_obs_feat: torch.Tensor      # [P, M] i32
    mp_nobs: torch.Tensor          # [P] i32
    # graph
    covis: torch.Tensor            # [K, K] i32
    loop_i: torch.Tensor           # [L] i32
    loop_j: torch.Tensor           # [L] i32
    loop_valid: torch.Tensor       # [L] bool
    # counters / maps
    n_kf: torch.Tensor             # [] i32
    map_valid: torch.Tensor        # [Mmax] bool
    map_change: torch.Tensor       # [Mmax] i32


def init_map_state(cfg: MapConfig,
                   device=torch.device("cuda")) -> MapState:
    K, F, P, M = cfg.max_kf, cfg.n_feat, cfg.max_mp, cfg.max_obs
    i32, f32 = torch.int32, torch.float32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    kf_q = full((K, 4), 0.0, f32)
    kf_q[:, 0] = 1.0
    return MapState(
        kf_q=kf_q, kf_t=full((K, 3), 0.0, f32),
        kf_valid=full((K,), False, torch.bool),
        kf_agent=full((K,), -1, i32), kf_map=full((K,), -1, i32),
        kf_ts=full((K,), 0.0, f32), kf_parent=full((K,), NO_KF, i32),
        kf_agent_kf_id=full((K,), -1, i32), kf_seq=full((K,), BIG_SEQ, i32),
        kf_cam=full((K, 8), 0.0, f32),
        kf_feat_uv=full((K, F, 2), 0.0, f32),
        kf_feat_level=full((K, F), 0, i32),
        kf_feat_angle=full((K, F), 0.0, f32),
        kf_feat_desc=full((K, F, 32), 0, torch.uint8),
        kf_feat_valid=full((K, F), False, torch.bool),
        kf_feat_mp=full((K, F), NO_MP, i32),
        mp_pos=full((P, 3), 0.0, f32), mp_valid=full((P,), False, torch.bool),
        mp_map=full((P,), -1, i32), mp_desc=full((P, 32), 0, torch.uint8),
        mp_normal=full((P, 3), 0.0, f32), mp_min_dist=full((P,), 0.0, f32),
        mp_max_dist=full((P,), 0.0, f32), mp_first_agent=full((P,), -1, i32),
        mp_first_agent_kf=full((P,), -1, i32),
        mp_ref_kf=full((P,), NO_KF, i32), mp_first_kf=full((P,), NO_KF, i32),
        mp_found=full((P,), 0.0, f32), mp_visible=full((P,), 0.0, f32),
        mp_obs_kf=full((P, M), NO_KF, i32), mp_obs_feat=full((P, M), -1, i32),
        mp_nobs=full((P,), 0, i32), covis=full((K, K), 0, i32),
        loop_i=full((cfg.max_loop_edges,), NO_KF, i32),
        loop_j=full((cfg.max_loop_edges,), NO_KF, i32),
        loop_valid=full((cfg.max_loop_edges,), False, torch.bool),
        n_kf=full((), 0, i32), map_valid=full((cfg.max_maps,), False,
                                              torch.bool),
        map_change=full((cfg.max_maps,), 0, i32),
    )


def set_at(x: torch.Tensor, index, values) -> torch.Tensor:
    """Copy of ``x`` with ``x[index] = values``."""
    y = x.clone()
    y[index] = values
    return y


def set_rows(x: torch.Tensor, rows, values) -> torch.Tensor:
    """Copy of ``x`` with ``x[rows] = values``, where a row index equal to
    ``len(x)`` lands in a scratch row that is dropped."""
    y = torch.cat([x, x[:1]])
    y[rows] = values
    return y[:x.shape[0]]


def _rank_in_runs(key: torch.Tensor) -> torch.Tensor:
    """For each entry, the number of earlier entries (by index) with the
    same key: a stable sort, then each run's start carried by cummax."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    idx = torch.arange(key.shape[0], device=key.device)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    run_start = torch.cummax(torch.where(start, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return rank


def alloc_mp_slots(ms: MapState, want: torch.Tensor):
    """(slots, granted) for map-point slot requests ``want [N]``: request
    i gets the rank(i)-th free slot, lowest first; requests past the free
    capacity are not granted (the caller drops them)."""
    P = ms.mp_valid.shape[0]
    free_first = torch.argsort(ms.mp_valid.to(torch.int32), stable=True)
    ranks = torch.cumsum(want.to(torch.int32), 0) - 1
    granted = want & (ranks < (~ms.mp_valid).sum())
    return (free_first[torch.clamp(ranks, 0, P - 1)].to(torch.int32),
            granted)


def mp_add_observation(ms: MapState, mp, kf, feat, ok) -> MapState:
    """Batch-add reverse + forward observations (mp/kf/feat [N], ok mask).
    Several observations of one point in a batch take consecutive
    reverse slots in batch order; only ``ok`` rows write.  Slots clamp at
    ``M - 1``, so observations of a point at or near ``M`` can land on one
    reverse slot: the last of them in batch order writes it (as the
    reference's ordered scatter does), the others go to the scratch row.
    The callers give distinct (kf, feat) pairs (a keyframe's own feature
    table, a one-to-one match or fuse), so the forward writes never
    collide."""
    P, M = ms.mp_obs_kf.shape
    K = ms.kf_feat_mp.shape[0]
    mp, kf, feat = mp.long(), kf.long(), feat.long()
    before = _rank_in_runs(torch.where(ok, mp, P))
    slot = torch.clamp(ms.mp_nobs[mp] + before, 0, M - 1)
    cell = torch.where(ok, mp * M + slot, P * M)
    later = _rank_in_runs(cell.flip(0)).flip(0)
    row = torch.where(ok & (later == 0), mp, P)
    obs_kf = torch.cat([ms.mp_obs_kf, ms.mp_obs_kf[:1]])
    obs_kf[row, slot] = kf.to(torch.int32)
    obs_feat = torch.cat([ms.mp_obs_feat, ms.mp_obs_feat[:1]])
    obs_feat[row, slot] = feat.to(torch.int32)
    nobs = ms.mp_nobs.clone()
    nobs.index_add_(0, mp, ok.to(torch.int32))
    fmp = torch.cat([ms.kf_feat_mp, ms.kf_feat_mp[:1]])
    fmp[torch.where(ok, kf, K), feat] = mp.to(torch.int32)
    return ms._replace(mp_obs_kf=obs_kf[:P], mp_obs_feat=obs_feat[:P],
                       mp_nobs=torch.clamp(nobs, max=M), kf_feat_mp=fmp[:K])


def covis_row(ms: MapState, kf) -> torch.Tensor:
    """Covisibility weights of one KF against all: |shared map points|."""
    P = ms.mp_pos.shape[0]
    mps = ms.kf_feat_mp[kf].long()
    member = torch.zeros(P + 1, dtype=torch.int32, device=mps.device)
    member[torch.where(mps >= 0, mps, P)] = 1
    member[P] = 0
    other = torch.where(ms.kf_feat_mp >= 0, ms.kf_feat_mp.long(), P)
    counts = member[other].sum(dim=1).to(torch.int32)
    counts = torch.where(ms.kf_valid, counts, 0)
    counts[kf] = 0
    return counts


def update_covis_for_kf(ms: MapState, kf) -> MapState:
    row = covis_row(ms, kf)
    covis = ms.covis.clone()
    covis[kf, :] = row
    covis[:, kf] = row
    return ms._replace(covis=covis)


def best_covisible(ms: MapState, kf, n: int, min_weight: int = 1):
    """Top-n covisible KFs of ``kf``; equal weights keep the lower slot
    first, as the reference's top_k does."""
    wrow = torch.where(ms.kf_valid, ms.covis[kf], 0)
    n = min(n, wrow.shape[0])
    w, idx = torch.sort(wrow, descending=True, stable=True)
    w, idx = w[:n], idx[:n]
    return idx.to(torch.int32), w, w >= min_weight


def assign_spanning_parent(ms: MapState, kf) -> MapState:
    """Parent = strongest covisible KF created earlier (smaller kf_seq)."""
    wrow = ms.covis[kf] * (ms.kf_seq < ms.kf_seq[kf])
    parent = torch.where(wrow.max() > 0, torch.argmax(wrow), NO_KF)
    return ms._replace(kf_parent=set_at(ms.kf_parent, kf,
                                      parent.to(torch.int32)))


def add_keyframe(ms: MapState, q, t, agent, map_id, ts, agent_kf_id,
                 feat_uv, feat_level, feat_angle, feat_desc, feat_valid,
                 feat_mp, cam_params=None):
    """Insert a keyframe into the lowest free slot; returns (ms, kf_slot).

    ``feat_mp [F]`` carries the features' map-point associations (-1 =
    none); reverse observations, covisibility and the spanning parent are
    updated here.  The caller guards arena capacity."""
    kf = torch.argmax((~ms.kf_valid).to(torch.int32))
    F = feat_uv.shape[0]
    ms = ms._replace(
        kf_q=set_at(ms.kf_q, kf, q), kf_t=set_at(ms.kf_t, kf, t),
        kf_valid=set_at(ms.kf_valid, kf, True),
        kf_agent=set_at(ms.kf_agent, kf, agent),
        kf_map=set_at(ms.kf_map, kf, map_id), kf_ts=set_at(ms.kf_ts, kf, ts),
        kf_agent_kf_id=set_at(ms.kf_agent_kf_id, kf, agent_kf_id),
        kf_seq=set_at(ms.kf_seq, kf, ms.n_kf),
        kf_cam=(ms.kf_cam if cam_params is None
                else set_at(ms.kf_cam, kf, cam_params)),
        kf_feat_uv=set_at(ms.kf_feat_uv, kf, feat_uv),
        kf_feat_level=set_at(ms.kf_feat_level, kf, feat_level),
        kf_feat_angle=set_at(ms.kf_feat_angle, kf, feat_angle),
        kf_feat_desc=set_at(ms.kf_feat_desc, kf, feat_desc),
        kf_feat_valid=set_at(ms.kf_feat_valid, kf, feat_valid),
        kf_feat_mp=set_at(ms.kf_feat_mp, kf, NO_MP),
        n_kf=ms.n_kf + 1,
    )
    mp = torch.clamp(feat_mp, min=0).long()
    ok = (feat_mp >= 0) & feat_valid & ms.mp_valid[mp]
    ms = mp_add_observation(
        ms, mp, kf.expand(F),
        torch.arange(F, device=feat_mp.device), ok)
    ms = update_covis_for_kf(ms, kf)
    ms = assign_spanning_parent(ms, kf)
    return ms, kf.to(torch.int32)


# ---------------------------------------------------------------------------
# map-point maintenance
# ---------------------------------------------------------------------------

def _mp_stats(ms: MapState, pi: torch.Tensor, scale_factors):
    """Distinctive descriptor, normal, depth bounds and reference KF of the
    points ``pi [C]`` from their observations (reference
    ``MapPoint::ComputeDistinctiveDescriptors`` + ``UpdateNormalAndDepth``).
    Returns (desc, normal, min_dist, max_dist, ref_kf, n_ok)."""
    C = pi.shape[0]
    Mo = ms.mp_obs_kf.shape[1]
    dev = pi.device
    obs_kf, obs_feat = ms.mp_obs_kf[pi], ms.mp_obs_feat[pi]
    obs_ok = ((torch.arange(Mo, device=dev)[None, :] < ms.mp_nobs[pi][:, None])
              & (obs_kf >= 0))
    kf = torch.clamp(obs_kf, min=0).long()
    obs_ok = obs_ok & ms.kf_valid[kf]
    feat = torch.clamp(obs_feat, min=0).long()

    # median pairwise Hamming distance inside each point's observations;
    # the observation with the lowest median gives the descriptor
    descs = ms.kf_feat_desc[kf, feat]                      # [C, M, 32]
    pair = M.hamming_matrix(descs, descs)                  # [C, M, M]
    big = 1 << 15
    pair = torch.where(obs_ok[:, :, None] & obs_ok[:, None, :], pair, big)
    sorted_pair = torch.sort(pair, dim=-1).values
    n_ok = obs_ok.sum(-1)
    med_idx = torch.clamp(torch.div(n_ok - 1, 2, rounding_mode="floor"),
                          0, Mo - 1)
    med = torch.take_along_dim(
        sorted_pair, med_idx[:, None, None].expand(C, Mo, 1), -1)[..., 0]
    med = torch.where(obs_ok, med, big)
    rows = torch.arange(C, device=dev)
    new_desc = descs[rows, torch.argmin(med, -1)]

    centre = -lie.quat_rotate(lie.quat_conj(ms.kf_q[kf]), ms.kf_t[kf])
    vec = ms.mp_pos[pi][:, None, :] - centre
    dist = torch.linalg.vector_norm(vec, dim=-1)
    dirs = vec / torch.clamp(dist[..., None], min=1e-9)
    normal = torch.where(obs_ok[..., None], dirs, 0.0).sum(1)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-9)

    # the first valid observation is the reference
    first = torch.argmax(obs_ok.to(torch.int32), -1)
    ref_kf = obs_kf[rows, first]
    ref_feat = obs_feat[rows, first]
    ref_level = ms.kf_feat_level[torch.clamp(ref_kf, min=0).long(),
                                 torch.clamp(ref_feat, min=0).long()]
    max_dist = dist[rows, first] * scale_factors[
        torch.clamp(ref_level, min=0).long()]
    min_dist = max_dist / scale_factors[-1]
    return new_desc, normal, min_dist, max_dist, ref_kf, n_ok


def _write_stats(ms: MapState, pi, upd, stats) -> MapState:
    desc, normal, min_dist, max_dist, ref_kf, _ = stats
    w = torch.where(upd, pi, ms.mp_valid.shape[0])
    return ms._replace(
        mp_desc=set_rows(ms.mp_desc, w, desc),
        mp_normal=set_rows(ms.mp_normal, w, normal),
        mp_min_dist=set_rows(ms.mp_min_dist, w, min_dist),
        mp_max_dist=set_rows(ms.mp_max_dist, w, max_dist),
        mp_ref_kf=set_rows(ms.mp_ref_kf, w, ref_kf))


def refresh_mp_stats(ms: MapState, mp_mask, scale_factors) -> MapState:
    """Recompute descriptor, normal, depth bounds and reference KF of the
    masked points that have an observation.  The masked rows are gathered
    (one host read of their count) and only they are computed; the rest of
    the arena keeps its values, as in the reference."""
    pi = torch.nonzero(mp_mask)[:, 0]
    stats = _mp_stats(ms, pi, scale_factors)
    return _write_stats(ms, pi, stats[5] > 0, stats)


def refresh_mp_stats_compact(ms: MapState, idx, scale_factors) -> MapState:
    """``refresh_mp_stats`` for a compact index batch ``idx [C]`` (-1 =
    padding); only live points are written."""
    pi = torch.clamp(idx, min=0).long()
    stats = _mp_stats(ms, pi, scale_factors)
    return _write_stats(ms, pi, (idx >= 0) & (stats[5] > 0)
                        & ms.mp_valid[pi], stats)


def compact_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """First ``cap`` set indices of ``mask`` (stable), -1-padded [cap]."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    sel = order[:cap]
    return torch.where(mask[sel], sel, -1).to(torch.int32)


def remove_map_points(ms: MapState, kill_mask) -> MapState:
    """SetBadFlag for a batch of points: clear forward links, reverse
    table and validity."""
    fmp = ms.kf_feat_mp
    hit = (fmp >= 0) & kill_mask[torch.clamp(fmp, min=0).long()]
    return ms._replace(
        kf_feat_mp=torch.where(hit, NO_MP, fmp),
        mp_valid=ms.mp_valid & ~kill_mask,
        mp_nobs=torch.where(kill_mask, 0, ms.mp_nobs),
        mp_obs_kf=torch.where(kill_mask[:, None], NO_KF, ms.mp_obs_kf),
        mp_obs_feat=torch.where(kill_mask[:, None], -1, ms.mp_obs_feat))


def replace_map_points(ms: MapState, src, dst, ok) -> MapState:
    """MapPoint::Replace for batches: redirect every forward link from
    ``src[i]`` to ``dst[i]`` and kill src, carrying its found/visible
    counts over.  A pair whose ``dst`` is itself replaced in the batch is
    skipped (its src lives on): in a chain ``a -> b, b -> c`` or a cycle
    the links redirected to ``b`` would point at a dead slot, which a
    later point, of any map, may take.  Reverse tables are left to
    ``rebuild_reverse_obs``."""
    P = ms.mp_valid.shape[0]
    dev = ms.mp_valid.device
    src, dst = src.long(), dst.long()
    replaced = set_rows(torch.zeros(P, dtype=torch.bool, device=dev),
                        torch.where(ok, src, P), True)
    ok = ok & ~replaced[torch.clamp(dst, 0, P - 1)]
    w = torch.where(ok, src, P)
    lut = set_rows(torch.arange(P, dtype=torch.int32, device=dev), w,
                    dst.to(torch.int32))
    fmp = ms.kf_feat_mp
    fmp = torch.where(fmp >= 0, lut[torch.clamp(fmp, min=0).long()], fmp)
    kill = set_rows(torch.zeros(P, dtype=torch.bool, device=dev), w, True)
    to = torch.where(ok, dst, P)
    srcc = torch.clamp(src, 0, P - 1)

    def carry(x):
        y = torch.cat([x, x[:1]])
        y.index_add_(0, to, torch.where(ok, x[srcc], 0.0))
        return y[:P]

    return ms._replace(kf_feat_mp=fmp, mp_valid=ms.mp_valid & ~kill,
                       mp_found=carry(ms.mp_found),
                       mp_visible=carry(ms.mp_visible),
                       mp_nobs=torch.where(kill, 0, ms.mp_nobs))


def rebuild_reverse_obs(ms: MapState) -> MapState:
    """Rebuild the mp_obs_* tables from the forward kf_feat_mp table: each
    point's observations in (kf, feature) order, capped at M."""
    K, F = ms.kf_feat_mp.shape
    P, Mo = ms.mp_obs_kf.shape
    dev = ms.kf_feat_mp.device
    flat_mp = ms.kf_feat_mp.reshape(-1).long()
    flat_kf = torch.arange(K, device=dev).repeat_interleave(F)
    flat_feat = torch.arange(F, device=dev).repeat(K)
    ok = ((flat_mp >= 0) & ms.kf_valid[flat_kf]
          & ms.mp_valid[torch.clamp(flat_mp, min=0)])
    tgt = torch.where(ok, flat_mp, P)                  # P = scratch row
    rank = _rank_in_runs(tgt)
    keep = ok & (rank < Mo)
    row = torch.where(keep, tgt, P)
    col = torch.where(keep, rank, 0)
    obs_kf = torch.full((P + 1, Mo), NO_KF, dtype=torch.int32, device=dev)
    obs_kf[row, col] = flat_kf.to(torch.int32)
    obs_feat = torch.full((P + 1, Mo), -1, dtype=torch.int32, device=dev)
    obs_feat[row, col] = flat_feat.to(torch.int32)
    nobs = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    nobs.index_add_(0, row, keep.to(torch.int32))
    return ms._replace(mp_obs_kf=obs_kf[:P], mp_obs_feat=obs_feat[:P],
                       mp_nobs=torch.clamp(nobs[:P], max=Mo))


def add_loop_edge(ms: MapState, i, j) -> MapState:
    """Record a loop/merge edge (KeyFrame::AddLoopEdge / AddMergeEdge) in
    the first free slot; when all are taken, slot 0 is overwritten."""
    slot = torch.argmax((~ms.loop_valid).to(torch.int32))
    return ms._replace(loop_i=set_at(ms.loop_i, slot, int(i)),
                       loop_j=set_at(ms.loop_j, slot, int(j)),
                       loop_valid=set_at(ms.loop_valid, slot, True))


def remove_keyframe(ms: MapState, kf) -> MapState:
    """KeyFrame::SetBadFlag: drop the KF and its observations, reconnect
    its children to its parent, clear its covisibility, drop loop edges
    touching it, then rebuild the reverse observations."""
    covis = ms.covis.clone()
    covis[kf, :] = 0
    covis[:, kf] = 0
    parent = ms.kf_parent[kf]
    hit = ((ms.loop_i == kf) | (ms.loop_j == kf)) & ms.loop_valid
    ms = ms._replace(
        kf_valid=set_at(ms.kf_valid, kf, False),
        kf_seq=set_at(ms.kf_seq, kf, BIG_SEQ),
        kf_feat_mp=set_at(ms.kf_feat_mp, kf, NO_MP),
        covis=covis,
        kf_parent=torch.where(ms.kf_parent == kf, parent, ms.kf_parent),
        loop_valid=ms.loop_valid & ~hit)
    return rebuild_reverse_obs(ms)
