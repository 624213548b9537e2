"""Struct-of-arrays map state: keyframes, map points, observations, graph.

Port of ``mam3slam_tpu.mapstate.state``: the same ``MapState`` fields,
shapes and dtypes, as torch tensors on one device, and the mutators the
tracking slice uses.  Mutators return a new ``MapState`` and leave the
one they were given unchanged (the tracking step keeps the map it read
beside the one it returns); a tensor they change is copied first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

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


def init_map_state(cfg: MapConfig, device=None) -> MapState:
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


def _put(x: torch.Tensor, index, values) -> torch.Tensor:
    """Copy of ``x`` with ``x[index] = values``."""
    y = x.clone()
    y[index] = values
    return y


def mp_add_observation(ms: MapState, mp, kf, feat, ok) -> MapState:
    """Batch-add reverse + forward observations (mp/kf/feat [N], ok mask).
    Several observations of one point in a batch take consecutive
    reverse slots; only ``ok`` rows write."""
    P, M = ms.mp_obs_kf.shape
    K = ms.kf_feat_mp.shape[0]
    mp, kf, feat = mp.long(), kf.long(), feat.long()
    same = (mp[:, None] == mp[None, :]) & ok[:, None] & ok[None, :]
    before = torch.tril(same, diagonal=-1).sum(dim=1)
    slot = torch.clamp(ms.mp_nobs[mp] + before, 0, M - 1)
    # rows that do not write land in one scratch row past the arena
    row = torch.where(ok, mp, P)
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
    return ms._replace(kf_parent=_put(ms.kf_parent, kf,
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
        kf_q=_put(ms.kf_q, kf, q), kf_t=_put(ms.kf_t, kf, t),
        kf_valid=_put(ms.kf_valid, kf, True),
        kf_agent=_put(ms.kf_agent, kf, agent),
        kf_map=_put(ms.kf_map, kf, map_id), kf_ts=_put(ms.kf_ts, kf, ts),
        kf_agent_kf_id=_put(ms.kf_agent_kf_id, kf, agent_kf_id),
        kf_seq=_put(ms.kf_seq, kf, ms.n_kf),
        kf_cam=(ms.kf_cam if cam_params is None
                else _put(ms.kf_cam, kf, cam_params)),
        kf_feat_uv=_put(ms.kf_feat_uv, kf, feat_uv),
        kf_feat_level=_put(ms.kf_feat_level, kf, feat_level),
        kf_feat_angle=_put(ms.kf_feat_angle, kf, feat_angle),
        kf_feat_desc=_put(ms.kf_feat_desc, kf, feat_desc),
        kf_feat_valid=_put(ms.kf_feat_valid, kf, feat_valid),
        kf_feat_mp=_put(ms.kf_feat_mp, kf, NO_MP),
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
