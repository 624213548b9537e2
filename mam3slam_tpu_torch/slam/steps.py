"""Per-frame tracking steps: frustum test, projection search, pose.

Port of the tracking half of ``mam3slam_tpu.slam.steps``
(``project_into_frame``, ``match_map_to_frame``, ``track_pose``).  No step
reads a value back to the host: compaction and inversion scatter into a
scratch slot past the end instead of selecting rows by mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import matching as M
from mam3slam_tpu_torch.solvers import ba as ba_mod


class FrameObs(NamedTuple):
    """Per-frame features in match space (undistorted)."""

    uv: torch.Tensor      # [F, 2] f32
    level: torch.Tensor   # [F] i32
    angle: torch.Tensor   # [F] f32
    desc: torch.Tensor    # [F, 32] u8
    valid: torch.Tensor   # [F] bool


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def project_into_frame(ms: S.MapState, q, t, cam: cam_mod.Camera,
                       width: float, height: float, mp_mask,
                       scale_factors, view_cos_limit: float = 0.5):
    """Batched isInFrustum + PredictScale over the whole point arena.

    Returns (uv [P, 2], pred_level [P] i32, visible [P], view_cos [P])."""
    Xc = lie.quat_rotate(q[None, :], ms.mp_pos) + t[None, :]
    uv = cam_mod.project_ideal(cam, Xc)
    depth_ok = Xc[:, 2] > 0.05
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < height))
    C = -lie.quat_rotate(lie.quat_conj(q), t)
    vec = ms.mp_pos - C[None, :]
    dist = _norm(vec)
    dist_ok = (dist >= 0.8 * ms.mp_min_dist) & (dist <= 1.2 * ms.mp_max_dist)
    view_cos = torch.sum(vec * ms.mp_normal, dim=-1) / torch.clamp(dist,
                                                                   min=1e-9)
    angle_ok = view_cos > view_cos_limit
    n_levels = scale_factors.shape[0]
    ratio = ms.mp_max_dist / torch.clamp(dist, min=1e-9)
    level = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                       / torch.log(scale_factors[1])).to(torch.int32)
    level = torch.clamp(level, 0, n_levels - 1)
    visible = mp_mask & ms.mp_valid & depth_ok & in_img & dist_ok & angle_ok
    return uv, level, visible, view_cos


def match_map_to_frame(ms: S.MapState, frame: FrameObs, q, t,
                       cam: cam_mod.Camera, width, height, mp_mask,
                       scale_factors, th_radius: float = 1.0,
                       max_dist: int = M.TH_HIGH, ratio: float = 0.8,
                       cap: int = 4096):
    """SearchByProjection of the masked map points into a frame.

    The visible points are compacted, stable by slot, to ``cap``
    candidates before the masked Hamming search.  Returns (feat_mp [F] i32
    arena index per feature or -1, n_matches [] i32, visible [P])."""
    uv_p, lvl_p, visible, view_cos = project_into_frame(
        ms, q, t, cam, width, height, mp_mask, scale_factors)
    base_r = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = th_radius * base_r * scale_factors[lvl_p.long()]

    P = ms.mp_pos.shape[0]
    dev = ms.mp_pos.device
    cap = min(cap, P)
    pos = torch.cumsum(visible.to(torch.int32), 0) - 1
    ok = visible & (pos < cap)
    tgt = torch.where(ok, pos, cap).long()          # slot `cap` is scratch
    sel = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    sel[tgt] = torch.arange(P, device=dev)
    sel = sel[:cap]
    sel_vis = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    sel_vis[tgt] = True
    sel_vis = sel_vis[:cap]
    res = M.search_by_projection_frame(
        uv_p[sel], lvl_p[sel], radius[sel], ms.mp_desc[sel], sel_vis,
        frame.uv, frame.level, frame.desc, frame.valid,
        max_dist=max_dist, ratio=ratio)
    # invert to per-feature arena indices: only matched rows write (they
    # claim distinct features after resolve_duplicates)
    F = frame.uv.shape[0]
    feat_mp = torch.full((F + 1,), S.NO_MP, dtype=torch.int32, device=dev)
    feat_mp[torch.where(res.ok, res.idx.long(), F)] = sel.to(torch.int32)
    return feat_mp[:F], res.ok.to(torch.int32).sum(), visible


def track_pose(ms: S.MapState, frame: FrameObs, feat_mp, q0, t0,
               cam: cam_mod.Camera, inv_sigma2):
    """PoseOptimization over the frame's map matches.

    Returns (q, t, feat_inlier [F] bool, n_inliers)."""
    has = feat_mp >= 0
    mp = torch.clamp(feat_mp, min=0).long()
    w = inv_sigma2[frame.level.long()]
    res = ba_mod.pose_optimization(
        q0, t0, cam.params, cam.kind, ms.mp_pos[mp], frame.uv, w,
        has & frame.valid & ms.mp_valid[mp])
    return res.q, res.t, res.inlier, res.n_inliers
