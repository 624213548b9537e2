"""SLAM steps: tracking (frustum test, projection search, pose) and
local mapping (triangulation, fuse, keyframe redundancy, window BA wiring).

Port of ``mam3slam_tpu.slam.steps``.  No step reads a value back to the
host: compaction and inversion scatter into a scratch slot past the end
instead of selecting rows by mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import matching as M
from mam3slam_tpu_torch.solvers import ba as ba_mod
from mam3slam_tpu_torch.solvers import ba_window as bw
from mam3slam_tpu_torch.solvers import twoview


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


# ---------------------------------------------------------------------------
# triangulation (LocalMapping::CreateNewMapPoints)
# ---------------------------------------------------------------------------

def _fundamental_from_poses(q1, t1, q2, t2, K1, K2):
    """F12 with x2^T F12 x1 = 0 for the cameras T_cw1, T_cw2 (the second
    may carry a leading batch axis)."""
    R1 = lie.quat_to_matrix(q1)
    R2 = lie.quat_to_matrix(q2)
    R12 = R2 @ R1.T
    t12 = t2 - (R12 @ t1[:, None])[..., 0]
    E = lie.hat(t12) @ R12
    return (torch.linalg.inv_ex(K2)[0].transpose(-1, -2) @ E
            @ torch.linalg.inv_ex(K1)[0])


def triangulate_with_neighbor(ms: S.MapState, kf1, kf2, kind: int,
                              sigma2_per_level,
                              min_parallax_cos: float = 0.9998):
    """Match kf1's un-associated features against each neighbour in
    ``kf2 [B]`` along the epipolar line, triangulate, and gate (depth,
    parallax, chi2 reprojection in both views, scale consistency).
    Returns (ok [B, F], pos [B, F, 3], feat1 [F], feat2 [B, F])."""
    F = ms.kf_feat_uv.shape[1]
    B = kf2.shape[0]
    kf2 = kf2.long()
    dev = ms.kf_feat_uv.device
    uv1, uv2 = ms.kf_feat_uv[kf1], ms.kf_feat_uv[kf2]       # [F,2], [B,F,2]
    lvl1, lvl2 = ms.kf_feat_level[kf1], ms.kf_feat_level[kf2]
    free1 = ms.kf_feat_valid[kf1] & (ms.kf_feat_mp[kf1] < 0)
    free2 = ms.kf_feat_valid[kf2] & (ms.kf_feat_mp[kf2] < 0)
    q1, t1 = ms.kf_q[kf1], ms.kf_t[kf1]
    q2, t2 = ms.kf_q[kf2], ms.kf_t[kf2]
    cam1 = cam_mod.Camera(ms.kf_cam[kf1], kind)
    cam2 = cam_mod.Camera(ms.kf_cam[kf2][:, None, :], kind)
    if kind == cam_mod.KANNALA_BRANDT8:
        # the epipolar search and DLT run on ideal-pinhole coordinates;
        # the reprojection gates stay in the raw match space
        uv1_g = cam_mod.undistort_points(cam1, uv1)
        uv2_g = cam_mod.undistort_points(cam2, uv2)
    else:
        uv1_g, uv2_g = uv1, uv2
    K1 = cam1.K()
    K2 = cam_mod.Camera(ms.kf_cam[kf2], kind).K()             # [B, 3, 3]
    F12 = _fundamental_from_poses(q1, t1, q2, t2, K1, K2)
    res = M.search_for_triangulation(
        uv1_g, ms.kf_feat_desc[kf1], lvl1, free1,
        uv2_g, ms.kf_feat_desc[kf2], lvl2, free2, F12, sigma2_per_level)

    idx2 = torch.clamp(res.idx, min=0).long()                # [B, F]

    def pick(x):  # per-neighbour rows of the matched features
        return torch.take_along_dim(x, idx2.reshape(idx2.shape + (1,) * (
            x.dim() - 2)), 1)

    R1, R2 = lie.quat_to_matrix(q1), lie.quat_to_matrix(q2)
    P1 = K1 @ torch.cat([R1, t1[:, None]], dim=1)
    P2 = K2 @ torch.cat([R2, t2[..., None]], dim=-1)
    X = twoview.triangulate_dlt(P1.expand(B, F, 3, 4),
                                P2[:, None].expand(B, F, 3, 4),
                                uv1_g.expand(B, F, 2), pick(uv2_g))

    C1 = -R1.T @ t1
    C2 = -(R2.transpose(-1, -2) @ t2[..., None])[..., 0]
    r1, r2 = X - C1, X - C2[:, None]
    d1 = torch.linalg.vector_norm(r1, dim=-1)
    d2 = torch.linalg.vector_norm(r2, dim=-1)
    cos_par = (r1 * r2).sum(-1) / torch.clamp(d1 * d2, min=1e-9)
    Xc1 = X @ R1.T + t1
    Xc2 = X @ R2.transpose(-1, -2) + t2[:, None]
    z_ok = (Xc1[..., 2] > 1e-3) & (Xc2[..., 2] > 1e-3)

    lvl2m = pick(lvl2).long()
    s1 = sigma2_per_level[lvl1.long()]
    s2 = sigma2_per_level[lvl2m]
    e1 = ((cam_mod.project_ideal(cam1, Xc1) - uv1) ** 2).sum(-1)
    e2 = ((cam_mod.project_ideal(cam2, Xc2) - pick(uv2)) ** 2).sum(-1)
    reproj_ok = (e1 < 5.991 * s1) & (e2 < 5.991 * s2)

    # scale consistency: ratio of distances vs ratio of octave scales
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    sf = torch.sqrt(sigma2_per_level[1])
    sq = torch.sqrt(sigma2_per_level)
    ratio_octave = sq[lvl1.long()] / sq[lvl2m]
    scale_ok = ((ratio_dist * 1.5 * sf > ratio_octave)
                & (ratio_dist < ratio_octave * 1.5 * sf))

    finite = torch.isfinite(X).all(-1)
    ok = (res.ok & z_ok & reproj_ok & scale_ok & finite
          & (cos_par < min_parallax_cos) & (cos_par > 0.0))
    return (ok, torch.where(finite[..., None], X, 0.0),
            torch.arange(F, dtype=torch.int32, device=dev),
            idx2.to(torch.int32))


def add_triangulated_points(ms: S.MapState, kf1, kf2, ok, X, feat1, feat2,
                            map_id):
    """Allocate slots for a triangulated batch and wire observations in
    both keyframes (``kf2`` a scalar or one per point).  Returns (ms,
    n_dropped): requests beyond the arena's free capacity are dropped."""
    slots, granted = S.alloc_mp_slots(ms, ok)
    n_dropped = (ok & ~granted).to(torch.int32).sum()
    ok = granted
    P = ms.mp_valid.shape[0]
    F = feat1.shape[0]
    dev = feat1.device
    kf1 = torch.as_tensor(kf1, device=dev).long()
    w = torch.where(ok, slots.long(), P)
    put = S.set_rows
    ms = ms._replace(
        mp_pos=put(ms.mp_pos, w, X.to(ms.mp_pos.dtype)),
        mp_valid=put(ms.mp_valid, w, True),
        mp_map=put(ms.mp_map, w, torch.as_tensor(map_id, device=dev)
                   .to(torch.int32)),
        mp_first_kf=put(ms.mp_first_kf, w, ms.kf_seq[kf1]),
        mp_first_agent=put(ms.mp_first_agent, w, ms.kf_agent[kf1]),
        mp_first_agent_kf=put(ms.mp_first_agent_kf, w,
                              ms.kf_agent_kf_id[kf1]),
        mp_ref_kf=put(ms.mp_ref_kf, w, kf1.to(torch.int32)),
        mp_found=put(ms.mp_found, w, 1.0),
        mp_visible=put(ms.mp_visible, w, 1.0),
        mp_nobs=put(ms.mp_nobs, w, 0))
    ms = S.mp_add_observation(ms, slots, kf1.expand(F), feat1, ok)
    kf2_arr = torch.as_tensor(kf2, device=dev).expand(F)
    ms = S.mp_add_observation(ms, slots, kf2_arr, feat2, ok)
    return ms, n_dropped


# ---------------------------------------------------------------------------
# fuse (ORBmatcher::Fuse)
# ---------------------------------------------------------------------------

def fuse_into_kf(ms: S.MapState, kf, mp_mask, kind: int, width, height,
                 scale_factors, max_dist: int = M.TH_LOW):
    """Project the masked map points into keyframe ``kf`` (the masked
    match kernel over the whole arena as queries); where the matched
    feature already has a point, the new point is replaced by the existing
    one, where it is free the observation is added.  Returns (ms, n_fused,
    touched [P]: the points whose observation sets changed)."""
    P = ms.mp_pos.shape[0]
    dev = ms.mp_pos.device
    cam = cam_mod.Camera(ms.kf_cam[kf], kind)
    uv_p, lvl_p, visible, _ = project_into_frame(
        ms, ms.kf_q[kf], ms.kf_t[kf], cam, width, height, mp_mask,
        scale_factors)
    res = M.search_by_projection_frame(
        uv_p, lvl_p, 3.0 * scale_factors[lvl_p.long()], ms.mp_desc, visible,
        ms.kf_feat_uv[kf], ms.kf_feat_level[kf], ms.kf_feat_desc[kf],
        ms.kf_feat_valid[kf], max_dist=max_dist)
    feat = torch.clamp(res.idx, min=0).long()
    cur = ms.kf_feat_mp[kf][feat]
    arange = torch.arange(P, dtype=torch.int32, device=dev)
    ok = res.ok & (cur != arange)          # not into its own observation
    occupied = cur >= 0
    curc = torch.clamp(cur, min=0)
    rep_ok = ok & occupied & ms.mp_valid[curc.long()]
    ms = S.replace_map_points(ms, arange, curc, rep_ok)
    add_ok = ok & ~occupied
    ms = S.mp_add_observation(ms, arange, torch.as_tensor(kf, device=dev)
                              .expand(P), feat, add_ok)
    survivor = S.set_rows(torch.zeros(P, dtype=torch.bool, device=dev),
                           torch.where(rep_ok, curc.long(), P), True)
    return ms, ok.to(torch.int32).sum(), add_ok | survivor


# ---------------------------------------------------------------------------
# keyframe culling
# ---------------------------------------------------------------------------

def keyframe_redundancy(ms: S.MapState, kf, scale_margin: int = 1):
    """Fraction of the tracked map points of ``kf`` (a slot or a batch of
    slots) seen by >= 3 other keyframes at the same or a finer scale
    (reference KeyFrameCulling).  Returns (redundant_frac, n_tracked)."""
    kf = torch.as_tensor(kf, device=ms.kf_feat_mp.device).long()
    Mo = ms.mp_obs_kf.shape[1]
    mp = ms.kf_feat_mp[kf]
    mp_c = torch.clamp(mp, min=0).long()
    has = (mp >= 0) & ms.kf_feat_valid[kf] & ms.mp_valid[mp_c]
    obs_kf, obs_feat = ms.mp_obs_kf[mp_c], ms.mp_obs_feat[mp_c]
    slots = torch.arange(Mo, device=mp.device)
    obs_ok = ((slots < ms.mp_nobs[mp_c][..., None]) & (obs_kf >= 0)
              & (obs_kf != kf[..., None, None]))
    okc = torch.clamp(obs_kf, min=0).long()
    obs_ok = obs_ok & ms.kf_valid[okc]
    other_level = ms.kf_feat_level[okc, torch.clamp(obs_feat, min=0).long()]
    finer = obs_ok & (other_level <= ms.kf_feat_level[kf][..., None]
                      + scale_margin)
    redundant = has & (finer.sum(-1) >= 3)
    n_tracked = has.to(torch.int32).sum(-1)
    frac = redundant.to(torch.float32).sum(-1) / torch.clamp(
        n_tracked.to(torch.float32), min=1.0)
    return frac, n_tracked


# ---------------------------------------------------------------------------
# edge-list BA wiring (solvers/ba.py: run_ba)
# ---------------------------------------------------------------------------

def build_local_ba_problem(ms: S.MapState, opt_kf_mask,
                           inv_sigma2) -> ba_mod.BAProblem:
    """A ``BAProblem`` over the whole arenas, selected by masks: the
    cameras in ``opt_kf_mask`` free, every other observing keyframe fixed,
    the points observed by a free camera free.  The edge list is every
    (keyframe, feature) slot, [K * F], valid where it links a live point
    and touches a free camera or point."""
    K, F = ms.kf_feat_mp.shape
    P = ms.mp_valid.shape[0]
    dev = ms.kf_feat_mp.device
    fmp = ms.kf_feat_mp.reshape(-1)
    mp_c = torch.clamp(fmp, min=0).long()
    obs_kf = torch.arange(K, dtype=torch.int32,
                          device=dev).repeat_interleave(F)
    link = (fmp >= 0) & opt_kf_mask[obs_kf.long()]
    pt_free = S.set_rows(torch.zeros(P, dtype=torch.bool, device=dev),
                         torch.where(link, mp_c, P), True) & ms.mp_valid
    obs_valid = ((fmp >= 0) & ms.kf_valid[obs_kf.long()] & ms.mp_valid[mp_c]
                 & (opt_kf_mask[obs_kf.long()] | pt_free[mp_c]))
    obs = ba_mod.Obs(cam=obs_kf, pt=mp_c.to(torch.int32),
                     uv=ms.kf_feat_uv.reshape(-1, 2),
                     w=inv_sigma2[ms.kf_feat_level.reshape(-1).long()],
                     valid=obs_valid)
    return ba_mod.BAProblem(
        cam_q=ms.kf_q, cam_t=ms.kf_t, cam_params=ms.kf_cam, pts=ms.mp_pos,
        obs=obs, cam_free=opt_kf_mask & ms.kf_valid, pt_free=pt_free)


def compact_ba_problem(prob: ba_mod.BAProblem, cap: int, extra=None):
    """The valid edges of ``prob`` compacted, in order, into ``cap`` rows
    (edges past ``cap`` are dropped); ``extra`` [E, ...] is compacted
    alongside and returned second."""
    keep = prob.obs.valid
    pos = torch.cumsum(keep.to(torch.int32), 0) - 1
    idx = torch.where(keep & (pos < cap), pos, cap).long()

    def put(src, fill=0):
        out = torch.full((cap + 1,) + src.shape[1:], fill, dtype=src.dtype,
                         device=src.device)
        out[idx] = src
        return out[:cap]

    obs = ba_mod.Obs(cam=put(prob.obs.cam), pt=put(prob.obs.pt),
                     uv=put(prob.obs.uv), w=put(prob.obs.w),
                     valid=put(prob.obs.valid, fill=False))
    if extra is not None:
        return prob._replace(obs=obs), put(extra)
    return prob._replace(obs=obs)


def apply_ba_result(ms: S.MapState, res: ba_mod.BAResult, opt_kf_mask,
                    pt_free) -> S.MapState:
    """Write the optimised cameras of ``opt_kf_mask`` and points of
    ``pt_free`` back to the arena."""
    return ms._replace(
        kf_q=torch.where(opt_kf_mask[:, None], res.cam_q, ms.kf_q),
        kf_t=torch.where(opt_kf_mask[:, None], res.cam_t, ms.kf_t),
        mp_pos=torch.where(pt_free[:, None], res.pts, ms.mp_pos))


# ---------------------------------------------------------------------------
# dense window BA wiring (solvers/ba_window.py)
# ---------------------------------------------------------------------------

def _compact(mask: torch.Tensor, cap: int):
    """(slot_of [N]: rank among set entries or -1 past ``cap``, idx
    [cap]: the entry of each slot or -1), stable by index."""
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    slot_of = torch.where(mask & (pos < cap), pos, -1).to(torch.int32)
    idx = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    idx[torch.where(slot_of >= 0, slot_of, cap).long()] = torch.arange(
        mask.shape[0], dtype=torch.int32, device=mask.device)
    return slot_of, idx[:cap]


def build_window_problem(ms: S.MapState, opt_mask, inv_sigma2,
                         cam_cap: int, pt_cap: int,
                         with_cm: bool = False) -> bw.WindowProblem:
    """``WindowProblem``: the free cameras compacted to ``[cam_cap]``, the
    points they observe to ``[pt_cap]``, the point-major edges from the
    reverse-observation table.  Free cameras or points past their cap
    stay fixed.  ``with_cm`` adds the camera-major view that
    ``run_window_ba`` needs (each free camera's [F] feature slots, its
    validity and point-major slot found by a [Kc, F, M] compare against
    the point-major view, so both views hold one edge set); without it
    the ``cm_*`` arrays have 0 rows, as every production caller builds
    them (the reference's default is ``with_cm=True``)."""
    F = ms.kf_feat_mp.shape[1]
    Mo = ms.mp_obs_kf.shape[1]
    dev = ms.kf_q.device
    cam_slot_of, cam_idx = _compact(opt_mask & ms.kf_valid, cam_cap)
    cam_valid = cam_idx >= 0
    ci = torch.clamp(cam_idx, min=0).long()
    eff_free = cam_slot_of >= 0

    slots = torch.arange(Mo, device=dev)
    obs_ok = (slots[None, :] < ms.mp_nobs[:, None]) & (ms.mp_obs_kf >= 0)
    pt_free = (obs_ok & eff_free[torch.clamp(ms.mp_obs_kf, min=0).long()]
               ).any(1) & ms.mp_valid
    pt_slot_of, pt_idx = _compact(pt_free, pt_cap)
    pt_valid = pt_idx >= 0
    pi = torch.clamp(pt_idx, min=0).long()

    pm_kf, pm_feat = ms.mp_obs_kf[pi], ms.mp_obs_feat[pi]
    kfc = torch.clamp(pm_kf, min=0).long()
    ftc = torch.clamp(pm_feat, min=0).long()
    pm_valid = (pt_valid[:, None]
                & (slots[None, :] < ms.mp_nobs[pi][:, None]) & (pm_kf >= 0)
                & ms.kf_valid[kfc]
                & (ms.kf_feat_mp[kfc, ftc] == pt_idx[:, None]))
    if with_cm:
        cm_fmp = ms.kf_feat_mp[ci]                          # [Kc, F]
        cm_pt = torch.where(cm_fmp >= 0, pt_slot_of[
            torch.clamp(cm_fmp, min=0).long()], -1)
        cm_uv = ms.kf_feat_uv[ci]
        cm_w = inv_sigma2[ms.kf_feat_level[ci].long()]
        ptc = torch.clamp(cm_pt, min=0).long()
        feats = torch.arange(F, dtype=torch.int32, device=dev)
        hit = (pm_valid[ptc] & (pm_kf[ptc] == cam_idx[:, None, None])
               & (pm_feat[ptc] == feats[None, :, None]))    # [Kc, F, M]
        cm_mslot = torch.argmax(hit.to(torch.int32), -1).to(torch.int32)
        cm_valid = hit.any(-1) & (cm_pt >= 0) & cam_valid[:, None]
    else:
        cm_uv = torch.zeros((0, F, 2), device=dev)
        cm_w = torch.zeros((0, F), device=dev)
        cm_pt = cm_mslot = torch.zeros((0, F), dtype=torch.int32, device=dev)
        cm_valid = torch.zeros((0, F), dtype=torch.bool, device=dev)
    return bw.WindowProblem(
        cam_idx=cam_idx, cam_valid=cam_valid, cam_q=ms.kf_q[ci],
        cam_t=ms.kf_t[ci], cam_params=ms.kf_cam[ci],
        cm_uv=cm_uv, cm_w=cm_w, cm_pt=cm_pt, cm_mslot=cm_mslot,
        cm_valid=cm_valid,
        pt_idx=pt_idx, pt_valid=pt_valid, pts=ms.mp_pos[pi],
        pm_kf=pm_kf, pm_feat=pm_feat,
        pm_cslot=torch.where(pm_valid, cam_slot_of[kfc], -1),
        pm_uv=ms.kf_feat_uv[kfc, ftc],
        pm_w=inv_sigma2[ms.kf_feat_level[kfc, ftc].long()],
        pm_valid=pm_valid, pm_q0=ms.kf_q[kfc], pm_t0=ms.kf_t[kfc],
        pm_params0=ms.kf_cam[kfc],
        cam_slot_of=cam_slot_of, pt_slot_of=pt_slot_of)


def repair_window_reverse_obs(ms: S.MapState, prob: bw.WindowProblem,
                              drop_pm) -> S.MapState:
    """Rewrite only the window points' reverse-observation rows, without
    the dropped and stale entries (order kept)."""
    P, Mo = ms.mp_obs_kf.shape
    keep = prob.pm_valid & ~drop_pm
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    n_keep = keep.sum(1, dtype=torch.int32)
    live = torch.arange(Mo, device=keep.device)[None, :] < n_keep[:, None]
    new_kf = torch.where(live, torch.take_along_dim(prob.pm_kf, order, 1),
                         S.NO_KF)
    new_ft = torch.where(live, torch.take_along_dim(prob.pm_feat, order, 1),
                         -1)
    w = torch.where(prob.pt_idx >= 0, prob.pt_idx, P).long()
    return ms._replace(mp_obs_kf=S.set_rows(ms.mp_obs_kf, w, new_kf),
                       mp_obs_feat=S.set_rows(ms.mp_obs_feat, w, new_ft),
                       mp_nobs=S.set_rows(ms.mp_nobs, w, n_keep))


def window_pt_mask(ms: S.MapState, prob: bw.WindowProblem) -> torch.Tensor:
    """Arena-sized mask of the points the window problem optimises."""
    return prob.pt_slot_of >= 0


def apply_window_result(ms: S.MapState, prob: bw.WindowProblem,
                        res: bw.WindowResult, drop_pm=None) -> S.MapState:
    """Write optimised poses and points back through the slot maps;
    optionally unlink the observations in ``drop_pm [Pw, M]`` from the
    forward table (the caller repairs the reverse table)."""
    K, F = ms.kf_feat_mp.shape
    cs, ps = prob.cam_slot_of, prob.pt_slot_of
    csl = torch.clamp(cs, min=0).long()
    psl = torch.clamp(ps, min=0).long()
    ms = ms._replace(
        kf_q=torch.where((cs >= 0)[:, None], res.cam_q[csl], ms.kf_q),
        kf_t=torch.where((cs >= 0)[:, None], res.cam_t[csl], ms.kf_t),
        mp_pos=torch.where((ps >= 0)[:, None], res.pts[psl], ms.mp_pos))
    if drop_pm is not None:
        flat = torch.where(
            drop_pm, prob.pm_kf.long() * F + torch.clamp(prob.pm_feat,
                                                         min=0).long(),
            K * F).reshape(-1)
        fmp = S.set_rows(ms.kf_feat_mp.reshape(-1), flat, S.NO_MP)
        ms = ms._replace(kf_feat_mp=fmp.reshape(K, F))
    return ms
