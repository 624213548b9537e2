"""SLAM system: the programs of tracking, local mapping and the loop
server, and the multi-agent ``SlamSystem`` around them.

Port of ``mam3slam_tpu.slam.system``: ``SlamConfig``, the tracking-state
constants, ``programs`` (the reference's ``_compiled``: the same functions
with the same arguments and return tuples, the packed ``vec``, the
device-resident chain state and the packed culling decision included),
and ``SlamSystem``'s state machine: monocular initialisation, tracking,
relocalization, keyframe decisions, one local-mapping epoch per keyframe
and then the optional ``LoopServer``'s epoch, for several agents in one
shared arena.  With IMU measurements (``track(..., imu=)``) an agent
buffers its tracked poses with their IMU windows, initialises gravity,
scale, biases and velocities over ``imu_init_window_s`` of contiguous
tracking (``solvers/vi.py``), and from then on predicts each frame's pose
by preintegration (``solvers/imu.py``) in place of the constant-velocity
model.  PyTorch runs the programs eagerly; the host reads one
packed vector per tracked frame and one packed array per mapping epoch,
as the reference does.  The widened tracking retry is a host branch on
the coarse stage's inlier count.

Two options of the reference decouple the host from the device and the
front end from the back end.  ``pipeline`` defers each frame's read of
its packed vector and its state machine by up to ``pipeline_depth``
frames (on the card the read is a non-blocking copy into pinned host
memory, completed by an event).  ``async_mapping`` moves the mapping
and server epochs to one worker thread fed by a bounded queue; tracking
inserts a keyframe only when the worker has no mapping job, and counts
the refusals.  Both threads launch on their current stream, the device's
default stream, so every published ``MapState`` is ordered for the
other thread; the mutators are functional, so a snapshot never changes
under its reader.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import bow
from mam3slam_tpu_torch.ops import matching as M
from mam3slam_tpu_torch.slam import steps
from mam3slam_tpu_torch.solvers import ba_window as bw
from mam3slam_tpu_torch.solvers import imu as imu_mod
from mam3slam_tpu_torch.solvers import pnp
from mam3slam_tpu_torch.solvers import twoview
from mam3slam_tpu_torch.solvers import vi as vi_mod
from mam3slam_tpu_torch.utils.timing import TRACER, Timers

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


def _se3_compose_np(q1, t1, q2, t2):
    """numpy a*b SE3 compose (wxyz quaternions), float32."""
    aw, ax, ay, az = q1
    bw_, bx, by, bz = q2
    q = np.array([aw * bw_ - ax * bx - ay * by - az * bz,
                  aw * bx + ax * bw_ + ay * bz - az * by,
                  aw * by - ax * bz + ay * bw_ + az * bx,
                  aw * bz + ax * by - ay * bx + az * bw_], np.float32)
    q /= max(np.linalg.norm(q), 1e-12)
    return q, (_quat_rotate_np(q1, t2) + t1).astype(np.float32)


def _quat_rotate_np(q, v):
    u = np.asarray(q[1:])
    uv = np.cross(u, v)
    return np.asarray(v + 2.0 * (q[0] * uv + np.cross(u, uv)), np.float32)


def _se3_inverse_np(q, t):
    qc = np.array([q[0], -q[1], -q[2], -q[3]], np.float32)
    return qc, -_quat_rotate_np(qc, t)


class MapCapacityError(RuntimeError):
    """Raised on keyframe-arena or atlas map-slot exhaustion."""


@dataclass(frozen=True)
class SlamConfig:
    """Names and defaults of the reference's SlamConfig.  Neither package
    reads ``motion_search_radius``, ``min_motion_matches`` or
    ``lba_cg_iters``: they are kept so that a configuration of either
    package carries over field for field."""

    width: int
    height: int
    cam_kind: int = cam_mod.PINHOLE
    n_levels: int = 8
    scale_factor: float = 1.2
    max_kf: int = 512
    max_mp: int = 24576
    n_feat: int = 768
    max_obs: int = 16
    # tracking thresholds (reference Tracking.cc)
    min_init_matches: int = 100
    motion_search_radius: float = 15.0
    min_motion_matches: int = 20
    min_track_inliers: int = 30
    min_track_inliers_lost: int = 10
    kf_max_interval: int = 20
    kf_min_interval: int = 3
    kf_ref_ratio: float = 0.9
    recently_lost_frames: int = 60
    imu_init_window_s: float = 2.0
    # mapping
    n_triangulate_neighbors: int = 8
    lba_window: int = 16
    lba_iters: int = 6
    lba_polish_iters: int = 2
    lba_cg_iters: int = 30
    # dense window-BA caps: free cameras beyond lba_cam_cap and window
    # points beyond lba_pt_cap stay fixed
    lba_cam_cap: int = 24
    lba_pt_cap: int = 8192

    @property
    def scale_factors(self) -> np.ndarray:
        return np.array([self.scale_factor ** i
                         for i in range(self.n_levels)], np.float32)

    @property
    def inv_sigma2(self) -> np.ndarray:
        return (1.0 / self.scale_factors ** 2).astype(np.float32)

    @property
    def sigma2(self) -> np.ndarray:
        return (self.scale_factors ** 2).astype(np.float32)

    def map_config(self) -> S.MapConfig:
        return S.MapConfig(max_kf=self.max_kf, max_mp=self.max_mp,
                           n_feat=self.n_feat, max_obs=self.max_obs,
                           n_levels=self.n_levels,
                           scale_factor=self.scale_factor)


def _nanmedian(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` as ``jnp.nanmedian`` takes it (the two middle
    values averaged for an even count, NaN for an empty mask), with no
    host read."""
    n = mask.sum()
    v = torch.sort(torch.where(mask, x, float("inf"))).values
    last = x.shape[0] - 1
    lo = v[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)]
    hi = v[torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)]
    med = torch.where(n % 2 == 1, lo, 0.5 * lo + 0.5 * hi)
    return torch.where(n > 0, med, float("nan"))


@functools.lru_cache(maxsize=None)
def programs(cfg: SlamConfig, kind: int) -> dict:
    """The programs closed over a static config and camera kind (the
    reference's ``_compiled``): tracking (``match_and_pose``,
    ``local_mp_mask``, ``track_frame_step``, ``track_ref_kf``,
    ``update_found_visible``), initialisation (``init_match``,
    ``reconstruct``, ``create_initial_map``, ``initial_gba_and_rescale``),
    mapping (``add_kf_step``, ``cull_map_points``,
    ``triangulate_multi_step``, ``local_ba``, ``cull_pack``,
    ``remove_kf``, ``mapping_epoch``; ``triangulate_step`` and
    ``kf_redundancy_batch``, which no path calls) and the loop server's
    (``fuse_step``, ``refresh_stats``, ``welding_ba``, ``global_ba``;
    ``global_ba_masks`` for the background GBA)."""
    W, H = float(cfg.width), float(cfg.height)
    per_device = {}

    def consts(device):
        """(scale factors, 1/sigma^2, sigma^2 per level) on ``device``."""
        if device not in per_device:
            per_device[device] = tuple(
                torch.tensor(x, device=device) for x in
                (cfg.scale_factors, cfg.inv_sigma2, cfg.sigma2))
        return per_device[device]

    def match_and_pose(ms, frame, q0, t0, cam_params, mp_mask, th_radius,
                       max_dist, ratio):
        sf, is2, _ = consts(ms.mp_pos.device)
        cam = cam_mod.Camera(cam_params, kind)
        feat_mp, n, visible = steps.match_map_to_frame(
            ms, frame, q0, t0, cam, W, H, mp_mask, sf,
            th_radius=th_radius, max_dist=max_dist, ratio=ratio)
        q, t, inlier, n_in = steps.track_pose(ms, frame, feat_mp, q0, t0,
                                              cam, is2)
        return feat_mp, n, q, t, inlier, n_in, visible

    def local_mp_mask(ms, ref_kf, n_local):
        """Map points observed by ref_kf and its top covisible KFs
        (Tracking::UpdateLocalMap approximation)."""
        idx, _, ok = S.best_covisible(ms, ref_kf, n_local)
        K = ms.kf_valid.shape[0]
        P = ms.mp_valid.shape[0]
        dev = ms.mp_valid.device
        kf_sel = torch.zeros(K, dtype=torch.bool, device=dev)
        kf_sel[torch.where(ok, idx, ref_kf).long()] = True
        kf_sel[ref_kf] = True
        fmp = ms.kf_feat_mp
        hit = (fmp >= 0) & kf_sel[:, None]
        mask = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        mask[torch.where(hit, fmp.long(), P).reshape(-1)] = True
        return mask[:P] & ms.mp_valid

    def update_found_visible(ms, feat_mp, inlier, visible):
        P = ms.mp_valid.shape[0]
        found_add = torch.zeros(P, dtype=torch.float32,
                                device=ms.mp_found.device)
        found_add.index_add_(0, torch.clamp(feat_mp, min=0).long(),
                             ((feat_mp >= 0) & inlier).to(torch.float32))
        vis_add = visible.to(torch.float32) + (found_add > 0)
        return ms._replace(
            mp_found=ms.mp_found + found_add,
            mp_visible=ms.mp_visible + torch.clamp(vis_add, max=1.0))

    def track_frame_step(ms, frame, ref_kf, vel_q, vel_t, has_vel,
                         q_last, t_last, q_ext, t_ext, use_ext, cam_params):
        """The per-frame tracking pipeline: constant-velocity (or external)
        prediction -> local-map mask -> coarse match + pose (r=6) ->
        widened retry (r=12) when it keeps < min_track_inliers_lost ->
        fine match + pose (r=1) from the refined pose -> keep the better ->
        found/visible deltas -> velocity and ref-KF-relative pose.
        Returns (ms2, feat_mp, inlier, visible, vec, chain)."""
        dev = ms.mp_pos.device
        sf, is2, _ = consts(dev)
        cam = cam_mod.Camera(cam_params, kind)
        has_vel = torch.as_tensor(has_vel, device=dev)
        use_ext = torch.as_tensor(use_ext, device=dev)
        cv = lie.se3_compose(lie.SE3(vel_q, vel_t), lie.SE3(q_last, t_last))
        q_pred = torch.where(use_ext, q_ext,
                             torch.where(has_vel, cv.q, q_last))
        t_pred = torch.where(use_ext, t_ext,
                             torch.where(has_vel, cv.t, t_last))
        q_pred = lie.quat_normalize(q_pred)
        local_mask = local_mp_mask(ms, ref_kf, 32)

        def stage(q0, t0, th, ratio):
            feat_mp, n, visible = steps.match_map_to_frame(
                ms, frame, q0, t0, cam, W, H, local_mask, sf,
                th_radius=th, max_dist=M.TH_HIGH, ratio=ratio)
            q, t, inlier, n_in = steps.track_pose(ms, frame, feat_mp,
                                                  q0, t0, cam, is2)
            return feat_mp, n, q, t, inlier, n_in, visible

        r1 = stage(q_pred, t_pred, 6.0, 0.9)
        widened = r1[5] < cfg.min_track_inliers_lost
        with TRACER.span("track.read"):  # one read of the coarse count
            widen = bool(widened)
        if widen:  # host branch
            r1 = stage(q_pred, t_pred, 12.0, 0.9)
        feat_mp, n_m, q, t, inlier, n_in, visible = r1
        r2 = stage(q, t, 1.0, 0.8)
        take2 = r2[5] >= n_in
        feat_mp, n_m, q, t, inlier, n_in, visible = (
            torch.where(take2, x2, x1) for x2, x1 in
            zip(r2, (feat_mp, n_m, q, t, inlier, n_in, visible)))
        ms2 = update_found_visible(ms, feat_mp, inlier, visible)
        vel = lie.se3_compose(lie.SE3(q, t),
                              lie.se3_inverse(lie.SE3(q_last, t_last)))
        ref = torch.clamp(torch.as_tensor(ref_kf, device=dev), min=0)
        rel = lie.se3_compose(
            lie.SE3(q, t), lie.se3_inverse(lie.SE3(ms.kf_q[ref],
                                                   ms.kf_t[ref])))
        vec = torch.cat([
            q, t, vel.q, vel.t, rel.q, rel.t,
            torch.stack([n_in.to(torch.float32), widened.to(torch.float32),
                         n_m.to(torch.float32)]),
            q_pred, t_pred])
        # next frame's chain: a failed frame heals to the prediction with
        # the velocity unchanged
        okf = n_in >= cfg.min_track_inliers_lost
        chain = (torch.where(okf, q, q_pred), torch.where(okf, t, t_pred),
                 torch.where(okf, vel.q, vel_q),
                 torch.where(okf, vel.t, vel_t), okf | has_vel)
        return ms2, feat_mp, inlier, visible, vec, chain

    def track_ref_kf(ms, frame, ref_kf, q0, t0, cam_params):
        """TrackReferenceKeyFrame fallback: brute-force match of the frame
        against the reference KF's map-point features, then pose
        optimisation from the given pose.
        Returns (feat_mp, q, t, inlier, n_in, n_matches)."""
        _, is2, _ = consts(ms.mp_pos.device)
        cam = cam_mod.Camera(cam_params, kind)
        kf_mp = ms.kf_feat_mp[ref_kf]
        has_r = ms.kf_feat_valid[ref_kf] & (kf_mp >= 0)
        res = M.search_by_brute_force(
            frame.desc, frame.valid, frame.angle,
            ms.kf_feat_desc[ref_kf], has_r, ms.kf_feat_angle[ref_kf])
        mp = kf_mp[torch.clamp(res.idx, min=0).long()]
        ok = (res.ok & (mp >= 0) & ms.mp_valid[torch.clamp(mp, min=0).long()]
              & frame.valid)
        feat_mp = torch.where(ok, mp, S.NO_MP)
        q, t, inlier, n_in = steps.track_pose(ms, frame, feat_mp, q0, t0,
                                              cam, is2)
        return feat_mp, q, t, inlier, n_in, ok.to(torch.int32).sum()

    # ---- initialisation

    def init_match(frame1, frame2):
        return M.search_for_initialization(
            frame1.uv, frame1.desc, frame1.angle, frame1.valid,
            frame2.uv, frame2.desc, frame2.angle, frame2.valid,
            window=100.0, ratio=0.9)

    def reconstruct(uv1, uv2, valid, Kmat, probe):
        return twoview.reconstruct_two_views(uv1, uv2, valid, Kmat, probe)

    def create_initial_map(ms, frame1, frame2, q2, t2, mp_src_feat1,
                           mp_src_feat2, mp_ok, X, cam_params, map_id,
                           agent, ts1, ts2):
        """Two keyframes + the triangulated points + wiring (reference
        Tracking::CreateInitialMapMonocular).  Returns (ms, kf1, kf2)."""
        dev = ms.mp_pos.device
        none = torch.full_like(frame1.level, S.NO_MP)
        ms, kf1 = S.add_keyframe(
            ms, lie.quat_identity(device=dev), torch.zeros(3, device=dev),
            agent, map_id, ts1, 0, frame1.uv, frame1.level, frame1.angle,
            frame1.desc, frame1.valid, none, cam_params=cam_params)
        ms, kf2 = S.add_keyframe(
            ms, q2, t2, agent, map_id, ts2, 1, frame2.uv, frame2.level,
            frame2.angle, frame2.desc, frame2.valid, none,
            cam_params=cam_params)
        ms, _ = steps.add_triangulated_points(ms, kf1, kf2, mp_ok, X,
                                              mp_src_feat1, mp_src_feat2,
                                              map_id)
        ms = S.update_covis_for_kf(ms, kf2)
        ms = S.update_covis_for_kf(ms, kf1)
        ms = S.refresh_mp_stats(ms, ms.mp_valid, consts(dev)[0])
        ms = ms._replace(map_valid=S.set_at(ms.map_valid, map_id, True))
        return ms, kf1, kf2

    def initial_gba_and_rescale(ms, kf1, map_id):
        """20-iteration BA of the new two-KF map, then inverse median depth
        normalisation in the first KF's frame, scoped to ``map_id``.
        Returns (ms, ok)."""
        sf, is2, _ = consts(ms.mp_pos.device)
        in_map_kf = ms.kf_valid & (ms.kf_map == map_id)
        in_map_mp = ms.mp_valid & (ms.mp_map == map_id)
        prob = steps.build_window_problem(
            ms, S.set_at(in_map_kf, kf1, False), is2, 4, cfg.n_feat)
        ms = steps.apply_window_result(
            ms, prob, bw.run_window_ba_dense(prob, kind, iters=20))
        Xc = lie.quat_rotate(ms.kf_q[kf1][None], ms.mp_pos) + ms.kf_t[kf1]
        med = _nanmedian(Xc[:, 2], in_map_mp)
        inv = 1.0 / torch.clamp(med, min=1e-6)
        ms = ms._replace(
            mp_pos=torch.where(in_map_mp[:, None], ms.mp_pos * inv,
                               ms.mp_pos),
            kf_t=torch.where(in_map_kf[:, None], ms.kf_t * inv, ms.kf_t),
            mp_min_dist=torch.where(in_map_mp, ms.mp_min_dist * inv,
                                    ms.mp_min_dist),
            mp_max_dist=torch.where(in_map_mp, ms.mp_max_dist * inv,
                                    ms.mp_max_dist))
        ms = S.refresh_mp_stats(ms, in_map_mp, sf)
        return ms, (med > 1e-3) & (in_map_mp.sum() > 50)

    # ---- local mapping

    def add_kf_step(ms, frame, q, t, feat_mp, agent, map_id, ts,
                    agent_kf_id, cam_params):
        ms, kf = S.add_keyframe(ms, q, t, agent, map_id, ts, agent_kf_id,
                                frame.uv, frame.level, frame.angle,
                                frame.desc, frame.valid, feat_mp,
                                cam_params=cam_params)
        P = ms.mp_valid.shape[0]
        touched = S.set_rows(
            torch.zeros(P, dtype=torch.bool, device=feat_mp.device),
            torch.where(feat_mp >= 0, feat_mp, P).long(), True)
        ms = S.refresh_mp_stats_compact(
            ms, S.compact_indices(touched, cfg.n_feat),
            consts(feat_mp.device)[0])
        return ms, kf

    def cull_map_points(ms, current_kf):
        """MapPointCulling of the points the current KF's agent created,
        with recency counted in that agent's own KF ids.
        Returns (ms, n_culled)."""
        same_agent = ms.mp_first_agent == ms.kf_agent[current_kf]
        ratio = ms.mp_found / torch.clamp(ms.mp_visible, min=1.0)
        age = ms.kf_agent_kf_id[current_kf] - ms.mp_first_agent_kf
        young_dead = (age >= 2) & (age <= 4) & (ms.mp_nobs <= 2)
        weak = (ratio < 0.25) & (ms.mp_visible >= 4)
        kill = ms.mp_valid & same_agent & (weak | young_dead)
        return S.remove_map_points(ms, kill), kill.to(torch.int32).sum()

    def triangulate_multi_step(ms, kf, neighbors, neighbors_ok, map_id):
        """CreateNewMapPoints against all neighbours at once; a feature
        triangulated with several keeps the first (best-covisible) one.
        Returns (ms, n_new, n_dropped)."""
        s2 = consts(ms.mp_pos.device)[2]
        ok, X, f1, f2 = steps.triangulate_with_neighbor(ms, kf, neighbors,
                                                        kind, s2)
        ok = ok & neighbors_ok[:, None]
        first = torch.argmax(ok.to(torch.int32), 0)
        any_ok = ok.any(0)
        fi = torch.arange(ok.shape[1], device=ok.device)
        ms, n_drop = steps.add_triangulated_points(
            ms, kf, neighbors[first], any_ok, X[first, fi], f1,
            f2[first, fi], map_id)
        ms = S.update_covis_for_kf(ms, kf)
        return ms, any_ok.to(torch.int32).sum(), n_drop

    def triangulate_step(ms, kf1, kf2, map_id):
        """CreateNewMapPoints against one neighbour ``kf2``.  Returns (ms,
        n_new, n_dropped)."""
        s2 = consts(ms.mp_pos.device)[2]
        kf2 = torch.as_tensor(kf2, device=ms.mp_pos.device)
        ok, X, f1, f2 = steps.triangulate_with_neighbor(ms, kf1, kf2[None],
                                                        kind, s2)
        ms, n_drop = steps.add_triangulated_points(ms, kf1, kf2, ok[0], X[0],
                                                   f1, f2[0], map_id)
        ms = S.update_covis_for_kf(ms, kf1)
        return ms, ok.to(torch.int32).sum(), n_drop

    def kf_redundancy_batch(ms, cands, cand_ok):
        """``keyframe_redundancy`` of every culling candidate at once:
        (redundant fraction, tracked points), 0 where not ``cand_ok``."""
        frac, ntr = steps.keyframe_redundancy(ms, torch.clamp(cands, min=0))
        return (torch.where(cand_ok, frac, 0.0),
                torch.where(cand_ok, ntr, 0))

    def _window_mask(ms, center_kf):
        idx, _, ok = S.best_covisible(ms, center_kf, cfg.lba_window)
        mask = torch.zeros_like(ms.kf_valid)
        mask[torch.where(ok, idx, center_kf).long()] = True
        mask[center_kf] = True
        return mask & ms.kf_valid

    def _map_anchors(ms, kf):
        """The two oldest KFs (by kf_seq) of kf's map: its gauge."""
        in_map = ms.kf_valid & (ms.kf_map == ms.kf_map[kf])
        seq = torch.where(in_map, ms.kf_seq, S.BIG_SEQ)
        a1 = torch.argmin(seq)
        return a1, torch.argmin(S.set_at(seq, a1, S.BIG_SEQ))

    def _lba_core(ms, opt_mask):
        """Windowed BA on the dense solver: robust LM, a polish on the
        inliers, write-back, and the outlier observations dropped with a
        reverse-table repair.  Below a 0.4 inlier fraction the polish
        keeps every edge and nothing is dropped.  Returns (ms, window
        point mask, [free cameras, edges, final inliers])."""
        is2 = consts(ms.mp_pos.device)[1]
        prob = steps.build_window_problem(ms, opt_mask, is2,
                                          cfg.lba_cam_cap, cfg.lba_pt_cap)
        res = bw.run_window_ba_dense(prob, kind, iters=cfg.lba_iters)
        n_valid = torch.clamp(prob.pm_valid.sum(), min=1).to(torch.float32)
        healthy = res.pm_inlier.sum() / n_valid >= 0.4
        polish = res.pm_inlier | (~healthy & prob.pm_valid)
        res2 = bw.run_window_ba_dense(
            prob._replace(cam_q=res.cam_q, cam_t=res.cam_t, pts=res.pts),
            kind, iters=cfg.lba_polish_iters, pm_edge_mask=polish,
            robust=True)
        drop = (prob.pm_valid & ~res2.pm_inlier
                & (res2.pm_inlier.sum() / n_valid >= 0.4))
        ms = steps.apply_window_result(ms, prob, res2, drop_pm=drop)
        ms = steps.repair_window_reverse_obs(ms, prob, drop)
        stats = torch.stack([prob.cam_valid.sum(), prob.pm_valid.sum(),
                             res2.pm_inlier.sum()])
        return ms, steps.window_pt_mask(ms, prob), stats

    def _local_ba(ms, center_kf):
        """Window of the center KF and its covisibles, with its map's two
        oldest KFs held fixed.  Returns (ms, window stats)."""
        a1, a2 = _map_anchors(ms, center_kf)
        opt_mask = _window_mask(ms, center_kf)
        opt_mask[a1] = False
        opt_mask[a2] = False
        ms, _, stats = _lba_core(ms, opt_mask)
        return ms, stats

    def local_ba(ms, center_kf):
        return _local_ba(ms, center_kf)[0]

    def welding_ba(ms, center_kf, adjust_side):
        """Merge-welding BA (the reference's merge overload of
        LocalBundleAdjustment): the covisible window of the merging KF
        restricted to ``adjust_side`` (the absorbed map) is optimised, the
        merge target's keyframes observing its points stay fixed.
        Returns (ms, optimised KF mask, optimised point mask)."""
        opt_mask = _window_mask(ms, center_kf) & adjust_side
        ms, pt_free, _ = _lba_core(ms, opt_mask)
        return ms, opt_mask, pt_free

    def global_ba_masks(ms, map_id):
        """Full-map BA (RunGlobalBundleAdjustment, 10 iterations) with the
        map's oldest KF fixed, on the dense solver at the arena's caps.
        Returns (ms, optimised KF mask, optimised point mask)."""
        in_map = ms.kf_valid & (ms.kf_map == map_id)
        anchor = torch.argmin(torch.where(in_map, ms.kf_seq, S.BIG_SEQ))
        opt_mask = S.set_at(in_map, anchor, False)
        prob = steps.build_window_problem(
            ms, opt_mask, consts(ms.mp_pos.device)[1], cfg.max_kf, cfg.max_mp)
        ms2 = steps.apply_window_result(
            ms, prob, bw.run_window_ba_dense(prob, kind, iters=10))
        return ms2, opt_mask, steps.window_pt_mask(ms, prob)

    def global_ba(ms, map_id):
        return global_ba_masks(ms, map_id)[0]

    def fuse_step(ms, kf, mp_mask):
        """Fuse the masked points into ``kf``, then rebuild the reverse
        observations and kf's covisibility.  Returns (ms, n_fused)."""
        ms, n, _ = steps.fuse_into_kf(ms, kf, mp_mask, kind, W, H,
                                      consts(ms.mp_pos.device)[0])
        ms = S.rebuild_reverse_obs(ms)
        return S.update_covis_for_kf(ms, kf), n

    def refresh_stats(ms, mp_mask):
        return S.refresh_mp_stats(ms, mp_mask, consts(ms.mp_pos.device)[0])

    def cull_pack(ms, kf, protected_extra):
        """The host's KeyFrameCulling inputs as one [10, 12] array: per
        top-10 covisible, (slot, eligible, redundant fraction, tracked
        points, parent, pose relative to the parent q (4), t (3)).
        Protected: kf itself, its map's two oldest KFs, loop-edge
        endpoints and the slots in ``protected_extra``."""
        K = ms.kf_valid.shape[0]
        idx, _, ok = S.best_covisible(ms, kf, 10)
        idxc = torch.clamp(idx, min=0).long()
        frac, ntr = steps.keyframe_redundancy(ms, idxc)
        a1, a2 = _map_anchors(ms, kf)
        loop_ep = torch.zeros(K + 1, dtype=torch.bool, device=idx.device)
        for ends in (ms.loop_i, ms.loop_j):
            loop_ep[torch.where(ms.loop_valid, ends, K).long()] = True
        prot = ((idx == kf) | (idx == a1) | (idx == a2) | loop_ep[idxc]
                | (idx[:, None] == protected_extra[None, :]).any(1))
        par = ms.kf_parent[idxc]
        parc = torch.clamp(par, min=0).long()
        T_cp = lie.se3_compose(
            lie.SE3(ms.kf_q[idxc], ms.kf_t[idxc]),
            lie.se3_inverse(lie.SE3(ms.kf_q[parc], ms.kf_t[parc])))
        f32 = torch.float32
        return torch.cat([
            idx.to(f32)[:, None], (ok & ~prot).to(f32)[:, None],
            frac[:, None], ntr.to(f32)[:, None], par.to(f32)[:, None],
            T_cp.q, T_cp.t], dim=1)

    def mapping_epoch(ms, kf, map_id, protected_extra):
        """The per-KF LocalMapping body: point culling -> triangulation
        against the best covisibles -> stat refresh -> fuse -> stat
        refresh -> windowed BA.  Returns (ms, [11, 12]): row 0 holds the
        counters (culled, new, dropped, fused) and the window BA's free
        cameras, edges and final inliers (columns the reference leaves
        zero), rows 1-10 the culling pack."""
        sf = consts(ms.mp_pos.device)[0]
        ms, n_culled = cull_map_points(ms, kf)
        nb_idx, _, nb_ok = S.best_covisible(ms, kf,
                                            cfg.n_triangulate_neighbors)
        before = ms.mp_valid
        ms, n_new, n_drop = triangulate_multi_step(ms, kf, nb_idx, nb_ok,
                                                   map_id)
        new_pts = ms.mp_valid & ~before
        ms = S.refresh_mp_stats_compact(
            ms, S.compact_indices(new_pts, cfg.n_feat), sf)
        ms, n_fused, touched = steps.fuse_into_kf(
            ms, kf, local_mp_mask(ms, kf, 16), kind, W, H, sf)
        ms = S.rebuild_reverse_obs(ms)
        ms = S.update_covis_for_kf(ms, kf)
        ms = S.refresh_mp_stats_compact(
            ms, S.compact_indices(touched | new_pts, 3 * cfg.n_feat), sf)
        ms, lba = _local_ba(ms, kf)
        counts = torch.cat([torch.stack([n_culled, n_new, n_drop, n_fused]),
                            lba]).to(torch.float32)
        row0 = torch.cat([counts, torch.zeros(5, device=counts.device)])
        return ms, torch.cat([row0[None],
                              cull_pack(ms, kf, protected_extra)])

    return {
        "match_and_pose": match_and_pose,
        "local_mp_mask": local_mp_mask,
        "track_frame_step": track_frame_step,
        "track_ref_kf": track_ref_kf,
        "update_found_visible": update_found_visible,
        "init_match": init_match,
        "reconstruct": reconstruct,
        "create_initial_map": create_initial_map,
        "initial_gba_and_rescale": initial_gba_and_rescale,
        "add_kf_step": add_kf_step,
        "cull_map_points": cull_map_points,
        "triangulate_multi_step": triangulate_multi_step,
        "triangulate_step": triangulate_step,
        "kf_redundancy_batch": kf_redundancy_batch,
        "local_ba": local_ba,
        "cull_pack": cull_pack,
        "remove_kf": S.remove_keyframe,
        "mapping_epoch": mapping_epoch,
        "welding_ba": welding_ba,
        "global_ba": global_ba,
        "global_ba_masks": global_ba_masks,
        "fuse_step": fuse_step,
        "refresh_stats": refresh_stats,
    }


@dataclass
class AgentState:
    """Per-agent tracking state (the reference's AgentState)."""

    agent_id: int
    cam: cam_mod.Camera
    state: int = NO_IMAGES_YET
    map_id: int = 0
    q: Optional[np.ndarray] = None        # current T_cw (host copy)
    t: Optional[np.ndarray] = None
    vel_q: Optional[np.ndarray] = None    # constant-velocity model
    vel_t: Optional[np.ndarray] = None
    # mono-inertial state, body frame == camera frame: world velocity
    # (map units / s) and the gyro / acc biases
    imu_calib: Optional[imu_mod.ImuCalib] = None
    vel_w: Optional[np.ndarray] = None
    bias_g: Optional[np.ndarray] = None
    bias_a: Optional[np.ndarray] = None
    # the monocular map is neither metric nor gravity-aligned: the IMU
    # prediction waits for a gravity / scale / bias estimate over a
    # buffered window, and holds only in the map it was made in
    imu_initialized: bool = False
    imu_init_map: int = -1
    imu_scale: float = 1.0                 # metres per map unit
    gravity_w: Optional[np.ndarray] = None  # metric gravity, map frame
    imu_buf: List = field(default_factory=list)  # (ts, q, t, gyro, acc, dts)
    last_ts: Optional[float] = None
    # frames the coarse stage lost and the widened search rescued (the
    # prediction's quality; the IMU should keep it near zero)
    n_fallback: int = 0
    # ref-KF-relative pose of the current frame from the tracking step
    last_rel: Optional[tuple] = None
    # device-resident (q, t, vel_q, vel_t, has_vel) for the next frame's
    # prediction; None: the next frame uploads the host pose
    dev_chain: Optional[tuple] = None
    init_frame: Optional[steps.FrameObs] = None
    init_ts: float = 0.0
    # the viewer's inputs, left on the device: the last completed frame
    # and its features' map points (set where the tracked pose is)
    last_frame: Optional[steps.FrameObs] = None
    last_feat_mp: Optional[torch.Tensor] = None
    ref_kf: int = -1
    ref_kf_tracked: int = 0
    frames_since_kf: int = 0
    # keyframe insertions refused by a busy worker or a stale snapshot
    kf_insertions_refused: int = 0
    next_agent_kf_id: int = 0
    frames_lost: int = 0
    # deferred frames awaiting their state machine, oldest first
    # (SlamSystem.pipeline; at most pipeline_depth)
    pending_q: List = field(default_factory=list)
    trajectory: List = field(default_factory=list)  # (ts, ref, q, t, state)
    times_ms: List = field(default_factory=list)
    calls: int = 0           # track calls so far: the frame id's number
    # the RANSAC draws of the agent's two-view initialisation and
    # relocalization (``agent_seed``), so that no agent's draws depend on
    # how many the others made
    gen: Optional[torch.Generator] = None


def agent_seed(seed: int, agent_id: int) -> int:
    """The seed of agent ``agent_id``'s generator in a system seeded with
    ``seed``: ``seed`` itself for agent 0, so that a one-agent system
    draws what one generator of the system drew; drawn from
    ``SeedSequence([seed, agent_id])`` for the others."""
    if agent_id == 0:
        return seed
    return int(np.random.SeedSequence([seed % 2**64, agent_id])
               .generate_state(1, np.uint64)[0])


class SlamSystem:
    """Shared map arena + N agents.  Synchronous by default: each keyframe
    runs its local-mapping epoch before ``track`` returns.  With
    ``async_mapping`` a worker thread runs the mapping and server epochs
    and is the only structural writer besides keyframe insertion and
    initialisation, which take ``_ms_lock``; set ``pipeline`` (and
    ``pipeline_depth``) to defer each frame's result, so ``track``
    returns a lagged state.  Call ``flush`` before reading poses or
    trajectories and ``shutdown`` at the end.  Tensors live on the device
    of ``cam.params``."""

    def __init__(self, cfg: SlamConfig, cam: cam_mod.Camera, seed: int = 0,
                 async_mapping: bool = False):
        self.cfg = cfg
        self.cam = cam
        self.device = cam.params.device
        self.ms = S.init_map_state(cfg.map_config(), self.device)
        self.fns = programs(cfg, cfg.cam_kind)
        self.agents: List[AgentState] = []
        self.seed = seed         # of each agent's generator (agent_seed)
        self.events: List[str] = []
        self.mp_dropped = 0      # triangulations dropped on arena overflow
        self.server = None       # optional LoopServer (slam/server.py)
        self.timers = Timers()
        # culled KF -> (parent, q_rel, t_rel): trajectory rows that name a
        # culled KF resolve through its live ancestors
        self.culled_kf = {}
        self.kf_culled = 0       # keyframes removed by KeyFrameCulling
        # per mapping epoch: (agent, map, row 0 of the packed result)
        self.epochs: List[tuple] = []
        # bumped by every structural change (initialisation, a mapping
        # epoch, a server epoch): a frame's snapshot is structurally
        # current while the epoch it read is
        self.ms_epoch = 0
        self.pipeline = False
        self.pipeline_depth = 1
        self.async_mapping = async_mapping
        self._worker_error = None
        # mapping jobs queued or running: the back-pressure signal (stats
        # jobs do not refuse insertions)
        self._pending_mapping = 0
        if async_mapping:
            self._ms_lock = threading.Lock()
            self._jobs = queue.Queue(maxsize=8)
            self._worker = threading.Thread(target=self._mapping_worker,
                                            daemon=True)
            self._worker.start()

    def _probe(self, shape, agent_id: int) -> torch.Tensor:
        """Uniform RANSAC draws from the agent's generator."""
        return torch.rand(shape, generator=self.agents[agent_id].gen).to(
            self.device)

    def _structural_lock(self):
        return (self._ms_lock if self.async_mapping
                else contextlib.nullcontext())

    def _mapping_worker(self):
        """The back end: applies tracking's found/visible deltas and runs
        the mapping epoch, then the server's, of each queued keyframe."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            job = self._jobs.get()
            if job is None:
                self._jobs.task_done()
                return
            try:
                with self._ms_lock:
                    if job[0] == "stats":
                        # the deltas index point slots of their snapshot;
                        # a mapping epoch since may have recycled them
                        _, epoch, payload = job
                        if epoch == self.ms_epoch:
                            self.ms = self.fns["update_found_visible"](
                                self.ms, *payload)
                    else:
                        # the inserting frame's span, when traced
                        _, aid, kf, *cause = job
                        try:
                            with TRACER.adopt(*cause):
                                self._local_mapping(self.agents[aid], kf)
                                self.ms_epoch += 1
                                if self.server is not None:
                                    self.server.process_keyframe(aid, kf)
                                    self.ms_epoch += 1
                        finally:
                            self._pending_mapping -= 1
            except Exception as e:   # re-raised by track() and flush()
                self._worker_error = e
            finally:
                self._jobs.task_done()

    def _raise_worker_error(self):
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def flush(self):
        """Finish the work queued behind the frames tracked so far: the
        deferred frames, the worker's jobs and a pending background global
        BA; re-raise the worker's error."""
        self.drain()
        if self.async_mapping:
            self._jobs.join()
        if self.server is not None:
            self.server.flush_gba()
        self._raise_worker_error()

    def shutdown(self):
        """Flush, then stop and join the worker."""
        self.flush()
        if self.async_mapping and self._worker.is_alive():
            self._jobs.put(None)
            self._worker.join(timeout=30)

    def add_agent(self, cam: Optional[cam_mod.Camera] = None) -> int:
        """Register an agent (optionally with its own intrinsics, same
        camera kind) in a fresh map slot."""
        aid = len(self.agents)
        a = AgentState(agent_id=aid, cam=self.cam if cam is None else cam,
                       gen=torch.Generator().manual_seed(
                           agent_seed(self.seed, aid)))
        a.map_id = self._alloc_map_id()
        self.agents.append(a)
        return a.agent_id

    def _alloc_map_id(self) -> int:
        """Lowest atlas map slot neither live nor held by an agent."""
        used = {a.map_id for a in self.agents if a.map_id >= 0}
        mv = self.ms.map_valid.cpu().numpy()
        for m in range(mv.shape[0]):
            if not mv[m] and m not in used:
                return m
        raise MapCapacityError(
            f"atlas exhausted: all {mv.shape[0]} map slots live "
            f"(raise MapConfig.max_maps)")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def track(self, agent_id: int, frame: steps.FrameObs, ts: float,
              imu=None):
        """Process one frame of one agent (reference Tracking::Track);
        returns (state, (q, t) of T_cw or None), lagged by the deferred
        frames when pipelined.  ``imu``: optional (gyro [N, 3], acc [N, 3],
        dts [N]) measured since the previous frame, numpy or tensors;
        after the inertial initialisation they predict the pose in place
        of the constant-velocity model."""
        t0 = time.perf_counter()
        self._raise_worker_error()
        a = self.agents[agent_id]
        call, a.calls = a.calls, a.calls + 1
        with TRACER.frame(agent_id, call), TRACER.span("track"):
            # complete the oldest deferred frames down to the lag bound
            while len(a.pending_q) >= max(self.pipeline_depth, 1):
                self._complete_pending(a)
            if a.state in (NO_IMAGES_YET, NOT_INITIALIZED):
                self.drain_agent(a)
                a.last_rel = None
                with TRACER.span("track.init"):
                    self._monocular_initialization(a, frame, ts)
                self._post_frame(a, frame, ts, t0)
            else:
                self._track_frame(a, frame, ts, t0, imu)
                if not self.pipeline:
                    self._post_frame(a, frame, ts, t0)
        return a.state, (a.q, a.t) if a.q is not None else None

    def _post_frame(self, a: AgentState, frame, ts, t0):
        a.last_frame = frame
        a.times_ms.append((time.perf_counter() - t0) * 1e3)
        if a.q is not None:
            self._record_trajectory(a, ts)
        a.last_ts = ts

    def _complete_pending(self, a: AgentState):
        """Run the state machine of the agent's oldest deferred frame."""
        pend = a.pending_q.pop(0)
        a.last_rel = None
        self._finish_frame(a, pend)
        self._post_frame(a, pend["frame"], pend["ts"], pend["t0"])

    def drain_agent(self, a: AgentState):
        while a.pending_q:
            self._complete_pending(a)

    def drain(self):
        """Complete every agent's deferred frames."""
        for a in self.agents:
            self.drain_agent(a)

    # ------------------------------------------------------------------
    def _default_imu_calib(self) -> imu_mod.ImuCalib:
        """EuRoC's IMU noise (ORB-SLAM3's EuRoC monocular-inertial
        settings)."""
        return imu_mod.ImuCalib(*(torch.tensor(x, device=self.device)
                                  for x in (1.7e-4, 2e-3, 1.9e-5, 3e-3)))

    def _imu_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return self._tensor(x)

    def _imu_predict(self, a: AgentState, imu):
        """Reference Tracking::PredictStateIMU, after the inertial
        initialisation: the last pose and world velocity propagated
        through the frame's preintegrated window in metric units
        (``imu_scale``) under the estimated map-frame gravity, then mapped
        back to map units.  Returns the predicted (q_cw, t_cw) on the
        device."""
        gyro, acc, dts = (self._imu_tensor(x) for x in imu)
        calib = a.imu_calib or self._default_imu_calib()
        z3 = np.zeros(3, np.float32)
        bg = self._tensor(z3 if a.bias_g is None else a.bias_g)
        ba = self._tensor(z3 if a.bias_a is None else a.bias_a)
        pre = imu_mod.preintegrate(
            gyro, acc, dts, torch.ones(dts.shape[0], dtype=torch.bool,
                                       device=self.device), bg, ba, calib)
        R_wb = lie.quat_to_matrix(self._tensor(a.q)).T   # body == camera
        C = -R_wb @ self._tensor(a.t)
        s = a.imu_scale
        v_w = self._tensor(z3 if a.vel_w is None else a.vel_w)
        g_w = self._tensor([0.0, 0.0, -imu_mod.GRAVITY]
                           if a.gravity_w is None else a.gravity_w)
        R2, _, p2 = imu_mod.predict_state(pre, R_wb, s * v_w, s * C, bg, ba,
                                          gravity=g_w)
        return lie.quat_from_matrix(R2.T), -R2.T @ (p2 / s)

    def _imu_buffer_and_init(self, a: AgentState, ts: float, imu):
        """Buffer the tracked pose with its IMU window and, once the
        buffer spans ``imu_init_window_s`` of contiguous tracking, run the
        mono-inertial initialisation (reference LocalMapping::InitializeIMU
        -> InertialOptimization): the visual poses held fixed, gravity
        direction, map scale, shared biases and per-state velocities
        estimated.  A result out of range drops the oldest half of the
        buffer."""
        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to(torch.float32).cpu().numpy()
            return np.asarray(x, np.float32)

        a.imu_buf.append((ts, np.asarray(a.q, np.float32),
                          np.asarray(a.t, np.float32),
                          *(host(x) for x in imu)))
        if len(a.imu_buf) > 64:
            a.imu_buf = a.imu_buf[-64:]
        if a.imu_initialized and a.imu_init_map == a.map_id:
            return
        buf = a.imu_buf
        if (len(buf) < 8
                or buf[-1][0] - buf[0][0] < self.cfg.imu_init_window_s):
            return
        # at most 16 nav states; the samples between two selected states
        # are concatenated (preintegrating the merged window)
        K = len(buf)
        sel = np.unique(np.linspace(0, K - 1, min(K, 16)).round()
                        .astype(int))
        segs = [[np.concatenate([buf[i][c] for i in range(lo + 1, hi + 1)])
                 for c in (3, 4, 5)] for lo, hi in zip(sel[:-1], sel[1:])]
        E, Lmax = len(segs), max(g.shape[0] for g, _, _ in segs)
        G = np.zeros((E, Lmax, 3), np.float32)
        Ac = np.zeros((E, Lmax, 3), np.float32)
        Dt = np.zeros((E, Lmax), np.float32)
        Vm = np.zeros((E, Lmax), bool)
        for m, (g, ac, dt) in enumerate(segs):
            n = g.shape[0]
            G[m, :n], Ac[m, :n], Dt[m, :n], Vm[m, :n] = g, ac, dt, True
        calib = a.imu_calib or self._default_imu_calib()
        z3 = torch.zeros(3, device=self.device)
        pre = imu_mod.preintegrate(
            self._tensor(G), self._tensor(Ac), self._tensor(Dt),
            torch.as_tensor(Vm, device=self.device), z3, z3, calib)
        Ks = len(sel)
        idx = torch.arange(Ks, dtype=torch.int32, device=self.device)
        iedges = vi_mod.InertialEdges(
            i=idx[:-1], j=idx[1:], preint=pre,
            valid=torch.ones(Ks - 1, dtype=torch.bool, device=self.device))
        Rwg, s, bg, ba, vel = vi_mod.inertial_optimization(
            self._tensor(np.stack([buf[i][1] for i in sel])),
            self._tensor(np.stack([buf[i][2] for i in sel])),
            torch.ones(Ks, dtype=torch.bool, device=self.device), iedges,
            calib, fix_scale=False, iters=40)
        g0 = torch.tensor([0.0, 0.0, -imu_mod.GRAVITY], device=self.device)
        res = torch.cat([s[None], bg, ba, Rwg @ g0, vel[-1],
                         vel.reshape(-1)]).cpu().numpy()   # one read
        s_f = float(res[0])
        if not (np.isfinite(s_f) and 0.02 < s_f < 50.0
                and np.isfinite(res[1:7]).all()
                and np.isfinite(res[13:]).all()):
            a.imu_buf = a.imu_buf[len(a.imu_buf) // 2:]
            return
        a.bias_g, a.bias_a = res[1:4], res[4:7]
        a.imu_scale = s_f
        a.gravity_w = res[7:10]
        a.vel_w = res[10:13] / np.float32(s_f)       # map units / s
        a.imu_initialized = True
        a.imu_init_map = a.map_id
        self.events.append(f"IMU_INIT agent={a.agent_id} map={a.map_id} "
                           f"scale={s_f:.4f}")

    # ------------------------------------------------------------------
    def _monocular_initialization(self, a: AgentState, frame, ts):
        cfg = self.cfg
        if a.init_frame is None or a.state == NO_IMAGES_YET:
            a.init_frame, a.init_ts = frame, ts
            a.state = NOT_INITIALIZED
            return
        res = self.fns["init_match"](a.init_frame, frame)
        if int(res.ok.sum()) < cfg.min_init_matches:
            a.init_frame, a.init_ts = frame, ts   # re-anchor
            return
        # row i of frame 1 is matched to row idx[i] of frame 2
        uv1 = a.init_frame.uv
        uv2 = frame.uv[torch.clamp(res.idx, min=0).long()]
        if a.cam.kind == cam_mod.KANNALA_BRANDT8:
            # the two-view machinery is pinhole geometry
            uv1 = cam_mod.undistort_points(a.cam, uv1)
            uv2 = cam_mod.undistort_points(a.cam, uv2)
        rec = self.fns["reconstruct"](uv1, uv2, res.ok, a.cam.K(),
                                      self._probe((200, 8), a.agent_id))
        if not bool(rec.ok):
            return
        self._kf_capacity_check(2)
        with self._structural_lock():
            ms, kf1, kf2 = self.fns["create_initial_map"](
                self.ms, a.init_frame, frame, lie.quat_from_matrix(rec.R21),
                rec.t21, torch.arange(cfg.n_feat, dtype=torch.int32,
                                      device=self.device),
                torch.clamp(res.idx, min=0), rec.is_triangulated & res.ok,
                rec.points3d, a.cam.params, a.map_id, a.agent_id,
                float(a.init_ts), float(ts))
            ms, ok = self.fns["initial_gba_and_rescale"](ms, kf1, a.map_id)
            if not bool(ok):
                return
            self.ms = ms
            self.ms_epoch += 1
        kf2 = int(kf2)
        a.state = OK
        a.ref_kf = kf2
        a.q = self.ms.kf_q[kf2].cpu().numpy()
        a.t = self.ms.kf_t[kf2].cpu().numpy()
        a.last_feat_mp = self.ms.kf_feat_mp[kf2]
        a.vel_q, a.vel_t = None, None
        a.next_agent_kf_id = 2
        a.frames_since_kf = 0
        a.ref_kf_tracked = int((self.ms.kf_feat_mp[kf2] >= 0).sum())
        self.events.append(f"INIT agent={a.agent_id} map={a.map_id} "
                           f"kfs=({int(kf1)},{kf2}) "
                           f"mps={int(self.ms.mp_valid.sum())}")

    # ------------------------------------------------------------------
    def _track_frame(self, a: AgentState, frame, ts, t0, imu=None):
        # an IMU prediction starts from the host's current pose: the
        # agent's deferred frames complete first
        use_imu = (imu is not None and a.q is not None
                   and a.last_ts is not None and a.imu_initialized
                   and a.imu_init_map == a.map_id)
        if use_imu:
            self.drain_agent(a)
            q_ext, t_ext = self._imu_predict(a, imu)
        else:
            q_ext = self._tensor([1, 0, 0, 0])
            t_ext = self._tensor(np.zeros(3))
        # the epoch is read before the snapshot: a publication between the
        # two reads pairs a newer map with an older epoch, which fails the
        # insertion check conservatively, never the reverse
        snap_epoch = self.ms_epoch
        ms = self.ms
        # the chain state stays on the device between frames unless the
        # host pose diverged from it
        if a.dev_chain is not None:
            q_last, t_last, vel_q, vel_t, has_vel = a.dev_chain
        else:
            q_last, t_last = self._tensor(a.q), self._tensor(a.t)
            has_vel = a.vel_q is not None
            vel_q = self._tensor(a.vel_q if has_vel else [1, 0, 0, 0])
            vel_t = self._tensor(a.vel_t if has_vel else np.zeros(3))
        with TRACER.span("track.step"):
            (ms2, feat_mp, inlier, visible, vec,
             a.dev_chain) = self.fns["track_frame_step"](
                ms, frame, max(a.ref_kf, 0), vel_q, vel_t, has_vel, q_last,
                t_last, q_ext, t_ext, use_imu, a.cam.params)
        pend = dict(ms=ms, ms2=ms2, feat_mp=feat_mp, inlier=inlier,
                    visible=visible, vec=vec, frame=frame, ts=ts, t0=t0,
                    imu=imu, snap_epoch=snap_epoch, ref_kf=max(a.ref_kf, 0))
        if self.pipeline:
            if vec.is_cuda:
                # start the read now: a non-blocking copy into pinned
                # memory (pageable memory would block) and an event
                # after it on the current stream
                host = torch.empty(vec.shape, dtype=vec.dtype,
                                   pin_memory=True)
                host.copy_(vec, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                pend["staged"] = (host, done)
            a.pending_q.append(pend)
            return
        self._finish_frame(a, pend)

    def _read_vec(self, pend) -> np.ndarray:
        """The frame's packed vector on the host (its one read): the
        pinned copy started at dispatch once its event has completed, or
        a plain read."""
        staged = pend.get("staged")
        if staged is None:
            return pend["vec"].cpu().numpy()
        host, done = staged
        done.synchronize()
        return host.numpy().copy()

    def _finish_frame(self, a: AgentState, pend):
        cfg = self.cfg
        ms, frame = pend["ms"], pend["frame"]
        snap_epoch = pend["snap_epoch"]
        # completions run in order: the host pose is the previous frame's
        q_last, t_last = a.q, a.t
        feat_mp, inlier = pend["feat_mp"], pend["inlier"]
        with TRACER.span("track.read"):
            vec = self._read_vec(pend)
        q, t = vec[0:4], vec[4:7]
        vel_q, vel_t = vec[7:11], vec[11:14]
        q_rel, t_rel = vec[14:18], vec[18:21]
        n_in = int(vec[21])
        q_pred, t_pred = vec[24:28], vec[28:31]
        if vec[22]:   # the widened retry ran
            a.n_fallback += 1

        if (n_in < cfg.min_track_inliers_lost and a.ref_kf >= 0
                and a.state == OK):
            # TrackReferenceKeyFrame fallback from the last pose
            with TRACER.span("track.ref_kf"):
                feat_mp_r, q_r, t_r, inlier_r, n_r, n_bow = self.fns[
                    "track_ref_kf"](ms, frame, pend["ref_kf"],
                                    self._tensor(q_last),
                                    self._tensor(t_last), a.cam.params)
                if int(n_bow) >= 15 and int(n_r) > n_in and int(n_r) >= 10:
                    feat_mp, inlier = feat_mp_r, inlier_r
                    q, t = q_r.cpu().numpy(), t_r.cpu().numpy()
                    n_in = int(n_r)
                    a.dev_chain = None   # the host pose left the chain
                    vel_q, vel_t = _se3_compose_np(
                        q, t, *_se3_inverse_np(q_last, t_last))
                    rq = ms.kf_q[pend["ref_kf"]].cpu().numpy()
                    rt = ms.kf_t[pend["ref_kf"]].cpu().numpy()
                    q_rel, t_rel = _se3_compose_np(q, t,
                                                   *_se3_inverse_np(rq, rt))

        if self.async_mapping:
            # found/visible deltas go through the worker, the single
            # writer; a full queue drops them (they are heuristics)
            try:
                self._jobs.put_nowait(
                    ("stats", snap_epoch, (feat_mp, inlier, pend["visible"])))
            except queue.Full:
                pass
        elif self.ms is ms:
            # no change since the snapshot: keep the deltas the step applied
            self.ms = pend["ms2"]
        elif snap_epoch == self.ms_epoch:
            # same structure, other contents: apply them to the live state
            self.ms = self.fns["update_found_visible"](
                self.ms, feat_mp, inlier, pend["visible"])
        # else the deferred frame's snapshot is structurally stale (a
        # keyframe or an epoch landed since): the deltas are dropped

        threshold = (cfg.min_track_inliers if a.state == OK
                     else cfg.min_track_inliers_lost)
        if n_in < threshold:
            if a.state == OK:
                a.state = RECENTLY_LOST
                a.frames_lost = 0
            else:
                a.frames_lost += 1
            if a.state == RECENTLY_LOST:
                with TRACER.span("track.reloc"):
                    relocalized = self._relocalize(a, frame)
                if relocalized:
                    a.state = OK
                    a.frames_since_kf += 1
                    return
            if a.frames_lost > cfg.recently_lost_frames:
                a.state = LOST
                self._create_map_in_atlas(a)
                return
            # keep the predicted pose; velocity unchanged.  The pose
            # chain broke: the IMU buffer needs contiguous tracked poses
            a.imu_buf.clear()
            a.q, a.t = q_pred, t_pred
            a.frames_since_kf += 1
            return

        if a.state == RECENTLY_LOST:
            a.state = OK
        a.vel_q, a.vel_t = vel_q, vel_t
        ts = pend["ts"]
        if a.last_ts is not None and ts > a.last_ts:
            # the world-velocity estimate of the IMU prediction
            # (camera centres: the translations of the inverse poses)
            a.vel_w = ((_se3_inverse_np(q, t)[1]
                        - _se3_inverse_np(q_last, t_last)[1])
                       / (ts - a.last_ts))
        a.q, a.t = q, t
        a.last_rel = (q_rel, t_rel, pend["ref_kf"])
        a.last_feat_mp = feat_mp
        a.frames_since_kf += 1
        if pend["imu"] is not None:
            self._imu_buffer_and_init(a, ts, pend["imu"])
        if self._need_new_keyframe(a, n_in):
            self._create_keyframe(a, frame, feat_mp, inlier, pend["ts"],
                                  snap_epoch)

    def _relocalize(self, a: AgentState, frame) -> bool:
        """Tracking::Relocalization: BoW candidates over ALL maps (the
        reference disables the map filter, so an agent can re-enter
        another agent's map), RANSAC PnP per candidate, then pose
        refinement against the candidate's local map.  Needs the server's
        vocabulary and keyframe database."""
        srv = self.server
        if srv is None or srv.voc is None or srv.kf_bow_words is None:
            return False
        ms = self.ms
        words = bow.quantize(srv.voc, frame.desc)
        uw, vals = bow.sparse_bow_row(
            srv.voc, words.cpu().numpy(), frame.valid.cpu().numpy(),
            srv.kf_bow_words.shape[1])
        scores, shared = srv.score_database(
            bow.dense_query(srv.voc, uw, vals))
        reps, _, okc = bow.detect_candidates_grouped(
            scores, shared, ms.kf_valid, ms.covis, n_out=5)
        pk = torch.stack([reps, okc.to(torch.int32)]).cpu().numpy()
        kf_valid = ms.kf_valid.cpu().numpy()
        cands = []
        for r, o in zip(*pk):
            if not o:
                break
            if r not in cands and kf_valid[r]:
                cands.append(int(r))
        is2 = torch.as_tensor(self.cfg.inv_sigma2, device=self.device)
        for cand in cands:
            fmp = ms.kf_feat_mp[cand]
            res = M.search_by_brute_force(
                frame.desc, frame.valid, frame.angle, ms.kf_feat_desc[cand],
                ms.kf_feat_valid[cand] & (fmp >= 0), ms.kf_feat_angle[cand])
            if int(res.ok.sum()) < 15:
                continue
            mp = fmp[torch.clamp(res.idx, min=0).long()]
            mpc = torch.clamp(mp, min=0).long()
            pr = pnp.ransac_pnp(ms.mp_pos[mpc], frame.uv,
                                res.ok & (mp >= 0) & ms.mp_valid[mpc], a.cam,
                                self._probe((128, 6), a.agent_id),
                                is2[frame.level.long()])
            if not bool(pr.ok):
                continue
            local_mask = self.fns["local_mp_mask"](ms, cand, 32)
            feat_mp, _, q, t, _, n_in, _ = self.fns["match_and_pose"](
                ms, frame, pr.q, pr.t, a.cam.params, local_mask, 4.0,
                M.TH_HIGH, 0.9)
            if int(n_in) < 30:
                continue
            old_map, new_map = a.map_id, int(ms.kf_map[cand])
            a.q, a.t = q.cpu().numpy(), t.cpu().numpy()
            a.vel_q = a.vel_t = None
            a.dev_chain = None
            a.ref_kf = cand
            a.last_feat_mp = feat_mp
            a.frames_lost = 0
            a.map_id = new_map            # cross-map re-entry when it differs
            self.events.append(f"RELOC agent={a.agent_id} kf={cand} map "
                               f"{old_map} -> {new_map}")
            return True
        return False

    def _create_map_in_atlas(self, a: AgentState):
        """Tracking::CreateMapInAtlas: the agent starts a fresh map; the
        old one stays in the atlas."""
        a.map_id = self._alloc_map_id()
        a.state = NOT_INITIALIZED
        a.init_frame = None
        a.q = a.t = None
        a.vel_q = a.vel_t = None
        a.dev_chain = None
        a.ref_kf = -1
        a.frames_lost = 0
        self.events.append(f"NEWMAP agent={a.agent_id} map={a.map_id}")

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, a: AgentState, n_in: int) -> bool:
        """Reference NeedNewKeyFrame, monocular core: interval bounds, the
        tracked-vs-reference ratio, and condition c1d: more than 5 refused
        insertions force the next weak frame in, so a busy worker cannot
        starve keyframe creation."""
        cfg = self.cfg
        if a.state != OK:
            return False
        weak = n_in < cfg.kf_ref_ratio * max(a.ref_kf_tracked, 1)
        c1 = a.frames_since_kf >= cfg.kf_max_interval
        c2 = a.frames_since_kf >= cfg.kf_min_interval and weak
        c1d = a.kf_insertions_refused > 5 and weak
        return (c1 or c2 or c1d) and n_in > 15

    def _kf_capacity_check(self, need: int = 1):
        n_live = int(self.ms.kf_valid.sum())
        if n_live + need > self.cfg.max_kf:
            raise MapCapacityError(
                f"keyframe arena exhausted: {n_live} live + {need} needed "
                f"> max_kf={self.cfg.max_kf} (raise SlamConfig.max_kf)")

    def _create_keyframe(self, a: AgentState, frame, feat_mp, inlier, ts,
                         snap_epoch: int):
        self._kf_capacity_check(1)
        feat_mp_in = torch.where(inlier, feat_mp, S.NO_MP)

        def insert():
            with TRACER.span("kf.insert"):
                ms, kf = self.fns["add_kf_step"](
                    self.ms, frame, self._tensor(a.q), self._tensor(a.t),
                    feat_mp_in, a.agent_id, a.map_id, float(ts),
                    a.next_agent_kf_id, a.cam.params)
                self.ms = ms
                return int(kf)

        if self.async_mapping:
            # insert only while the worker has no mapping job and the
            # frame's snapshot is structurally current (feat_mp indexes
            # its point slots); else refuse and count (the reference's
            # SetAcceptKeyFrames(false) back-pressure).  Stats jobs hold
            # the lock briefly, so they are waited for, not refused on.
            if self._pending_mapping > 0 or self._jobs.full():
                a.kf_insertions_refused += 1
                return
            with self._ms_lock:
                if snap_epoch != self.ms_epoch:
                    a.kf_insertions_refused += 1
                    return
                kf = insert()
                self._pending_mapping += 1
            a.kf_insertions_refused = 0
        elif self.pipeline and snap_epoch != self.ms_epoch:
            # a deferred frame of a structurally stale snapshot
            a.kf_insertions_refused += 1
            return
        else:
            kf = insert()
        a.next_agent_kf_id += 1
        a.frames_since_kf = 0
        a.ref_kf = kf
        # the new keyframe's pose is this frame's: rel = identity
        a.last_rel = (np.array([1, 0, 0, 0], np.float32),
                      np.zeros(3, np.float32), kf)
        a.ref_kf_tracked = int((feat_mp_in >= 0).sum())
        if self.async_mapping:
            self._jobs.put(("mapping", a.agent_id, kf, TRACER.current()))
            return
        self._local_mapping(a, kf)
        self.ms_epoch += 1
        if self.server is not None:
            self.server.process_keyframe(a.agent_id, kf)
            self.ms_epoch += 1

    def _protected_refs(self) -> torch.Tensor:
        """KF slots culling never removes: every agent's reference KF."""
        return torch.tensor([a.ref_kf for a in self.agents] + [-1],
                            dtype=torch.int32, device=self.device)

    def _local_mapping(self, a: AgentState, kf: int):
        """LocalMapping::Run for one keyframe: the mapping epoch, one read
        of its packed result, then the host's KeyFrameCulling loop."""
        with TRACER.timed("mapping", self.timers, f"LM_{a.agent_id}"):
            with TRACER.span("mapping.epoch"):
                ms, packed = self.fns["mapping_epoch"](
                    self.ms, kf, a.map_id, self._protected_refs())
            with TRACER.span("mapping.read"):
                pk_all = packed.cpu().numpy()
            self.epochs.append((a.agent_id, a.map_id, pk_all[0]))
            n_drop = int(pk_all[0, 2])
            if n_drop:
                if self.mp_dropped == 0:
                    self.events.append(
                        f"MP_ARENA_FULL agent={a.agent_id} dropping "
                        f"triangulations (raise SlamConfig.max_mp)")
                self.mp_dropped += n_drop
            with TRACER.span("mapping.cull"):
                self.ms = self._cull_keyframes(ms, kf, pk_all[1:])

    def _cull_keyframes(self, ms, kf: int, pk: np.ndarray):
        """KeyFrameCulling of ``kf``'s covisibles from the packed scores
        ``pk``: at most two removals, re-scored after each.  Returns the
        state."""
        culled = 0
        while culled < 2:
            cand_j = next((j for j in range(pk.shape[0])
                           if pk[j, 1] > 0.5 and pk[j, 2] >= 0.9
                           and int(pk[j, 3]) > 20), -1)
            if cand_j < 0:
                break
            cand = int(pk[cand_j, 0])
            parent = int(pk[cand_j, 4])
            if parent >= 0:
                q_cp = pk[cand_j, 5:9].astype(np.float32)
                t_cp = pk[cand_j, 9:12].astype(np.float32)
                self.culled_kf[cand] = (parent, q_cp, t_cp)
                # re-reference trajectory rows onto the parent now: the
                # culled slot is recycled
                for ag in self.agents:
                    for i, row in enumerate(ag.trajectory):
                        if row[1] == cand:
                            q_n, t_n = _se3_compose_np(row[2], row[3], q_cp,
                                                       t_cp)
                            ag.trajectory[i] = (row[0], parent, q_n, t_n,
                                                row[4])
            ms = self.fns["remove_kf"](ms, cand)
            culled += 1
            self.kf_culled += 1
            if culled < 2:   # re-score on the post-removal state
                pk = self.fns["cull_pack"](
                    ms, kf, self._protected_refs()).cpu().numpy()
        return ms

    # ------------------------------------------------------------------
    def _record_trajectory(self, a: AgentState, ts):
        """Store the pose relative to the reference KF, so later map
        corrections carry over."""
        if a.last_rel is not None:
            q_rel, t_rel, ref = a.last_rel
        else:
            ref = a.ref_kf
            rq = self.ms.kf_q[ref].cpu().numpy()
            rt = self.ms.kf_t[ref].cpu().numpy()
            q_rel, t_rel = _se3_compose_np(a.q, a.t,
                                           *_se3_inverse_np(rq, rt))
        a.trajectory.append((ts, ref, np.asarray(q_rel), np.asarray(t_rel),
                             a.state))

    def resolve_ref(self, ref, q_rel, t_rel, kf_valid=None):
        """Walk culled ancestors until a live reference KF (of
        ``kf_valid``, default the live map's); returns (ref, (q, t)
        relative to it)."""
        if kf_valid is None:
            kf_valid = self.ms.kf_valid.cpu().numpy()
        seen = 0
        while ref >= 0 and not kf_valid[ref] and seen < 64:
            ent = self.culled_kf.get(ref)
            if ent is None:
                break
            parent, q_cp, t_cp = ent
            q_rel, t_rel = _se3_compose_np(q_rel, t_rel, q_cp, t_cp)
            ref = parent
            seen += 1
        return ref, (q_rel, t_rel)

    def trajectory_world(self, agent_id: int, ms=None):
        """Camera-to-world trajectory (TUM convention, Twc): rows (ts, q,
        t, state), against ``ms`` (default the live map state; a reader
        in another thread passes the one snapshot it holds)."""
        ms = self.ms if ms is None else ms
        kf_q = ms.kf_q.cpu().numpy()
        kf_t = ms.kf_t.cpu().numpy()
        kf_valid = ms.kf_valid.cpu().numpy()
        out = []
        for ts, ref, q_rel, t_rel, state in list(
                self.agents[agent_id].trajectory):
            ref2, (q_r, t_r) = self.resolve_ref(ref, q_rel, t_rel, kf_valid)
            q_cw, t_cw = _se3_compose_np(q_r, t_r, kf_q[ref2], kf_t[ref2])
            q_wc, t_wc = _se3_inverse_np(q_cw, t_cw)
            out.append((ts, q_wc, t_wc, state))
        return out
