"""The per-frame tracking programs of the SLAM system.

Port of ``mam3slam_tpu.slam.system``'s ``SlamConfig``, tracking-state
constants and the tracking part of ``_compiled``: ``tracking_programs``
returns the functions ``SlamSystem`` calls on every frame, with the same
arguments and return tuples (the packed ``vec`` and the device-resident
chain state included).  PyTorch runs them eagerly; the widened retry of
``track_frame_step`` is a host branch on the coarse stage's inlier count
(one device-to-host read per frame).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import matching as M
from mam3slam_tpu_torch.slam import steps

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


@dataclass(frozen=True)
class SlamConfig:
    """The configuration fields the tracking programs read (names and
    defaults of the reference's SlamConfig)."""

    width: int
    height: int
    cam_kind: int = cam_mod.PINHOLE
    n_levels: int = 8
    scale_factor: float = 1.2
    max_kf: int = 512
    max_mp: int = 24576
    n_feat: int = 768
    max_obs: int = 16
    min_track_inliers: int = 30
    min_track_inliers_lost: int = 10

    @property
    def scale_factors(self) -> np.ndarray:
        return np.array([self.scale_factor ** i
                         for i in range(self.n_levels)], np.float32)

    @property
    def inv_sigma2(self) -> np.ndarray:
        return (1.0 / self.scale_factors ** 2).astype(np.float32)

    def map_config(self) -> S.MapConfig:
        return S.MapConfig(max_kf=self.max_kf, max_mp=self.max_mp,
                           n_feat=self.n_feat, max_obs=self.max_obs,
                           n_levels=self.n_levels,
                           scale_factor=self.scale_factor)


def tracking_programs(cfg: SlamConfig, kind: int) -> dict:
    """The tracking functions closed over a static config and camera kind:
    ``match_and_pose``, ``local_mp_mask``, ``track_frame_step``,
    ``track_ref_kf`` and ``update_found_visible``."""
    W, H = float(cfg.width), float(cfg.height)
    per_device = {}

    def consts(device):
        """(scale factors, inverse sigma^2 per level) on ``device``."""
        if device not in per_device:
            per_device[device] = (
                torch.tensor(cfg.scale_factors, device=device),
                torch.tensor(cfg.inv_sigma2, device=device))
        return per_device[device]

    def match_and_pose(ms, frame, q0, t0, cam_params, mp_mask, th_radius,
                       max_dist, ratio):
        sf, is2 = consts(ms.mp_pos.device)
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
        sf, is2 = consts(dev)
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
        if bool(widened):  # host branch: one read of the coarse count
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
        _, is2 = consts(ms.mp_pos.device)
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

    return {
        "match_and_pose": match_and_pose,
        "local_mp_mask": local_mp_mask,
        "track_frame_step": track_frame_step,
        "track_ref_kf": track_ref_kf,
        "update_found_visible": update_found_visible,
    }
