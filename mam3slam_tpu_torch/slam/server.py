"""Centralised loop-closing and map-merging server.

Port of ``mam3slam_tpu.slam.server``: one server consumes the keyframes
of every agent, finds common regions across all maps by BoW, verifies
them by Sim3 (brute-force matching, RANSAC, guided projection,
OptimizeSim3) and, once a hypothesis is confirmed over consecutive
keyframes, closes a loop inside a map (Sim3 propagation over the
covisible window, fuse, essential-graph PGO, conditional global BA) or
merges the current map into an older one (Sim3 transform, relabel,
retarget the agents, fuse, welding BA, merge PGO, conditional global BA).
It runs between tracking steps, or in the system's mapping worker under
asynchronous mapping.  With ``ServerConfig.async_gba`` the conditional
global BA runs in the background (``slam/background_gba.py``) and is
applied at a later keyframe or at ``flush_gba``; a new loop or merge
aborts it.  The RANSAC draws come from the server's own seeded
``torch.Generator``.  A loop in a map that an agent's inertial
initialisation belongs to takes the 4DoF PGO (yaw about gravity and
translation, scale held at 1); any other loop takes the Sim3 PGO.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import bow
from mam3slam_tpu_torch.ops import matching as M
from mam3slam_tpu_torch.parallel import dist_window_ba
from mam3slam_tpu_torch.slam.background_gba import BackgroundGBA
from mam3slam_tpu_torch.solvers import pgo as pgo_mod
from mam3slam_tpu_torch.solvers import sim3 as sim3_mod
from mam3slam_tpu_torch.utils.timing import Timers


@dataclass
class Hypothesis:
    """Per-agent loop/merge hypothesis."""

    target_kf: int = -1
    is_merge: bool = False
    n_coincidences: int = 0
    n_misses: int = 0
    # S_cw: target-map world -> camera of KF last_kf (host copies)
    q: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    s: float = 1.0
    last_kf: int = -1


@dataclass
class ServerConfig:
    min_kfs_in_map: int = 12
    n_candidates: int = 3
    n_bow_matches: int = 20
    n_sim3_inliers: int = 10
    n_proj_matches: int = 15
    n_proj_opt_matches: int = 20
    n_confirm: int = 3
    max_misses: int = 2
    pgo_min_covis_weight: int = 100
    vocab_k: int = 10
    vocab_depth: int = 3
    # run the conditional global BA in the background and apply it at a
    # later keyframe (the reference's GBA thread)
    async_gba: bool = False
    max_kf_for_gba: int = 200
    # run the global BA distributed over this DeviceMesh (parallel/
    # dist_window_ba.dist_global_ba; the server on the mesh's rank 0, the
    # other ranks in dist_window_ba.serve), reducing over its last axis:
    # a 1-D mesh's own, the "chip" axis of a ("host", "chip") mesh
    gba_mesh: Optional[object] = None


def _batched_rel(q, t, ei, ej):
    """Relative SE3-as-Sim3 measurements S_j * S_i^-1 of an edge batch."""
    qi, ti, qj, tj = q[ei], t[ei], q[ej], t[ej]
    qrel = lie.quat_normalize(lie.quat_mul(qj, lie.quat_conj(qi)))
    return qrel, tj - lie.quat_rotate(qrel, ti)


class LoopServer:
    """Consumes (agent, keyframe) events; owns the BoW database and the
    per-agent hypotheses."""

    def __init__(self, system, cfg: ServerConfig = None,
                 vocab: bow.Vocabulary = None, seed: int = 0,
                 gba_device=None):
        """``gba_device``: the CUDA stream the background global BA runs
        on (None: a side stream of its own); the reference's other mesh
        device."""
        self.sys = system
        self.cfg = cfg or ServerConfig()
        self.voc = None if vocab is None else vocab.to(system.device)
        self.hyp: Dict[int, Hypothesis] = {}
        self.gen = torch.Generator().manual_seed(seed + 1234)
        # sparse BoW rows of the keyframes (host): word ids (-1 pad) and
        # tf-idf values, [K, F] each, allocated with the vocabulary
        self.kf_bow_words = None
        self.kf_bow_vals = None
        self._pending_index: List[int] = []   # KFs awaiting the vocabulary
        self.events: List[str] = []
        self.gba_runs: List[int] = []          # map ids a global BA ran on
        self.gba: Optional[BackgroundGBA] = None   # made at its first run
        self.gba_device = gba_device
        self.timers = Timers()                 # PR / LC / MM series (ms)
        self.last_verify: dict = {}

    @property
    def device(self):
        return self.sys.device

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _probe(self, shape) -> torch.Tensor:
        """Uniform RANSAC draws from the server's generator."""
        return torch.rand(shape, generator=self.gen).to(self.device)

    # ------------------------------------------------------------------
    def ensure_vocab(self):
        """Train a bootstrap vocabulary from the descriptors in the map
        when none was given, and allocate the keyframe database."""
        if self.voc is None:
            ms = self.sys.ms
            valid = ms.kf_feat_valid & ms.kf_valid[:, None]
            sample = ms.kf_feat_desc[valid][:120000].cpu().numpy()
            if len(sample) < 500:
                sample = np.random.default_rng(0).integers(
                    0, 256, (2000, 32), dtype=np.uint8)
            self.voc = bow.build_vocabulary(
                sample, k=self.cfg.vocab_k,
                depth=self.cfg.vocab_depth).to(self.device)
        if self.kf_bow_words is None:
            K, F = self.sys.cfg.max_kf, self.sys.cfg.n_feat
            self.kf_bow_words = np.full((K, F), -1, np.int32)
            self.kf_bow_vals = np.zeros((K, F), np.float32)

    def _index_keyframe(self, kf: int):
        """Quantize and store the keyframe's sparse BoW row."""
        ms = self.sys.ms
        words = bow.quantize(self.voc, ms.kf_feat_desc[kf])
        wv = torch.stack([words, ms.kf_feat_valid[kf].to(torch.int32)]
                         ).cpu().numpy()               # one packed read
        self.kf_bow_words[kf], self.kf_bow_vals[kf] = bow.sparse_bow_row(
            self.voc, wv[0], wv[1].astype(bool), self.kf_bow_words.shape[1])

    def score_database(self, q_dense: np.ndarray):
        """L1 scores and shared-word counts [K] of a dense query against
        every keyframe row, on the device."""
        q = self._tensor(q_dense)
        db_words = self._tensor(self.kf_bow_words, torch.int32)
        return (bow.l1_scores_sparse(q, db_words,
                                     self._tensor(self.kf_bow_vals)),
                bow.shared_words_sparse(q, db_words))

    # ------------------------------------------------------------------
    def process_keyframe(self, agent_id: int, kf: int):
        """LoopClosing::Run body for one keyframe; returns "loop",
        "merge" or None."""
        with self.timers.measure("PR"):
            return self._process_keyframe(agent_id, kf)

    def _process_keyframe(self, agent_id: int, kf: int):
        ms = self.sys.ms
        if self.voc is None:
            # train the bootstrap vocabulary once the atlas holds enough
            # keyframes (detection is gated at min_kfs_in_map anyway)
            self._pending_index.append(kf)
            if int(ms.kf_valid.sum()) < self.cfg.min_kfs_in_map:
                return None
        self.ensure_vocab()
        if self._pending_index:
            kf_valid = ms.kf_valid.cpu().numpy()
            for p in self._pending_index:
                if kf_valid[p]:       # culled slots are skipped
                    self._index_keyframe(p)
            self._pending_index = []
        else:
            self._index_keyframe(kf)
        # harvest a finished background GBA between epochs (the reference
        # polls mbFinishedGBA in LoopClosing::Run)
        if self.gba is not None and self.gba.running and self.gba.ready:
            if self.gba.finish():
                self.events.append("GBA applied")
        ms = self.sys.ms
        hdr = torch.stack([
            ms.kf_map[kf],
            (ms.kf_valid & (ms.kf_map == ms.kf_map[kf])).sum().to(
                torch.int32)]).cpu().numpy()
        if int(hdr[1]) < self.cfg.min_kfs_in_map:
            return None

        # 1. continue this agent's hypothesis
        h = self.hyp.get(agent_id)
        if h is not None and h.n_coincidences > 0:
            if self._refine_hypothesis(agent_id, kf, h):
                h.n_coincidences += 1
                h.n_misses = 0
                if h.n_coincidences >= self.cfg.n_confirm:
                    return self._trigger(agent_id, kf, h)
                return None
            h.n_misses += 1
            if h.n_misses > self.cfg.max_misses:
                del self.hyp[agent_id]

        # 2. fresh candidates from the BoW database
        loop_c, merge_c = self._detect_candidates(kf)
        for cand, is_merge in ([(c, False) for c in loop_c]
                               + [(c, True) for c in merge_c]):
            res = self._verify_candidate(kf, cand)
            if res is None:
                continue
            q, t, s = res
            self.hyp[agent_id] = Hypothesis(
                target_kf=cand, is_merge=is_merge, n_coincidences=1,
                q=q, t=t, s=s, last_kf=kf)
            break
        return None

    # ------------------------------------------------------------------
    def _detect_candidates(self, kf: int):
        """Covisibility-group candidates of keyframe ``kf`` among the
        keyframes not covisible with it, split into loop (same map) and
        merge (other map) candidates, at most n_candidates each."""
        ms = self.sys.ms
        cfg = self.cfg
        scores, shared = self.score_database(bow.dense_query(
            self.voc, self.kf_bow_words[kf], self.kf_bow_vals[kf]))
        K = ms.kf_valid.shape[0]
        eligible = (ms.kf_valid & (ms.covis[kf] == 0)
                    & (torch.arange(K, device=self.device) != kf))
        reps, _, ok = bow.detect_candidates_grouped(
            scores, shared, eligible, ms.covis, n_out=3 * cfg.n_candidates)
        pk = torch.cat([ms.kf_valid.to(torch.int32),
                        (ms.kf_map == ms.kf_map[kf]).to(torch.int32),
                        reps, ok.to(torch.int32)]).cpu().numpy()
        kf_valid = pk[:K].astype(bool)
        same_map = pk[K:2 * K].astype(bool)
        n = reps.shape[0]
        loop_c, merge_c, seen = [], [], set()
        for r, o in zip(pk[2 * K:2 * K + n], pk[2 * K + n:]):
            if not o:
                break
            r = int(r)
            if r in seen or not kf_valid[r] or r == kf:
                continue
            seen.add(r)
            if same_map[r] and len(loop_c) < cfg.n_candidates:
                loop_c.append(r)
            elif not same_map[r] and len(merge_c) < cfg.n_candidates:
                merge_c.append(r)
        return loop_c, merge_c

    # ------------------------------------------------------------------
    def _candidate_window_points(self, cand: int, n_covis: int = 5):
        """Map points observed by the candidate KF and its top covisibles:
        the tracking program's local-map mask of ``cand``."""
        return self.sys.fns["local_mp_mask"](self.sys.ms, cand, n_covis)

    def _camera(self, kf: int) -> cam_mod.Camera:
        return cam_mod.Camera(self.sys.ms.kf_cam[kf], self.sys.cfg.cam_kind)

    def _sigma2(self, level: torch.Tensor) -> torch.Tensor:
        s2 = self._tensor(self.sys.cfg.sigma2)
        return s2[torch.clamp(level, 0, s2.shape[0] - 1).long()]

    def _pose_sim3(self, kf) -> lie.Sim3:
        ms = self.sys.ms
        return lie.sim3_from_se3(lie.SE3(ms.kf_q[kf], ms.kf_t[kf]))

    def _project_match_sim3(self, kf: int, Scw: lie.Sim3, mp_mask,
                            th: float):
        """Guided Sim3 projection search of the arena's masked points into
        keyframe ``kf`` (SearchByProjection(KF, Scw)): depth > 0, in the
        image, scale-invariance distance bounds, viewing angle < 60 deg,
        the predicted level's radius and level window.  Distances are
        taken in the candidate map's frame (camera centre through
        Scw^-1), where the Sim3 scale cancels.  Returns (matches,
        their count)."""
        ms = self.sys.ms
        cfg = self.sys.cfg
        sf = self._tensor(cfg.scale_factors)
        proj = lie.sim3_apply(Scw, ms.mp_pos)
        uvp = cam_mod.project_ideal(self._camera(kf), proj)
        in_img = ((uvp[:, 0] >= 0) & (uvp[:, 0] < cfg.width)
                  & (uvp[:, 1] >= 0) & (uvp[:, 1] < cfg.height))
        Ow = lie.sim3_apply(lie.sim3_inverse(Scw),
                            torch.zeros(3, device=self.device))
        vec = ms.mp_pos - Ow[None, :]
        dist = torch.linalg.vector_norm(vec, dim=-1)
        dist_ok = ((dist >= 0.8 * ms.mp_min_dist)
                   & (dist <= 1.2 * ms.mp_max_dist))
        view_cos = (vec * ms.mp_normal).sum(-1) / torch.clamp(dist,
                                                                min=1e-9)
        ratio = ms.mp_max_dist / torch.clamp(dist, min=1e-9)
        lvl = torch.clamp(torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                                     / torch.log(sf[1])).to(torch.int32),
                          0, sf.shape[0] - 1)
        vis = (mp_mask & (proj[:, 2] > 0.05) & in_img & dist_ok
               & (view_cos > 0.5))
        mres = M.search_by_projection_frame(
            uvp, lvl, th * sf[lvl.long()], ms.mp_desc, vis,
            ms.kf_feat_uv[kf], ms.kf_feat_level[kf], ms.kf_feat_desc[kf],
            ms.kf_feat_valid[kf])
        return mres, int(mres.ok.sum())

    def _optimize_sim3_pairs(self, kf: int, cand: int, mres, S12_init):
        """OptimizeSim3 on genuine pairs: the matched feature of ``kf``
        carries its own map point and the candidate point is observed in
        ``cand``, so both reprojection directions are independent."""
        ms = self.sys.ms
        T2 = self._pose_sim3(cand)
        pc2 = lie.sim3_apply(T2, ms.mp_pos)               # candidate camera
        f1 = torch.clamp(mres.idx, min=0).long()
        mp1 = ms.kf_feat_mp[kf][f1]
        p1w = ms.mp_pos[torch.clamp(mp1, min=0).long()]
        pc1 = lie.quat_rotate(ms.kf_q[kf][None], p1w) + ms.kf_t[kf][None]
        hit2 = ms.mp_obs_kf == cand                       # [P, M]
        P = hit2.shape[0]
        f2 = torch.clamp(ms.mp_obs_feat[
            torch.arange(P, device=self.device),
            torch.argmax(hit2.to(torch.int32), -1)], min=0).long()
        pair_ok = mres.ok & (mp1 >= 0) & hit2.any(-1)
        return sim3_mod.optimize_sim3(
            S12_init.q, S12_init.t, S12_init.s, pc1, pc2,
            ms.kf_feat_uv[kf][f1], ms.kf_feat_uv[cand][f2], pair_ok,
            self._camera(kf), self._camera(cand),
            self._sigma2(ms.kf_feat_level[kf][f1]),
            self._sigma2(ms.kf_feat_level[cand][f2])), T2

    def _verify_candidate(self, kf: int, cand: int):
        """BoW-space matching -> Sim3 RANSAC -> guided projection (th 8)
        -> OptimizeSim3 -> the decisive projection through the optimised
        Sim3 (th 5).  Returns (q, t, s) of S_cw, candidate-map world ->
        camera of ``kf`` (host values), or None; ``last_verify`` holds the
        funnel's counts."""
        ms = self.sys.ms
        cfg = self.cfg
        fmp1, fmp2 = ms.kf_feat_mp[kf], ms.kf_feat_mp[cand]
        res = M.search_by_brute_force(
            ms.kf_feat_desc[kf], ms.kf_feat_valid[kf] & (fmp1 >= 0),
            ms.kf_feat_angle[kf], ms.kf_feat_desc[cand],
            ms.kf_feat_valid[cand] & (fmp2 >= 0), ms.kf_feat_angle[cand])
        n_bow = int(res.ok.sum())
        self.last_verify = {"kf": kf, "cand": cand, "n_bow": n_bow,
                            "n_ransac": 0, "n_proj": 0, "n_opt_inl": 0,
                            "n_final": 0}
        if n_bow < cfg.n_bow_matches:
            return None

        idx = res.idx.long()
        r = sim3_mod.ransac_sim3(
            ms.mp_pos[torch.clamp(fmp1, min=0).long()],
            ms.mp_pos[torch.clamp(fmp2[idx], min=0).long()], res.ok,
            ms.kf_feat_uv[kf], ms.kf_feat_uv[cand][idx], self._camera(kf),
            self._camera(cand), ms.kf_q[kf], ms.kf_t[kf], ms.kf_q[cand],
            ms.kf_t[cand], self._probe((128, 3)),
            self._sigma2(ms.kf_feat_level[kf]),
            self._sigma2(ms.kf_feat_level[cand][idx]),
            min_inliers=cfg.n_sim3_inliers)
        n_ransac, ok = (int(x) for x in torch.stack(
            [r.n_inliers, r.ok.to(r.n_inliers.dtype)]).cpu())
        self.last_verify["n_ransac"] = n_ransac
        if not ok:
            return None

        # guided projection of the candidate's window through the Sim3
        # S_c1<-w2 = S_c1<-c2 * T_c2<-w2, then refine
        mp_mask = self._candidate_window_points(cand)
        S12 = lie.Sim3(r.q, r.t, r.s)
        T2 = self._pose_sim3(cand)
        mres, n_proj = self._project_match_sim3(
            kf, lie.sim3_compose(S12, T2), mp_mask, th=8.0)
        self.last_verify["n_proj"] = n_proj
        if n_proj < cfg.n_proj_matches:
            return None
        (q_o, t_o, s_o, _, n_in), _ = self._optimize_sim3_pairs(
            kf, cand, mres, S12)
        self.last_verify["n_opt_inl"] = int(n_in)
        if int(n_in) < cfg.n_sim3_inliers:
            return None

        Scw_o = lie.sim3_compose(lie.Sim3(q_o, t_o, s_o), T2)
        _, n_opt = self._project_match_sim3(kf, Scw_o, mp_mask, th=5.0)
        self.last_verify["n_final"] = n_opt
        if n_opt < cfg.n_proj_opt_matches:
            return None
        return (Scw_o.q.cpu().numpy(), Scw_o.t.cpu().numpy(),
                float(Scw_o.s))

    def _hyp_sim3(self, h: Hypothesis) -> lie.Sim3:
        return lie.Sim3(self._tensor(h.q), self._tensor(h.t),
                        self._tensor(h.s))

    def _refine_hypothesis(self, agent_id: int, kf: int, h: Hypothesis):
        """DetectAndReffineSim3FromLastKF: propagate S_cw through the
        agent's motion since the hypothesis' last KF, re-match by guided
        projection, re-optimise the Sim3 on the fresh matches and accept
        only if the projection through it still matches widely.  The
        propagated Sim3 is kept either way."""
        cfg = self.cfg
        rel = lie.sim3_compose(self._pose_sim3(kf),
                               lie.sim3_inverse(self._pose_sim3(h.last_kf)))
        S_cur = lie.sim3_compose(rel, self._hyp_sim3(h))
        # the reference's gates, 2x / 2.5x / 5x the detection thresholds
        n_proj_th = 2 * cfg.n_proj_matches
        n_opt_th = int(2.5 * cfg.n_proj_opt_matches)
        n_rep_th = 5 * cfg.n_proj_opt_matches

        mp_mask = self._candidate_window_points(h.target_kf)
        mres, n1 = self._project_match_sim3(kf, S_cur, mp_mask, th=8.0)
        h.q, h.t, h.s = (S_cur.q.cpu().numpy(), S_cur.t.cpu().numpy(),
                         float(S_cur.s))
        h.last_kf = kf
        if n1 < n_proj_th:
            return False
        T2 = self._pose_sim3(h.target_kf)
        (q_o, t_o, s_o, _, n_in), _ = self._optimize_sim3_pairs(
            kf, h.target_kf, mres,
            lie.sim3_compose(S_cur, lie.sim3_inverse(T2)))
        if int(n_in) < n_opt_th:
            return False
        Scw_o = lie.sim3_compose(lie.Sim3(q_o, t_o, s_o), T2)
        _, n2 = self._project_match_sim3(kf, Scw_o, mp_mask, th=5.0)
        if n2 < n_rep_th:
            return False
        h.q, h.t, h.s = (Scw_o.q.cpu().numpy(), Scw_o.t.cpu().numpy(),
                         float(Scw_o.s))
        return True

    # ------------------------------------------------------------------
    def _run_gba(self, map_id: int):
        """The conditional full-map BA: a synchronous epoch (distributed
        over ``cfg.gba_mesh`` when one is set), or started in the
        background with ``cfg.async_gba`` (unless one is in flight)."""
        self.gba_runs.append(map_id)
        if self.cfg.gba_mesh is not None:
            mesh = self.cfg.gba_mesh
            self.sys.ms = dist_window_ba.dist_global_ba(
                self.sys.ms, self.sys.cfg, mesh, map_id,
                self.sys.cfg.cam_kind, axis=mesh.mesh_dim_names[-1])
            return
        if self.cfg.async_gba:
            if self.gba is None:
                self.gba = BackgroundGBA(self.sys, stream=self.gba_device)
            if not self.gba.running:
                self.gba.start(map_id)
        else:
            self.sys.ms = self.sys.fns["global_ba"](self.sys.ms, map_id)

    def flush_gba(self):
        """Wait for and apply a pending background GBA.  It writes the
        system's state, so under asynchronous mapping it takes the
        system's lock (mapping jobs may still be in flight)."""
        if self.gba is not None and self.gba.running:
            with self.sys._structural_lock():
                if self.gba.finish():
                    self.events.append("GBA applied")

    def _trigger(self, agent_id: int, kf: int, h: Hypothesis):
        del self.hyp[agent_id]
        # a new loop or merge invalidates a GBA in flight (the reference's
        # mbStopGBA)
        if self.gba is not None and self.gba.running:
            self.gba.abort()
            self.events.append("GBA aborted")
        ms = self.sys.ms
        maps = ms.kf_map[[kf, h.target_kf]].cpu().numpy()
        if h.is_merge or maps[0] != maps[1]:
            self.merge_maps(agent_id, kf, h)
            return "merge"
        self.correct_loop(agent_id, kf, h)
        return "loop"

    # ------------------------------------------------------------------
    def correct_loop(self, agent_id: int, kf: int, h: Hypothesis):
        """CorrectLoop: Sim3-correct the current KF's covisible window,
        essential-graph PGO over the map (4DoF in an inertial map), move
        the points with their reference KFs, record the loop edge, fuse
        duplicates around the loop, and run the global BA while the map
        is small and alone in the atlas."""
        t0 = time.perf_counter()
        sysm = self.sys
        ms = sysm.ms
        K = ms.kf_valid.shape[0]
        kf_map = int(ms.kf_map[kf])
        in_map_t = ms.kf_valid & (ms.kf_map == kf_map)
        in_map = in_map_t.cpu().numpy()

        # the window gets the corrected Sim3 propagated through its
        # relative poses, S_iw = T_ic * S_corr; the rest stays at s = 1
        S_corr = self._hyp_sim3(h)
        idx, _, ok = S.best_covisible(ms, kf, 16)
        win = torch.cat([torch.tensor([kf], device=self.device),
                         idx[ok].long()])
        S_i = lie.sim3_compose(
            lie.sim3_compose(self._pose_sim3(win),
                             lie.sim3_inverse(self._pose_sim3(kf))), S_corr)
        q0, t0_ = ms.kf_q.clone(), ms.kf_t.clone()
        s0 = torch.ones(K, device=self.device)
        q0[win], t0_[win], s0[win] = S_i.q, S_i.t, S_i.s

        edges = self._essential_edges(ms, kf, h.target_kf, S_corr, in_map)
        fixed = ~in_map_t
        fixed[h.target_kf] = True
        # an inertial map (an agent's VI initialisation belongs to it):
        # gravity observes roll and pitch and the map is metric, so only
        # yaw about the map's up axis and translation move (the
        # reference's OptimizeEssentialGraph4DoF)
        inertial = next((a for a in sysm.agents if a.imu_initialized
                         and a.imu_init_map == kf_map), None)
        if inertial is not None:
            g = inertial.gravity_w
            q_n, t_n = pgo_mod.optimize_essential_graph_4dof(
                q0, t0_, fixed, edges, iters=12,
                gravity_axis=None if g is None
                else -np.asarray(g) / np.linalg.norm(g))
            s_n = torch.ones(K, device=self.device)
        else:
            q_n, t_n, s_n = pgo_mod.optimize_essential_graph(
                q0, t0_, s0, fixed, edges, iters=12)
        new_pos = pgo_mod.correct_points_by_ref(
            ms.mp_pos, ms.mp_ref_kf, ms.mp_valid & (ms.mp_map == kf_map),
            ms.kf_q, ms.kf_t, torch.ones(K, device=self.device), q_n, t_n,
            s_n)
        # scale folds into the SE3 poses: T_cw = (R, t / s)
        upd = in_map_t[:, None]
        ms = ms._replace(
            kf_q=torch.where(upd, lie.quat_normalize(q_n), ms.kf_q),
            kf_t=torch.where(upd, t_n / torch.clamp(s_n[:, None], min=1e-9),
                             ms.kf_t),
            mp_pos=new_pos,
            map_change=S.set_at(ms.map_change, kf_map,
                                ms.map_change[kf_map] + 1))
        # the closed loop stays a constraint of every later PGO
        ms = S.add_loop_edge(ms, h.target_kf, kf)
        local_mask = sysm.fns["local_mp_mask"](ms, kf, 16)
        ms, _ = sysm.fns["fuse_step"](ms, kf, local_mask)
        sysm.ms = sysm.fns["refresh_stats"](ms, ms.mp_valid)
        # global BA only while the map is small AND alone in the atlas
        if (int(in_map.sum()) < self.cfg.max_kf_for_gba
                and int(sysm.ms.map_valid.sum()) == 1):
            self._run_gba(kf_map)
        self.events.append(f"LOOP agent={agent_id} kf={kf} "
                           f"target={h.target_kf} map={kf_map}"
                           + (" pgo=4dof" if inertial is not None else ""))
        self.timers.add("LC", (time.perf_counter() - t0) * 1e3)

    def _essential_edges(self, ms, kf, target_kf, S_corr, in_map):
        """The essential graph's edges (spanning tree, strong
        covisibility, stored loop/merge edges) measured at the current
        estimates, plus the new loop edge S_corr * T_target^-1 with weight
        5."""
        ei, ej, ew = self._essential_edge_set(ms, in_map,
                                              exclude_pair=(kf, target_kf))
        ei_t = torch.as_tensor(ei, device=self.device).long()
        ej_t = torch.as_tensor(ej, device=self.device).long()
        qrel, trel = _batched_rel(ms.kf_q, ms.kf_t, ei_t, ej_t)
        m = lie.sim3_compose(S_corr,
                             lie.sim3_inverse(self._pose_sim3(target_kf)))
        E = len(ei) + 1
        return pgo_mod.PGOEdges(
            i=self._tensor(np.append(ei, target_kf), torch.int32),
            j=self._tensor(np.append(ej, kf), torch.int32),
            q=torch.cat([qrel, m.q[None]]), t=torch.cat([trel, m.t[None]]),
            s=torch.cat([torch.ones(E - 1, device=self.device), m.s[None]]),
            w=self._tensor(np.append(ew, 5.0)),
            valid=torch.ones(E, dtype=torch.bool, device=self.device))

    def _essential_edge_set(self, ms, in_map, exclude_pair=None):
        """Host edge selection: spanning tree, strong covisibility (i < j,
        tree pairs excluded), stored loop/merge edges inside the map
        (``exclude_pair``'s stored edge dropped).  Returns (i, j, weight)
        numpy arrays; loop edges weigh 5."""
        parent = ms.kf_parent.cpu().numpy()
        valid = ms.kf_valid.cpu().numpy() & in_map
        j_all = np.where(valid & (parent >= 0))[0]
        j_tree = j_all[valid[parent[j_all]]]
        i_tree = parent[j_tree]
        covis = ms.covis.cpu().numpy()
        cmask = ((covis >= self.cfg.pgo_min_covis_weight)
                 & valid[:, None] & valid[None, :])
        iu, ju = np.nonzero(np.triu(cmask, k=1))
        keep = (parent[ju] != iu) & (parent[iu] != ju)
        i_cov, j_cov = iu[keep], ju[keep]
        li = ms.loop_i.cpu().numpy()
        lj = ms.loop_j.cpu().numpy()
        n = len(valid)
        lok = (ms.loop_valid.cpu().numpy() & valid[np.clip(li, 0, n - 1)]
               & valid[np.clip(lj, 0, n - 1)])
        if exclude_pair is not None:
            kf, target_kf = exclude_pair
            lok &= ~(((li == target_kf) & (lj == kf))
                     | ((li == kf) & (lj == target_kf)))
        ei = np.concatenate([i_tree, i_cov, li[lok]]).astype(np.int32)
        ej = np.concatenate([j_tree, j_cov, lj[lok]]).astype(np.int32)
        ew = np.ones(len(ei), np.float32)
        ew[len(i_tree) + len(i_cov):] = 5.0
        return ei, ej, ew

    # ------------------------------------------------------------------
    def merge_maps(self, agent_id: int, kf: int, h: Hypothesis):
        """MergeLocalMulti: carry the current KF's map into the target
        map's frame with the verified Sim3, relabel it, invert the
        spanning-tree chain across the seam, record the merge edge,
        retarget the absorbed map's agents, then fuse, welding BA, merge
        PGO, and the global BA while the merged map is small."""
        t0 = time.perf_counter()
        sysm = self.sys
        ms = sysm.ms
        cur_map, tgt_map = (int(x) for x in
                            ms.kf_map[[kf, h.target_kf]].cpu())
        K = ms.kf_valid.shape[0]
        # S_w2<-w1 = S_cw^-1 * T_cw1 (w2: target world, w1: current world)
        S_21 = lie.sim3_compose(lie.sim3_inverse(self._hyp_sim3(h)),
                                self._pose_sim3(kf))
        S_12 = lie.sim3_inverse(S_21)
        in_cur = ms.kf_valid & (ms.kf_map == cur_map)
        mp_cur = ms.mp_valid & (ms.mp_map == cur_map)

        # KF poses T'_cw2 = T_cw1 * S_12 with the scale folded into t;
        # points x2 = S_21(x1), distance bounds scaled by s21
        T_new = lie.sim3_compose(
            self._pose_sim3(torch.arange(K, device=self.device)),
            lie.Sim3(S_12.q.expand(K, 4), S_12.t.expand(K, 3),
                     S_12.s.expand(K)))
        w_kf, w_mp = in_cur[:, None], mp_cur[:, None]
        ms = ms._replace(
            kf_q=torch.where(w_kf, lie.quat_normalize(T_new.q), ms.kf_q),
            kf_t=torch.where(
                w_kf, T_new.t / torch.clamp(T_new.s[:, None], min=1e-9),
                ms.kf_t),
            kf_map=torch.where(in_cur, tgt_map, ms.kf_map),
            mp_pos=torch.where(w_mp, lie.sim3_apply(S_21, ms.mp_pos),
                               ms.mp_pos),
            mp_map=torch.where(mp_cur, tgt_map, ms.mp_map),
            map_valid=S.set_at(ms.map_valid, cur_map, False),
            map_change=S.set_at(ms.map_change, tgt_map,
                                ms.map_change[tgt_map] + 1),
            mp_min_dist=torch.where(mp_cur, ms.mp_min_dist * S_21.s,
                                    ms.mp_min_dist),
            mp_max_dist=torch.where(mp_cur, ms.mp_max_dist * S_21.s,
                                    ms.mp_max_dist))

        # the merging KF becomes a child of the matched KF and its old
        # ancestor chain is reversed: one tree rooted in the target map
        parent = ms.kf_parent.cpu().numpy().copy()
        chain = [kf]
        p = int(parent[kf])
        while p >= 0 and len(chain) <= K:
            chain.append(p)
            p = int(parent[p])
        for child, par in zip(chain[:-1], chain[1:]):
            parent[par] = child
        parent[kf] = h.target_kf
        ms = ms._replace(kf_parent=self._tensor(parent, torch.int32))
        sysm.ms = S.add_loop_edge(ms, h.target_kf, kf)

        # retarget the absorbed map's agents; the merging agent's pose
        # moves into the target frame
        for a in sysm.agents:
            if a.map_id == cur_map:
                a.map_id = tgt_map
                if a.q is not None and a.agent_id == agent_id:
                    T_an = lie.sim3_compose(lie.sim3_from_se3(lie.SE3(
                        self._tensor(a.q), self._tensor(a.t))), S_12)
                    a.q = lie.quat_normalize(T_an.q).cpu().numpy()
                    a.t = (T_an.t / torch.clamp(T_an.s, min=1e-9)
                           ).cpu().numpy()
                    a.dev_chain = None

        # weld: fuse around the seam, refresh, welding BA (adjust the
        # absorbed side of the window, the target side fixed), merge PGO
        local_mask = sysm.fns["local_mp_mask"](sysm.ms, h.target_kf, 16)
        ms2, _ = sysm.fns["fuse_step"](sysm.ms, kf, local_mask)
        sysm.ms = sysm.fns["refresh_stats"](ms2, ms2.mp_valid)
        q_pre, t_pre = sysm.ms.kf_q, sysm.ms.kf_t
        sysm.ms, weld_mask, weld_pts = sysm.fns["welding_ba"](sysm.ms, kf,
                                                              in_cur)
        self._merge_pgo(in_cur, weld_mask, weld_pts, q_pre, t_pre, tgt_map)
        n_in_tgt = int((sysm.ms.kf_valid & (sysm.ms.kf_map == tgt_map)).sum())
        if n_in_tgt < self.cfg.max_kf_for_gba:
            self._run_gba(tgt_map)
        self.events.append(
            f"MERGE agent={agent_id} map {cur_map} -> {tgt_map} kf={kf} "
            f"target={h.target_kf} ts={float(sysm.ms.kf_ts[kf]):.6f}")
        self.timers.add("MM", (time.perf_counter() - t0) * 1e3)

    def _merge_pgo(self, in_cur, weld_mask, weld_pts, q_pre, t_pre,
                   tgt_map):
        """The merge overload of the essential-graph PGO: with every
        original target-map KF and the welded window fixed, carry the
        window's motion out to the absorbed map's remaining KFs, with
        edges measured at the pre-weld poses; move their points (those the
        weld optimised excepted) and refresh the moved points' stats."""
        sysm = self.sys
        ms = sysm.ms
        K = ms.kf_valid.shape[0]
        merged_t = ms.kf_valid & (ms.kf_map == tgt_map)
        fixed_t = merged_t & (~in_cur | weld_mask)
        free_t = merged_t & ~fixed_t
        merged, fixed, free = (x.cpu().numpy() for x in
                               (merged_t, fixed_t, free_t))
        if not free.any() or not fixed.any():
            return
        ei, ej, ew = self._essential_edge_set(ms, merged)
        if len(ei) == 0:
            return
        qrel, trel = _batched_rel(q_pre, t_pre,
                                  torch.as_tensor(ei, device=self.device).long(),
                                  torch.as_tensor(ej, device=self.device).long())
        E = len(ei)
        edges = pgo_mod.PGOEdges(
            i=self._tensor(ei, torch.int32), j=self._tensor(ej, torch.int32),
            q=qrel, t=trel, s=torch.ones(E, device=self.device),
            w=self._tensor(ew),
            valid=torch.ones(E, dtype=torch.bool, device=self.device))
        ones = torch.ones(K, device=self.device)
        q_n, t_n, s_n = pgo_mod.optimize_essential_graph(
            ms.kf_q, ms.kf_t, ones, fixed_t | ~merged_t, edges, iters=10)
        # points of the free remainder move with their reference KF, the
        # welded points (already optimised) excepted
        ref_free = free_t[torch.clamp(ms.mp_ref_kf, 0, K - 1).long()]
        mp_mask = (ms.mp_valid & (ms.mp_map == tgt_map) & ref_free
                   & ~weld_pts)
        new_pos = pgo_mod.correct_points_by_ref(
            ms.mp_pos, ms.mp_ref_kf, mp_mask, ms.kf_q, ms.kf_t, ones, q_n,
            t_n, s_n)
        upd = free_t[:, None]
        sysm.ms = ms._replace(
            kf_q=torch.where(upd, lie.quat_normalize(q_n), ms.kf_q),
            kf_t=torch.where(upd, t_n / torch.clamp(s_n[:, None], min=1e-9),
                             ms.kf_t),
            mp_pos=new_pos)
        sysm.ms = sysm.fns["refresh_stats"](sysm.ms, mp_mask | weld_pts)
