"""Background global bundle adjustment.

Port of ``mam3slam_tpu.slam.background_gba`` (the reference's GBA thread,
``LoopClosing::RunGlobalBundleAdjustment``): ``start`` snapshots the
functional ``MapState`` and launches a 10-iteration full-map BA of one
map; tracking and mapping go on meanwhile; ``ready`` polls it;
``finish`` reconciles the result into the current state, which may have
grown: keyframes born during the GBA get their parent's before/after
correction down the spanning tree, and points the GBA did not optimise
move with their reference keyframe.  ``abort`` drops the result (the
reference's ``mbStopGBA``: the corrections are never applied).

On the card the GBA runs on a side stream (the reference dispatches it
to another device of its mesh): ``start`` records an event on the
current stream and the side stream waits for it before it reads the
snapshot; a second event after the GBA answers ``ready`` and is waited
for by ``finish``.  The snapshot's tensors were allocated on the current
stream, so the caching allocator could hand their blocks to new work
there once the last reference died while the side stream still reads
them.  Every tensor the GBA reads or writes is therefore held (in
``_pending``, or after ``abort`` in ``_retired``) until its event has
completed.  On the CPU the GBA runs in place.

Identity across the GBA: keyframe slots recycle after culling, so a slot
holds the same keyframe iff its ``kf_seq`` is unchanged; keyframes born
during the GBA have ``kf_seq`` >= the snapshot's ``n_kf``.  A point slot
is the same point iff it is valid on both sides with an unchanged
``mp_first_kf`` below ``n_kf``.
"""

from __future__ import annotations

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.solvers import pgo as pgo_mod


class BackgroundGBA:
    """At most one global BA in flight for a SlamSystem.  ``stream``: the
    CUDA stream it runs on (None: a side stream of its own on a CUDA
    system)."""

    def __init__(self, system, stream=None):
        self.sys = system
        self.stream = stream
        if system.device.type == "cuda" and stream is None:
            self.stream = torch.cuda.Stream(device=system.device)
        self._pending = None   # (outputs, snapshot, map state, done event)
        self._retired = []     # aborted (map state, outputs, done event)
        self.started = []      # map id of every GBA started

    def _compute(self, ms, map_id: int):
        """``programs()["global_ba"]`` of the map (anchored at its oldest
        keyframe by ``kf_seq``).  Returns (kf_q, kf_t, mp_pos, optimised
        keyframe mask, optimised point mask)."""
        ms2, opt_mask, pt_mask = self.sys.fns["global_ba_masks"](ms, map_id)
        return ms2.kf_q, ms2.kf_t, ms2.mp_pos, opt_mask, pt_mask

    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._pending is not None

    def start(self, map_id: int) -> None:
        """Snapshot the current state and launch the GBA of ``map_id``."""
        assert not self.running
        self._release_retired()
        self.started.append(int(map_id))
        ms = self.sys.ms
        host = torch.stack([ms.kf_seq, ms.n_kf.expand_as(ms.kf_seq)]
                           ).cpu().numpy()
        snap = dict(map_id=int(map_id), n_kf=int(host[1, 0]),
                    kf_seq=host[0], mp_first_kf=ms.mp_first_kf.cpu().numpy())
        if self.stream is None:
            self._pending = (self._compute(ms, map_id), snap, ms, None)
            return
        snapshot_ready = torch.cuda.Event()
        snapshot_ready.record()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(snapshot_ready)
            out = self._compute(ms, map_id)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._pending = (out, snap, ms, done)

    def abort(self) -> None:
        """Drop the pending result; its tensors are held until the side
        stream is done with them."""
        out, _, ms, done = self._pending
        self._pending = None
        if done is not None:
            self._retired.append((ms, out, done))
        self._release_retired()

    def _release_retired(self) -> None:
        self._retired = [r for r in self._retired if not r[2].query()]

    @property
    def ready(self) -> bool:
        if not self.running:
            return False
        done = self._pending[3]
        return done is None or done.query()

    # ------------------------------------------------------------------
    def finish(self) -> bool:
        """Reconcile the GBA result into the (possibly grown) current
        state.  Returns True if corrections were applied."""
        assert self.running
        out, snap, _, done = self._pending
        if done is not None:
            done.synchronize()
        self._pending = None
        q_g, t_g, pos_g, opt_g, ptf_g = (x.cpu().numpy() for x in out)

        sysm = self.sys
        ms = sysm.ms
        map_id = snap["map_id"]
        n_snap = snap["n_kf"]
        kf_valid = ms.kf_valid.cpu().numpy()
        kf_map = ms.kf_map.cpu().numpy()
        parent = ms.kf_parent.cpu().numpy()
        q_now = ms.kf_q.cpu().numpy()
        t_now = ms.kf_t.cpu().numpy()
        kf_seq = ms.kf_seq.cpu().numpy()
        K = kf_valid.shape[0]

        # direct write-back: optimised keyframes still alive in the map
        # (same kf_seq: the slot was not culled and recycled meanwhile)
        same_kf = kf_valid & (kf_seq == snap["kf_seq"])
        upd = opt_g & same_kf & (kf_map == map_id)
        if not upd.any():
            return False
        q_new = q_now.copy()
        t_new = t_now.copy()
        q_new[upd] = q_g[upd]
        t_new[upd] = t_g[upd]

        # spanning-tree catch-up of keyframes born during the GBA, in
        # creation (kf_seq) order so that parents come first:
        # T_new(child) = T_now(child) T_now(parent)^-1 T_new(parent)
        def pose(q, t, k):
            return lie.SE3(torch.from_numpy(q[k]), torch.from_numpy(t[k]))

        corrected = upd.copy()
        born = np.where(kf_valid & (kf_map == map_id) & (kf_seq >= n_snap))[0]
        for k in born[np.argsort(kf_seq[born], kind="stable")]:
            p = parent[k]
            if p < 0 or not corrected[p]:
                continue
            T_rel = lie.se3_compose(pose(q_now, t_now, k),
                                    lie.se3_inverse(pose(q_now, t_now, p)))
            T_kn = lie.se3_compose(T_rel, pose(q_new, t_new, p))
            q_new[k] = T_kn.q.numpy()
            t_new[k] = T_kn.t.numpy()
            corrected[k] = True

        # points the GBA optimised that are still the same point
        mp_valid = ms.mp_valid.cpu().numpy()
        mp_map = ms.mp_map.cpu().numpy()
        first_now = ms.mp_first_kf.cpu().numpy()
        same_pt = (ptf_g & mp_valid & (mp_map == map_id)
                   & (first_now == snap["mp_first_kf"]) & (first_now < n_snap))
        pos_new = ms.mp_pos.cpu().numpy().copy()
        pos_new[same_pt] = pos_g[same_pt]

        # the map's other live points move with their reference keyframe
        mp_ref = ms.mp_ref_kf.cpu().numpy()
        ref_ok = (mp_ref >= 0) & corrected[np.clip(mp_ref, 0, K - 1)]
        rest = mp_valid & (mp_map == map_id) & ~same_pt & ref_ok
        dev = sysm.device
        T = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        pos_t = T(pos_new)
        if rest.any():
            ones = torch.ones(K, device=dev)
            pos_t = pgo_mod.correct_points_by_ref(
                pos_t, ms.mp_ref_kf, T(rest), T(q_now), T(t_now), ones,
                T(q_new), T(t_new), ones)
        sysm.ms = ms._replace(
            kf_q=T(q_new), kf_t=T(t_new), mp_pos=pos_t,
            map_change=S.set_at(ms.map_change, map_id,
                                ms.map_change[map_id] + 1))
        return True
