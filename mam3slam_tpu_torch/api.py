"""Public API facade: MultiAgentSystem.

Port of ``mam3slam_tpu.api`` (the reference's ``MultiAgentSystem`` /
``Agent`` layer): construct the shared system, ``add_agent(settings_yaml)``,
feed images with ``track_monocular``, query ``get_agents_in_map``, then
``shutdown`` and export the artifacts.  As in the reference, no vocabulary
file is required (the server trains one from the stream when none is
given or found), agents may have their own intrinsics but share the image
geometry and camera kind, and there is no viewer.

The system runs on ``device``, the card unless the caller passes
``device="cpu"``.  ``async_mapping=True`` runs the mapping and server
epochs in a worker thread; ``pipeline=True`` defers each frame's result
by one frame (``track_monocular`` then returns the previous frame's state
and pose; set ``sys.pipeline_depth`` for a deeper lag, as bench.py does).
``shutdown`` completes the deferred frames, the worker's jobs and a
pending background global BA before it writes the artifacts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import List, Optional

import numpy as np
import torch

from mam3slam_tpu_torch.io import settings as settings_mod
from mam3slam_tpu_torch.io import writers
from mam3slam_tpu_torch.ops import bow
from mam3slam_tpu_torch.ops import orb
from mam3slam_tpu_torch.slam import steps
from mam3slam_tpu_torch.slam.server import LoopServer, ServerConfig
from mam3slam_tpu_torch.slam.system import SlamConfig, SlamSystem
from mam3slam_tpu_torch.utils.timing import TRACER


@functools.lru_cache(maxsize=None)
def _area_weights(ssize: int, dsize: int, device: torch.device):
    """[ssize, dsize] f32 weights of OpenCV's INTER_AREA downscale along
    one axis (imgproc resize.cpp ``computeResizeAreaTab``): output sample
    d averages the source cell [d s, (d + 1) s), s = ssize / dsize, each
    source pixel weighted by its overlap with the cell over the cell's
    width (cut at the image's end)."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((ssize, dsize), np.float32)
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[s1 - 1, d] += np.float32((s1 - f1) / cell)
        w[s1:s2, d] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[s2, d] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return torch.tensor(w, device=device)


@functools.lru_cache(maxsize=None)
def _linear_area_taps(ssize: int, dsize: int, device: torch.device):
    """The two taps of the rule OpenCV's INTER_AREA takes along both axes
    once either axis grows (resize.cpp's ``resize`` with ``area_mode``),
    as (i0, i1, w0, w1) over the ``dsize`` outputs: output d samples
    source sx = floor(d s) with weight 1 - fx and sx + 1 with fx, where
    fx = (d + 1) - (sx + 1) / s wrapped into [0, 1) (0 where it is not
    positive), s = 1 / (dsize / ssize) in double as OpenCV computes it
    and fx in f32; at the last source pixel sx is clamped and fx = 0.
    An axis of equal size comes out as the identity."""
    inv = dsize / ssize
    scale = 1.0 / inv
    i0 = np.zeros(dsize, np.int64)
    fx = np.zeros(dsize, np.float32)
    for d in range(dsize):
        sx = math.floor(d * scale)
        f = np.float32((d + 1) - (sx + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(math.floor(f))
        if sx >= ssize - 1:
            sx, f = ssize - 1, np.float32(0.0)
        i0[d], fx[d] = sx, f
    i1 = np.minimum(i0 + 1, ssize - 1)
    return tuple(torch.tensor(a, device=device)
                 for a in (i0, i1, np.float32(1.0) - fx, fx))


def area_resize(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    of a 2-D f32 image, in any direction, on the image's device.  When no
    axis grows: two products of per-axis area weights, in full f32 (no
    TF32).  Once either axis grows, OpenCV's two-tap rule on both axes
    (a shrinking axis of a mixed resize included), in its order and
    rounding: each row's taps x0 * w0 + x1 * w1 first, then the rows',
    each product and sum rounded to f32, which gives cv2's pixels bit for
    bit (an upscaled frame has near ties between FAST scores that a last
    bit reorders)."""
    h, w = img.shape
    if height <= h and width <= w:
        wy = _area_weights(h, height, img.device)
        wx = _area_weights(w, width, img.device)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return (wy.T @ img) @ wx
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    x0, x1, a0, a1 = _linear_area_taps(w, width, img.device)
    y0, y1, b0, b1 = _linear_area_taps(h, height, img.device)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


class MultiAgentSystem:
    """Owns the shared map state, the central loop server, and agents."""

    def __init__(self, vocabulary: Optional[bow.Vocabulary] = None,
                 active_loop_closing: bool = True,
                 server_config: Optional[ServerConfig] = None,
                 slam_config: Optional[SlamConfig] = None, seed: int = 0,
                 async_mapping: bool = False,
                 pipeline: bool = False,
                 slam_overrides: Optional[dict] = None,
                 device=torch.device("cuda")):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultiAgentSystem: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self._vocab = vocabulary
        self._active_lc = active_loop_closing
        self._server_cfg = server_config or ServerConfig()
        self._slam_cfg = slam_config
        self._slam_overrides = slam_overrides or {}
        self._seed = seed
        self._async_mapping = async_mapping
        self._pipeline = pipeline
        self.sys: Optional[SlamSystem] = None
        self.server: Optional[LoopServer] = None
        self._settings: List[settings_mod.Settings] = []
        self._orb_cfgs: List[orb.OrbConfig] = []

    # -- reference: MultiAgentSystem::addAgent(settingsYaml) ----------------
    def add_agent(self, settings_yaml: str) -> int:
        st = settings_mod.load_settings(settings_yaml)
        W, H = st.eff_width, st.eff_height  # after Camera.newWidth resize
        if self._vocab is None:
            # a vocabulary file ($MAM3_VOCAB or data/ORBvoc.txt) is loaded
            # at startup when present, as the reference's constructor does
            self._vocab = bow.default_vocabulary()
        cam = st.camera(self.device)
        if self.sys is None:
            cfg = self._slam_cfg or SlamConfig(
                width=W, height=H, cam_kind=cam.kind,
                n_levels=st.n_levels, scale_factor=st.scale_factor,
                n_feat=orb.OrbConfig(
                    height=H, width=W, n_features=st.n_features,
                    n_levels=st.n_levels,
                    scale_factor=st.scale_factor).capacity)
            if self._slam_overrides:
                cfg = dataclasses.replace(cfg, **self._slam_overrides)
            self.sys = SlamSystem(cfg, cam, seed=self._seed,
                                  async_mapping=self._async_mapping)
            self.sys.pipeline = self._pipeline
            if self._active_lc:
                self.server = LoopServer(self.sys, self._server_cfg,
                                         vocab=self._vocab, seed=self._seed)
                self.sys.server = self.server
        elif (W, H) != (self._settings[0].eff_width,
                        self._settings[0].eff_height):
            raise ValueError(
                "all agents must share image geometry in this build")
        self._settings.append(st)
        self._orb_cfgs.append(orb.OrbConfig(
            height=H, width=W, n_features=st.n_features,
            n_levels=st.n_levels, scale_factor=st.scale_factor,
            ini_th=st.ini_th_fast, min_th=st.min_th_fast))
        return self.sys.add_agent(cam=cam)

    # -- reference: Agent::TrackMonocular ----------------------------------
    def _frame_tensor(self, st: settings_mod.Settings, image):
        """The image as f32 [H, W] on the system's device at the working
        geometry (``Camera.newWidth`` / ``newHeight`` when the settings
        give them, else ``Camera.width`` / ``height``): an f32 tensor
        already there with that geometry as it is, another tensor moved
        and cast there, anything else through numpy f32.  A frame of
        another shape then goes through ``area_resize`` on the device, as
        the reference's cv2.resize INTER_AREA on the host, whichever way
        each axis goes."""
        if isinstance(image, torch.Tensor):
            img = image.to(self.device, torch.float32)
        else:
            img = torch.as_tensor(np.asarray(image, np.float32),
                                  device=self.device)
        if tuple(img.shape) != (st.eff_height, st.eff_width):
            # the settings' resize (reference Agent::TrackMonocular)
            img = area_resize(img, st.eff_height, st.eff_width)
        return img

    def track_monocular(self, agent_id: int, image, ts: float):
        """Grayscale image [H, W] (uint8 or f32 0..255; numpy or a tensor)
        -> (state, (q, t) of T_cw or None)."""
        a = self.sys.agents[agent_id]
        with TRACER.frame(agent_id, a.calls):
            img = self._frame_tensor(self._settings[agent_id], image)
            with TRACER.span("extract"):
                feats = orb.with_undistorted(
                    orb.extract_orb(img, self._orb_cfgs[agent_id]), a.cam)
            frame = steps.FrameObs(uv=feats.uv, level=feats.level,
                                   angle=feats.angle, desc=feats.desc,
                                   valid=feats.valid)
            return self.sys.track(agent_id, frame, ts)

    # -- reference: MultiAgentSystem::GetAgentsInMap ------------------------
    def get_agents_in_map(self, map_id: int) -> List[int]:
        return [a.agent_id for a in self.sys.agents if a.map_id == map_id]

    @property
    def agents(self):
        return self.sys.agents if self.sys else []

    # -- reference: Shutdown + Save* ---------------------------------------
    def shutdown(self, out_dir: Optional[str] = None):
        """Complete the deferred frames, drain the worker's jobs and apply
        a pending background GBA, join the worker, then export the
        artifacts to ``out_dir`` when given."""
        if self.sys is not None:
            self.sys.shutdown()
        if out_dir:
            writers.save_all(self.sys, self.server, out_dir)

    def save_kf_trajectory(self, path: str):
        writers.save_kf_trajectory(self.sys, path)

    def save_trajectory(self, agent_id: int, path: str):
        writers.save_trajectory(self.sys, agent_id, path)

    def save_times(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for a in self.sys.agents:
            writers.save_times(self.sys, a.agent_id,
                               os.path.join(out_dir,
                                            f"TimesT_{a.agent_id}.txt"))
