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


def area_resize(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    of a 2-D f32 image for a downscale (integer or fractional factors), as
    two products of per-axis weights on the image's device."""
    h, w = img.shape
    if height > h or width > w:
        raise NotImplementedError(
            f"area resize upscales {h}x{w} -> {height}x{width}: only "
            f"downscaling is ported")
    wy = _area_weights(h, height, img.device)
    wx = _area_weights(w, width, img.device)
    return (wy.T @ img) @ wx


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
        geometry: an f32 tensor already there with that geometry as it
        is, another tensor moved and cast there, anything else through
        numpy f32 (and then the settings' area resize on the device)."""
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
        img = self._frame_tensor(self._settings[agent_id], image)
        a = self.sys.agents[agent_id]
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
