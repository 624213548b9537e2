"""The one traffic generator: reads a mix (``traffic/<name>.json``) and a
deployment (``configs/<name>.json``) and makes, from ``--seed``, every
agent's frames on the card and the poses they were rendered from.

A mix names its agents, each with an orbit arc (``arc``: start and end
degrees, ``frames``, ``bob`` in metres, ``radius``) and the room it flies
in (``room``).  Room ``r`` is drawn from ``np.random.SeedSequence([seed,
r])``, so agents that name one room share a view and agents in rooms of
their own share none.  An agent flies at most the deployment's
``sequence_frames``.  Frames are rendered with the frozen renderer
(``ref/render.py``) and staged on the card as u8, as a camera's DMA
delivers them; an agent's frame ``i`` has the stamp ``i / fps``.  Every
mission flies the same frames: each ``track_monocular`` call is issued
when the previous one returns, round-robin over the agents, and the next
mission starts on a fresh system when one ends.  ``warmup_frames`` is how
many of each agent's frames the set-up's warm-up feeds, and
``warmup_until`` a server event after which it stops sooner.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from slambench.ref import render


@dataclass
class Agent:
    frames: torch.Tensor      # [N, H, W] u8 on the device
    centres: np.ndarray       # [N, 3] f64 true camera centres
    room: int
    fps: float

    @property
    def n(self) -> int:
        return self.frames.shape[0]


def render_cam(settings: dict) -> render.RenderCam:
    """The camera the frames are rendered by: the settings' intrinsics at
    their image size, KB8 for a KannalaBrandt8 camera, otherwise a
    pinhole with no distortion."""
    kb8 = settings["Camera.type"] == "KannalaBrandt8"
    return render.RenderCam(
        width=int(settings["Camera.width"]),
        height=int(settings["Camera.height"]),
        fx=float(settings["Camera1.fx"]), fy=float(settings["Camera1.fy"]),
        cx=float(settings["Camera1.cx"]), cy=float(settings["Camera1.cy"]),
        fps=float(settings["Camera.fps"]),
        model="kb8" if kb8 else "pinhole",
        k=(tuple(float(settings[f"Camera1.k{i}"]) for i in range(1, 5))
           if kb8 else (0.0, 0.0, 0.0, 0.0)))


def room_seed(seed: int, room: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed), int(room)])


def make_agents(traffic: dict, config: dict, seed: int,
                device) -> List[Agent]:
    """Every agent of the mix, in its rooms drawn from ``seed``, rendered
    on ``device``."""
    cam = render_cam(config["settings"])
    cap = int(config["sequence_frames"])
    scenes = {}
    agents = []
    for spec in traffic["agents"]:
        if int(spec["frames"]) > cap:
            raise ValueError(f"an agent flies {spec['frames']} frames, over "
                             f"the deployment's sequence_frames {cap}")
        r = int(spec["room"])
        if r not in scenes:
            scenes[r] = render.RoomScene(seed=room_seed(seed, r),
                                         device=device)
        traj = render.orbit_trajectory(
            int(spec["frames"]), float(spec["arc"][0]), float(spec["arc"][1]),
            radius=float(spec.get("radius", 2.5)),
            bob=float(spec.get("bob", 0.0)))
        frames = torch.empty((len(traj), cam.height, cam.width),
                             dtype=torch.uint8, device=device)
        for i, (R, t, _) in enumerate(traj):
            frames[i] = torch.round(scenes[r].render(R, t, cam)).to(
                torch.uint8)
        agents.append(Agent(frames=frames,
                            centres=np.stack([c for _, _, c in traj]),
                            room=r, fps=cam.fps))
    return agents


def schedule(agents: List[Agent], per_agent: Optional[int] = None):
    """The order a mission offers its frames: (agent, frame index)
    round-robin over the agents, each until its arc ends, or its first
    ``per_agent`` frames."""
    n = max(a.n for a in agents)
    if per_agent is not None:
        n = min(n, int(per_agent))
    return [(k, i) for i in range(n) for k, a in enumerate(agents)
            if i < a.n]


def frame_of(ts: float, fps: float) -> int:
    return int(math.floor(ts * fps + 0.5))
