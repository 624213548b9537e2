#!/usr/bin/env python3
"""Run chip_smoke.py's phase 10 (the mono-inertial loop and the yaw
burst) several times in one process on the card and print 10a's ATE
after each run, to see how far the card's runs spread.

    python3 tools/phase10_spread.py [--reps N]

Since the solvers' sums take a fixed order (``ops/segsum.py``) every
run prints the same ``ate_frac``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mam3slam_tpu_torch import _build  # noqa: E402
from mam3slam_tpu_torch.geometry import cameras  # noqa: E402
from mam3slam_tpu_torch.io import render  # noqa: E402
from mam3slam_tpu_torch.ops import orb as O  # noqa: E402
from mam3slam_tpu_torch.slam import system  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase10_spread: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    _build.library()
    cam_r = render.RenderCam(cs.W, cs.H, cs.FX, cs.FY, cs.CX, cs.CY)
    orb_cfg = O.OrbConfig(height=cs.H, width=cs.W,
                          n_features=cs.N_FEATURES)
    cfg = system.SlamConfig(width=cs.W, height=cs.H, n_feat=orb_cfg.capacity)
    cam = cameras.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY, device=dev)
    scene6 = render.RoomScene(seed=cs.SERVER_SCENE_SEED, device=dev)
    loop_arc = render.orbit_trajectory(cs.LOOP_FRAMES, *cs.LOOP_ARC[:2],
                                       radius=2.5, bob=cs.LOOP_ARC[2])
    for rep in range(args.reps):
        t = time.time()
        i10 = cs.run_phase10(scene6, cam_r, cam, orb_cfg, cfg, loop_arc)[0]
        print(f"REP {rep} ate_frac={i10['ate_frac']} "
              f"bound={cs.INERTIAL_MAX_ATE_FRAC} s={time.time() - t:.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
