#!/usr/bin/env python
"""Self-contained demo on the PyTorch + CUDA port: two agents map a
synthetic scene, the central server fuses their maps, and the artifact
set and a map render are written to --out.

    python examples/torch_run_synthetic_demo.py --out /tmp/demo_torch
    python examples/torch_run_synthetic_demo.py --cpu --out /tmp/demo_torch

The port's twin of examples/run_synthetic_demo.py: the same world (its
own numpy copy of the landmark world and arcs of the reference's tests,
drawn from the generator in the same order), system and server
configuration; the device is the card unless --cpu is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from scipy.spatial.transform import Rotation

FX, FY, CX, CY = 300.0, 300.0, 320.0, 240.0
W, H = 640, 480
N_FEAT = 256


class SyntheticWorld:
    """Landmarks with stable descriptors; renders the features of a pose
    (uv, level, angle, desc, valid as numpy arrays)."""

    def __init__(self, n_mp=800, seed=0):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.pts = np.stack([
            rng.uniform(-6, 8, n_mp), rng.uniform(-4, 4, n_mp),
            rng.uniform(3, 14, n_mp)], axis=1).astype(np.float32)
        self.desc = rng.integers(0, 256, (n_mp, 32), dtype=np.uint8)

    def render(self, R, t, noise=0.3, flip_bits=2):
        pc = self.pts @ R.T + t
        uv = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6) * [FX, FY] + [CX, CY]
        vis = ((pc[:, 2] > 0.5) & (pc[:, 2] < 20)
               & (uv[:, 0] > 5) & (uv[:, 0] < W - 5)
               & (uv[:, 1] > 5) & (uv[:, 1] < H - 5))
        ids = np.where(vis)[0][:N_FEAT]  # deterministic subset
        n = len(ids)
        f_uv = np.zeros((N_FEAT, 2), np.float32)
        f_desc = np.zeros((N_FEAT, 32), np.uint8)
        f_uv[:n] = uv[ids] + self.rng.normal(0, noise, (n, 2))
        d = self.desc[ids].copy()
        # flip a couple of random bits (descriptor noise)
        for _ in range(flip_bits):
            byte = self.rng.integers(0, 32, n)
            bit = self.rng.integers(0, 8, n).astype(np.uint8)
            d[np.arange(n), byte] ^= (1 << bit).astype(np.uint8)
        f_desc[:n] = d
        valid = np.arange(N_FEAT) < n
        return (f_uv, np.zeros(N_FEAT, np.int32),
                np.zeros(N_FEAT, np.float32), f_desc, valid), ids


def arc_trajectory(n, start_x=0.0, step=0.045):
    """Sideways + forward arc with a gentle yaw: (R, t) world->cam."""
    poses = []
    for i in range(n):
        yaw = np.deg2rad(0.1 * i)
        R = Rotation.from_euler("y", yaw).as_matrix().astype(np.float32)
        C = np.array([start_x + step * i, 0.01 * np.sin(i * 0.3),
                      0.015 * i], np.float32)
        t = (-R @ C).astype(np.float32)
        poses.append((R, t))
    return poses


def run(out: str, frames: int = 50, device="cuda"):
    """The demo: returns the system (its server attached) after writing
    the artifacts and ``map.png`` to ``out``."""
    import torch

    from mam3slam_tpu_torch.geometry import cameras
    from mam3slam_tpu_torch.io import viewer, writers
    from mam3slam_tpu_torch.slam import steps
    from mam3slam_tpu_torch.slam.server import LoopServer, ServerConfig
    from mam3slam_tpu_torch.slam.system import SlamConfig, SlamSystem

    dev = torch.device(device)
    world = SyntheticWorld(n_mp=1200, seed=1)
    cam = cameras.make_pinhole(FX, FY, CX, CY, device=dev)
    cfg = SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=96,
                     max_mp=6144, n_levels=4, kf_max_interval=10,
                     min_init_matches=60)
    sys_ = SlamSystem(cfg, cam)
    a0 = sys_.add_agent()
    a1 = sys_.add_agent()
    srv = LoopServer(sys_, ServerConfig(min_kfs_in_map=4, vocab_k=8,
                                        vocab_depth=3))
    sys_.server = srv

    trajs = [arc_trajectory(frames, start_x=0.0),
             arc_trajectory(frames, start_x=1.1)]
    t = 0.0
    for aid, traj in zip([a0, a1], trajs):
        for R, tt in traj:
            f, _ = world.render(R, tt)
            sys_.track(aid, steps.FrameObs(
                *(torch.from_numpy(x).to(dev) for x in f)), t)
            t += 1.0
        print(f"agent {aid}: state={sys_.agents[aid].state} "
              f"map={sys_.agents[aid].map_id}")

    print("server events:", srv.events)
    sys_.shutdown()
    os.makedirs(out, exist_ok=True)
    writers.save_all(sys_, srv, out)
    viewer.render_map(sys_, os.path.join(out, "map.png"), server=srv)
    n_kf = int(sys_.ms.kf_valid.sum())
    n_mp = int(sys_.ms.mp_valid.sum())
    print(f"done: {n_kf} keyframes, {n_mp} map points -> {out}")
    return sys_


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/mam3slam_demo_torch")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    run(args.out, args.frames, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
