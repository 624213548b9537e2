#!/usr/bin/env python3
"""Both packages' ``MultiAgentSystem`` on KB8 frames of the orbit of
tests/test_torch_api.py rendered at one size and resized by the
settings (``Camera.newWidth`` / ``newHeight``) to another, the port at
several torch thread counts: how far the port's camera centres land from
the reference's, as a fraction of the orbit's span (the facade twin of
tests/test_torch_resize.py holds them to 1e-3).  CPU only; imports JAX.

    python3 tools/upscale_twin_spread.py [--scale 0.25] [--frames 30]
        [--u8] [--working 320] [--threads 1 2 8]

``--u8`` rounds the rendered frames to u8, as a camera delivers them;
without it they stay f32, as tests/test_torch_api.py feeds them.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from mam3slam_tpu import api as japi  # noqa: E402
from mam3slam_tpu.io import render as jrender  # noqa: E402
from mam3slam_tpu_torch import api as tapi  # noqa: E402
from test_torch_api import OVERRIDES, _yaml  # noqa: E402
from test_torch_capacity import reference_draws  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="the fixture camera's scale the frames are "
                    "rendered at")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--u8", action="store_true")
    ap.add_argument("--working", type=int, default=320)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 8])
    args = ap.parse_args()
    cam = jrender.reference_kb8_cam(args.scale)
    scene = jrender.RoomScene(seed=5)
    n = args.frames
    traj = jrender.orbit_trajectory(n, 0.0, 1.875 * n, radius=2.5, bob=0.05)
    frames = []
    for R, t, _, _ in traj:
        img = scene.render(R, t, cam)
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8)
                      if args.u8 else img.astype(np.float32))
    span = float(np.ptp(np.asarray([C for _, _, C, _ in traj]), 0).max())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kb8.yaml")
        with open(path, "w") as f:
            f.write(_yaml(cam).replace(
                "Camera.fps: 20", f"Camera.fps: 20\nCamera.newWidth: "
                f"{args.working}\nCamera.newHeight: {args.working}"))

        def run(mas, port):
            aid = mas.add_agent(path)
            if port:
                reference_draws(mas.sys, 0)
            states = [mas.track_monocular(aid, img, i / 20.0)[0]
                      for i, img in enumerate(frames)]
            mas.shutdown()
            ms = mas.sys.ms
            return dict(states=states, events=list(mas.sys.events),
                        n_kf=int(np.asarray(ms.kf_valid).sum()),
                        n_mp=int(np.asarray(ms.mp_valid).sum()),
                        centres=np.asarray(
                            [r[2] for r in mas.sys.trajectory_world(aid)]))

        ref = run(japi.MultiAgentSystem(active_loop_closing=False,
                                        slam_overrides=OVERRIDES), False)
        for th in args.threads:
            torch.set_num_threads(th)
            got = run(tapi.MultiAgentSystem(active_loop_closing=False,
                                            slam_overrides=OVERRIDES,
                                            device="cpu"), True)
            err = (np.linalg.norm(got["centres"] - ref["centres"], axis=1)
                   .max() / span if got["centres"].shape
                   == ref["centres"].shape else float("nan"))
            print(f"frames={cam.width}x{cam.height} n={n} "
                  f"{'u8' if args.u8 else 'f32'} working={args.working} "
                  f"threads={th} states_equal={got['states'] == ref['states']}"
                  f" keyframes={got['n_kf']}/{ref['n_kf']} "
                  f"points={got['n_mp']}/{ref['n_mp']} "
                  f"init={got['events'][:1]}/{ref['events'][:1]} "
                  f"centres_over_span={err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
