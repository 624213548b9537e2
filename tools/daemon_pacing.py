#!/usr/bin/env python3
"""Repeats of chip_smoke.py's phase 9b, the live daemon with two agents,
at chosen client paces on one GPU.

    python3 tools/daemon_pacing.py [--hz 4 4 4 2 2]

Builds the kernels, warms the path with one short run (the arcs' first
20 frames, unpaced, no gates), then runs ``chip_smoke.run_daemon`` on
phase 9b's arcs (``chip_smoke.DAEMON_ARCS``, ``DAEMON_FRAMES`` frames
each) once per ``--hz`` value, each client paced at that rate, and holds
each run to ``chip_smoke.check_daemon``'s gates.  Prints one JSON line
per run: the pace, whether the gates passed (and the first failure),
the server events with the frame of agent 0 at each MERGE, per agent the
frames pushed / taken / dropped and the share OK after its first OK,
p50 / p99 of ``track`` and p50 of draw + encode, the wall time, and the
card's nvidia-smi name and power limit.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

WARM_FRAMES = 20


def summary(d: dict, hz: float) -> dict:
    try:
        cs.check_daemon(d)
        gates = "passed"
    except AssertionError as e:
        gates = f"failed: {e}"
    agents = {}
    for k, b in d["buffers"].items():
        states = d["stats"][k]["states"]
        first = states.index(2) if 2 in states else len(states)
        agents[k] = dict(pushed=b["pushed"], taken=b["taken"],
                         dropped=b["dropped"], map=d["maps"][k],
                         ok_after_first=float(np.mean(
                             [s == 2 for s in states[first:]]))
                         if states[first:] else 0.0)
    stats = list(d["stats"].values())
    track = [x for st in stats for x in st["track_ms"]]
    return dict(
        hz=hz, gates=gates, events=d["events"],
        merge_frames=[round(float(e.rsplit("ts=", 1)[1]) / cs.DT)
                      for e in d["events"] if e.startswith("MERGE")],
        agents=agents, keyframes=d["keyframes"], map_points=d["map_points"],
        track_ms_p50=float(np.percentile(track, 50)),
        track_ms_p99=float(np.percentile(track, 99)),
        draw_plus_encode_ms_p50=float(np.median(
            [a + b for st in stats
             for a, b in zip(st["draw_ms"], st["encode_ms"])])),
        wall_s=d["wall"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hz", type=float, nargs="+", default=[4, 4, 4, 2, 2],
                    help="each client's pace, one run per value")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("daemon_pacing: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch import _build
    from mam3slam_tpu_torch.io import render

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    _build.library()
    cam = render.reference_kb8_cam(cs.FIXTURE_SCALE)
    arcs = [render.orbit_trajectory(cs.DAEMON_FRAMES, a0, a1, radius=2.5,
                                    bob=b) for a0, a1, b in cs.DAEMON_ARCS]
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "warm"))
        cs.run_daemon(dev, cam, [a[:WARM_FRAMES] for a in arcs],
                      os.path.join(tmp, "warm"), hz=100.0)
        for i, hz in enumerate(args.hz):
            out = os.path.join(tmp, f"run{i}")
            os.makedirs(out)
            d = cs.run_daemon(dev, cam, arcs, out, hz=hz)
            print(json.dumps(dict(run=i, card=smi, **summary(d, hz))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
