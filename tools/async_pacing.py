#!/usr/bin/env python3
"""How fast a camera the port's asynchronous facade keeps up with, on one
GPU.

    python3 tools/async_pacing.py

Runs phase 7's facade at the reference fixture point (chip_smoke.py:
720x720 KB8, 240 frames of the 450-degree orbit pre-staged on the card)
once per variant: the synchronous system pipelined to depth 4 (bench.py's
configuration) as the reference point, then the asynchronous system (the
mapping worker, ``ServerConfig(async_gba=True)``) at pipeline depth 4 and
1, fed at the frames' 20 Hz stamps, at 10 Hz, and as fast as it takes
them.  Prints one JSON line per variant: the share of frames OK, the
system and server events, the mapping epochs run and their host ms, the
refused insertions after each call, the per-call ms percentiles, and the
card's nvidia-smi name and power limit.  Needs CUDA.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = (  # (name, async mapping, pipeline depth, feed Hz; 0: unpaced)
    ("sync_depth4_unpaced", False, 4, 0),
    ("async_depth4_20hz", True, 4, 20),
    ("async_depth1_20hz", True, 1, 20),
    ("async_depth4_10hz", True, 4, 10),
    ("async_depth4_unpaced", True, 4, 0))


def run(name, async_mapping, depth, hz, cam, frames, yaml_path, dev, smi):
    from mam3slam_tpu_torch import api
    from mam3slam_tpu_torch.slam.server import ServerConfig

    mas = api.MultiAgentSystem(
        slam_config=cs.facade_config(cam), pipeline=True,
        async_mapping=async_mapping, device=dev,
        server_config=ServerConfig(async_gba=async_mapping))
    mas.add_agent(yaml_path)
    mas.sys.pipeline_depth = depth
    states, call_ms, refused = [], [], []
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        if hz:
            time.sleep(max(0.0, t0 + i / hz - time.perf_counter()))
        f0 = time.perf_counter()
        st, _ = mas.track_monocular(0, img, i * cs.DT)
        call_ms.append((time.perf_counter() - f0) * 1e3)
        states.append(int(st))
        refused.append(mas.sys.agents[0].kf_insertions_refused)
    mas.shutdown()
    first = states.index(2) if 2 in states else len(states)
    epochs = mas.sys.timers.series.get("LM_0", [0.0])
    print(json.dumps(dict(
        variant=name, card=smi, async_mapping=async_mapping, depth=depth,
        feed_hz=hz, wall_s=time.perf_counter() - t0,
        ok_after_first_ok=float(np.mean(np.equal(states[first:], 2))),
        system_events=mas.sys.events, server_events=mas.server.events,
        epochs=len(mas.sys.epochs),
        epoch_ms_median=float(np.median(epochs)),
        epoch_ms_p90=float(np.percentile(epochs, 90)), refused=refused,
        call_ms_p50=float(np.percentile(call_ms, 50)),
        call_ms_p90=float(np.percentile(call_ms, 90)),
        call_ms_p99=float(np.percentile(call_ms, 99)),
        call_ms_max=float(np.max(call_ms)),
        states="".join(str(s) for s in states))), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("async_pacing: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch.io import render

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    cam = render.reference_kb8_cam(cs.FIXTURE_SCALE)
    traj = render.orbit_trajectory(cs.FACADE_FRAMES, *cs.FACADE_ARC[:2],
                                   radius=2.5, bob=cs.FACADE_ARC[2])
    scene = render.RoomScene(seed=5, device=dev)
    frames = [scene.render(R, t, cam) for R, t, _ in traj]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        yaml_path = os.path.join(tmp, "kb8_fixture.yaml")
        with open(yaml_path, "w") as f:
            f.write(cs.facade_yaml(cam))
        for variant in VARIANTS:
            run(*variant, cam, frames, yaml_path, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
