#!/usr/bin/env python
"""Run monocular SLAM on the PyTorch + CUDA port over EuRoC-layout
sequences (single- or multi-agent).

Single agent:
    python examples/torch_run_euroc.py --seq /data/euroc/MH_01_easy --out output/

Two agents as a centralized multi-agent run, frames fed interleaved so
both agents track concurrently, as the reference's per-agent threads do
(src/Agent.cc:92-113); maps merge when they overlap:
    python examples/torch_run_euroc.py --seq MH_01_easy --seq MH_02_easy --out output/

The port's twin of examples/run_euroc.py.  Sequences rendered by
examples/torch_make_rendered_dataset.py carry their own
mav0/cam0/sensor.yaml calibration; real EuRoC sequences fall back to the
published cam0 factory calibration.  Frames decode through the
repository's native PNG loader, built for the host on first use.  The
device is the card unless --cpu is given.

Writes the reference artifact set (Trajectory_i.txt, KF_traj.txt,
MapLogs.txt, Times*.txt, map.png) plus ATE.txt when ground truth is
available.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_yaml(c, n_features, n_levels=8):
    """A settings file of the calibration ``c`` (``euroc.EUROC_CAM0``'s
    shape) with the extractor's ORB values."""
    if c.get("model") == "kb8":
        cam_block = f"""Camera.type: "KannalaBrandt8"
Camera1.fx: {c['fx']}
Camera1.fy: {c['fy']}
Camera1.cx: {c['cx']}
Camera1.cy: {c['cy']}
Camera1.k1: {c['dist'][0]}
Camera1.k2: {c['dist'][1]}
Camera1.k3: {c['dist'][2]}
Camera1.k4: {c['dist'][3]}"""
    else:
        cam_block = f"""Camera.type: "PinHole"
Camera1.fx: {c['fx']}
Camera1.fy: {c['fy']}
Camera1.cx: {c['cx']}
Camera1.cy: {c['cy']}
Camera1.k1: {c['dist'][0]}
Camera1.k2: {c['dist'][1]}
Camera1.p1: {c['dist'][2]}
Camera1.p2: {c['dist'][3]}"""
    return f"""%YAML:1.0
File.version: "1.0"
{cam_block}
Camera.width: {c['width']}
Camera.height: {c['height']}
Camera.fps: {c['fps']}
Camera.RGB: 1
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def build_system(seqs, out: str, device, n_features: int = 1000,
                 n_levels: int = 8, overrides=None,
                 async_mapping: bool = False):
    """A ``MultiAgentSystem`` on ``device`` with one agent per sequence,
    each added from a settings file written to ``out``; returns (system,
    agent ids)."""
    from mam3slam_tpu_torch import api
    from mam3slam_tpu_torch.io import euroc

    os.makedirs(out, exist_ok=True)
    mas = api.MultiAgentSystem(async_mapping=async_mapping,
                               slam_overrides=overrides or {},
                               device=device)
    agents = []
    for i, seq in enumerate(seqs):
        c = euroc.load_sensor_yaml(seq) or euroc.EUROC_CAM0
        yaml_path = os.path.join(out, f"cam_{i}.yaml")
        with open(yaml_path, "w") as f:
            f.write(make_yaml(c, n_features, n_levels))
        agents.append(mas.add_agent(yaml_path))
    return mas, agents


def run_sequences(mas, agents, seqs, out: str, max_frames=None,
                  serial: bool = False, frames_png: int = 0):
    """Feed each sequence to its agent: one frame per agent per round
    (interleaved), or one sequence after another (``serial``).  Every
    ``frames_png``-th frame of an agent is drawn annotated (the reference
    FrameDrawer, src/FrameDrawer.cc) to OUT/frames_<agent>/.  Returns per
    agent the rows (ts, state, perf_counter at the call, call ms)."""
    from mam3slam_tpu_torch.io import euroc, viewer

    rows = {aid: [] for aid in agents}

    def track(aid, img, ts, i):
        t0 = time.perf_counter()
        state, _ = mas.track_monocular(aid, img, ts)
        rows[aid].append((ts, state, t0, (time.perf_counter() - t0) * 1e3))
        if frames_png and i % frames_png == 0:
            d = os.path.join(out, f"frames_{aid}")
            os.makedirs(d, exist_ok=True)
            viewer.render_tracking_frame(mas.sys, aid, img,
                                         os.path.join(d, f"{i:06d}.png"))
        return state

    if serial:
        for aid, seq in zip(agents, seqs):
            print(f"agent {aid}: {seq}")
            for i, (ts, img) in enumerate(
                    euroc.frames(seq, max_frames=max_frames)):
                state = track(aid, img, ts, i)
                if i % 100 == 0:
                    print(f"  frame {i}  state={state}", flush=True)
        return rows
    iters = [iter(euroc.frames(seq, max_frames=max_frames)) for seq in seqs]
    live = set(range(len(iters)))
    i = 0
    while live:
        for k in sorted(live):
            try:
                ts, img = next(iters[k])
            except StopIteration:
                live.discard(k)
                continue
            state = track(agents[k], img, ts, i)
            if i % 100 == 0:
                maps = [a.map_id for a in mas.sys.agents]
                print(f"round {i}  agent {agents[k]} state={state} "
                      f"maps={maps}", flush=True)
        i += 1
    return rows


def finish(mas, agents, seqs, out: str):
    """Shut down (writing the artifact set), render ``map.png`` and write
    ATE.txt against the ground truth where there is one; returns the ATE
    lines."""
    from mam3slam_tpu_torch.io import euroc, viewer, writers

    mas.shutdown(out_dir=out)
    viewer.render_map(mas.sys, os.path.join(out, "map.png"),
                      server=mas.server)
    ate_rows = []
    for aid, seq in zip(agents, seqs):
        try:
            gt = euroc.load_groundtruth(seq)
        except FileNotFoundError:
            continue
        est, ref = [], []
        for ts, q, t, st in mas.sys.trajectory_world(aid):
            if st != 2:
                continue
            j = np.searchsorted(gt[:, 0], ts)
            if 0 < j < len(gt):
                est.append(t)
                ref.append(gt[j, 1:4])
        if len(est) > 10:
            ate = writers.ate_rmse(np.asarray(est), np.asarray(ref))
            span = float(np.ptp(np.asarray(ref), axis=0).max())
            line = (f"agent {aid} ATE RMSE (Sim3-aligned): {ate:.4f} m "
                    f"over {len(est)} frames; span {span:.2f} m "
                    f"({100 * ate / span:.2f}%)")
            print(line)
            ate_rows.append(line)
    if ate_rows:
        with open(os.path.join(out, "ATE.txt"), "w") as f:
            f.write("\n".join(ate_rows) + "\n")
    return ate_rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", action="append", required=True,
                    help="EuRoC sequence dir (repeat for multi-agent)")
    ap.add_argument("--out", default="output")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--n-levels", type=int, default=8)
    ap.add_argument("--kf-max-interval", type=int, default=None,
                    help="max frames between keyframes (SlamConfig "
                    "default otherwise)")
    ap.add_argument("--serial", action="store_true",
                    help="feed agents one after another instead of "
                    "interleaved (not the reference behavior)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping/server on the worker thread")
    ap.add_argument("--frames-png", type=int, default=0, metavar="N",
                    help="write an annotated tracking frame every N "
                    "frames to OUT/frames_<agent>/")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    overrides = {}
    if args.kf_max_interval:
        overrides["kf_max_interval"] = args.kf_max_interval
    mas, agents = build_system(args.seq, args.out,
                               "cpu" if args.cpu else "cuda",
                               args.n_features, args.n_levels, overrides,
                               args.async_mapping)
    run_sequences(mas, agents, args.seq, args.out, args.max_frames,
                  args.serial, args.frames_png)
    finish(mas, agents, args.seq, args.out)


if __name__ == "__main__":
    main()
