#!/usr/bin/env python
"""Live multi-agent SLAM daemon on the PyTorch + CUDA port: frames arrive
across a process boundary (TCP or a watched directory), tracking runs on
the freshest frame per agent (the reference ImageGrabber slot semantics,
Examples/ROS/MAM3SLAM/nodes/ros_mono_multi.cc:93-122), and an MJPEG live
view serves every agent's annotated tracking window (the reference
AgentViewer, src/AgentViewer.cc:21-45) and the map to any browser.

TCP ingest and the live view for two agents:
    python examples/torch_run_daemon.py --settings cam0.yaml --settings cam1.yaml \\
        --port 7700 --live-port 8080 --out output/
    # feed frames from any process:
    #   from mam3slam_tpu_torch.io.daemon import send_frame
    #   sock = socket.create_connection(("127.0.0.1", 7700))
    #   send_frame(sock, agent=0, ts=..., image=gray_uint8)
    # watch live:  http://127.0.0.1:8080/

Directory ingest (a robot writing agent<k>_<ts>.png to shared storage):
    python examples/torch_run_daemon.py --settings cam0.yaml --watch /tmp/frames

Self-contained demo (a synthetic camera thread feeding the daemon):
    python examples/torch_run_daemon.py --demo [--cpu]

The port's twin of examples/run_daemon.py; the device is the card unless
--cpu is given.
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEMO_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 160.0
Camera1.fy: 160.0
Camera1.cx: 160.0
Camera1.cy: 120.0
Camera1.k1: 0.0
Camera1.k2: 0.0
Camera1.p1: 0.0
Camera1.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 20
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def track_loop(mas, buffers, live=None, idle_exit_s=None):
    """Track the freshest frame of each agent, round-robin, until every
    buffer is closed and empty or no frame came for ``idle_exit_s``;
    with a live view, draw and publish each tracked frame.  A frame
    crosses to the system's device once, as u8, for tracking and drawing
    alike.  Returns per agent the frames tracked and, per frame, the
    tracking state, the ms of ``track`` and (with a live view) of the
    drawing and the JPEG encode, and the JPEG's bytes."""
    import torch

    from mam3slam_tpu_torch.io import viewer

    stats = {aid: dict(tracked=0, states=[], track_ms=[], draw_ms=[],
                       encode_ms=[], jpeg_bytes=[]) for aid in buffers}
    last_frame_t = time.perf_counter()
    while True:
        any_frame = False
        for aid, buf in buffers.items():
            item = buf.take(timeout_s=0.05)
            if item is None:
                continue
            any_frame = True
            ts, img = item
            st = stats[aid]
            t0 = time.perf_counter()
            img = torch.from_numpy(img).to(mas.device)
            state, _ = mas.track_monocular(aid, img, ts)
            t1 = time.perf_counter()
            st["tracked"] += 1
            st["states"].append(state)
            st["track_ms"].append((t1 - t0) * 1e3)
            if live is not None:
                # drawn and encoded on the system's device
                bgr = viewer.draw_tracking_tensor(mas.sys, aid, img)
                t2 = time.perf_counter()
                jpg = live.publish(aid, bgr)
                st["draw_ms"].append((t2 - t1) * 1e3)
                st["encode_ms"].append((time.perf_counter() - t2) * 1e3)
                st["jpeg_bytes"].append(len(jpg))
            last_frame_t = time.perf_counter()
        if not any_frame:
            if all(b.closed for b in buffers.values()):
                break
            if (idle_exit_s is not None
                    and time.perf_counter() - last_frame_t > idle_exit_s):
                break
    return stats


def map_view_loop(mas, live, stop: threading.Event, stats=None):
    """The live map (the reference MapDrawer window) re-drawn about once a
    second until ``stop``: ``draw_map_image`` on ``/map`` and
    ``map_snapshot`` (4000 points at most) on ``/mapdata`` for the
    interactive ``/map3d`` page.  Runs in its own thread (on the system's
    card); ``stats`` collects the ms of each render and the error that
    ended the loop, which the caller re-raises."""
    import torch

    from mam3slam_tpu_torch.io import viewer

    stats = stats if stats is not None else {}
    stats.setdefault("render_ms", [])
    if mas.device.type == "cuda":
        torch.cuda.set_device(mas.device)
    try:
        while not stop.is_set():
            t0 = time.perf_counter()
            snap = viewer.map_snapshot(mas.sys, server=mas.server,
                                       max_points=4000)
            live.publish("map", viewer.draw_map_image(
                mas.sys, server=mas.server, snapshot=snap))
            live.publish_json("map", snap)
            stats["render_ms"].append((time.perf_counter() - t0) * 1e3)
            stop.wait(1.0)
    except Exception as e:   # handed to the main thread, which raises it
        stats["error"] = e
    return stats


def demo_camera(port: int, device):
    """A synthetic camera: renders a slow orbit of a room (300 frames) on
    ``device`` and sends it at ~7 frames/s to the ingest server at
    ``port`` as agent 0 (the first frames are dropped while the daemon
    warms up, then tracking keeps up)."""
    import socket

    from mam3slam_tpu_torch.io import render
    from mam3slam_tpu_torch.io.daemon import send_frame

    scene = render.RoomScene(seed=1, device=device)
    cam = render.RenderCam(width=320, height=240, fx=160.0, fy=160.0,
                           cx=160.0, cy=120.0)
    traj = render.orbit_trajectory(300, 0.0, 240.0, radius=2.5, bob=0.05)
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        for i, (R, t, _) in enumerate(traj):
            img = scene.render(R, t, cam).cpu().numpy().astype("uint8")
            send_frame(sock, 0, i / 20.0, img)
            time.sleep(0.15)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", action="append", default=[],
                    help="per-agent settings YAML (repeat for multi-agent)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP ingest port (0 = auto)")
    ap.add_argument("--watch", default=None,
                    help="ingest agent<k>_<ts>.png files from this dir")
    ap.add_argument("--live-port", type=int, default=None,
                    help="serve the MJPEG live view on this port")
    ap.add_argument("--out", default="output_daemon")
    ap.add_argument("--idle-exit-s", type=float, default=None,
                    help="exit after this long without any frame")
    ap.add_argument("--demo", action="store_true",
                    help="self-contained demo: a synthetic camera thread "
                         "feeding the daemon over TCP")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    import tempfile

    from mam3slam_tpu_torch import api
    from mam3slam_tpu_torch.io.daemon import (FrameIngestServer, MjpegServer,
                                              watch_directory)
    from mam3slam_tpu_torch.io.stream import LatestFrameBuffer

    device = "cpu" if args.cpu else "cuda"
    if args.demo and not args.settings:
        yaml_path = os.path.join(tempfile.mkdtemp(prefix="mam3_daemon_demo"),
                                 "cam.yaml")
        with open(yaml_path, "w") as f:
            f.write(DEMO_YAML)
        args.settings = [yaml_path]
        args.idle_exit_s = args.idle_exit_s or 5.0
        if args.live_port is None:
            args.live_port = 0  # auto port: the demo serves / and /map

    mas = api.MultiAgentSystem(device=device)
    buffers = {}
    for yaml_path in args.settings:
        buffers[mas.add_agent(yaml_path)] = LatestFrameBuffer()

    ingest = None
    if args.watch:
        os.makedirs(args.watch, exist_ok=True)
        watch_directory(args.watch, buffers)
        print(f"watching {args.watch} for agent<k>_<ts>.png", flush=True)
    else:
        ingest = FrameIngestServer(buffers, port=args.port)
        print(f"TCP ingest on 127.0.0.1:{ingest.port}", flush=True)

    live = map_thread = None
    map_stop = threading.Event()
    map_stats = {}
    if args.live_port is not None:
        live = MjpegServer(port=args.live_port, device=mas.device)
        print(f"live view on http://127.0.0.1:{live.port}/ (per-agent "
              f"tracking; map on /map, interactive rotate/zoom on /map3d)",
              flush=True)
        map_thread = threading.Thread(
            target=map_view_loop, args=(mas, live, map_stop),
            kwargs=dict(stats=map_stats), daemon=True)
        map_thread.start()
    if args.demo:
        threading.Thread(target=demo_camera, args=(ingest.port, device),
                         daemon=True).start()

    try:
        stats = track_loop(mas, buffers, live, args.idle_exit_s)
    except KeyboardInterrupt:
        stats = None
    map_stop.set()
    if map_thread is not None:
        map_thread.join(timeout=30.0)
    if ingest is not None:
        ingest.close()
    if live is not None:
        live.close()
    if "error" in map_stats:
        raise map_stats["error"]
    mas.shutdown(out_dir=args.out)
    for aid, buf in buffers.items():
        n = stats[aid]["tracked"] if stats else "?"
        print(f"agent {aid}: tracked {n} (pushed {buf.n_pushed}, dropped "
              f"{buf.n_dropped}) state={mas.sys.agents[aid].state}")
    print(f"artifacts -> {args.out}")


if __name__ == "__main__":
    main()
