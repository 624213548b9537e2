"""The port's example twins on the CPU: the synthetic demo
(examples/torch_run_synthetic_demo.py) in process, held to the verify
recipe's drive checks and to the reference demo's run, the EuRoC twin on
a rendered sequence, and the daemon twin's tracking loop and map view."""

import importlib.util
import os
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest

from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference demo's run (python examples/run_synthetic_demo.py --cpu):
# its server events and final keyframe and map point counts
REF_DEMO_EVENTS = ["MERGE agent=1 map 1 -> 0 kf=7 target=3 ts=94.000000"]
REF_DEMO_KF, REF_DEMO_MP = 9, 346
# the two packages draw their RANSAC samples from different generators, so
# the map's point count may differ by a few triangulations
MP_TOL = 0.01


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    with open(path) as f:
        return np.array([[float(v) for v in line.split()]
                         for line in list(f)[1:]])


def check_demo_outputs(out):
    """The verify recipe's drive checks of the demo's artifacts."""
    with open(os.path.join(out, "MapLogs.txt")) as f:
        assert "Merge of map 1 into 0" in f.read()
    for i in (0, 1):
        rows = _rows(os.path.join(out, f"Trajectory_{i}.txt"))
        assert len(rows) > 30
        np.testing.assert_allclose(np.linalg.norm(rows[:, 4:8], axis=1), 1.0,
                                   atol=1e-5)
    steps = np.linalg.norm(np.diff(_rows(os.path.join(
        out, "Trajectory_1.txt"))[:, 1:4], axis=0), axis=1)
    assert steps.max() <= 3 * np.median(steps)
    img = cv2.imread(os.path.join(out, "map.png"))
    assert img is not None and img.shape == (960, 1200, 3)


def test_synthetic_demo_twin(tmp_path):
    out = str(tmp_path / "demo")
    sys_ = example("torch_run_synthetic_demo").run(out, 50, "cpu")
    assert [a.state for a in sys_.agents] == [2, 2]
    assert sys_.agents[0].map_id == sys_.agents[1].map_id
    assert sys_.server.events == REF_DEMO_EVENTS
    assert int(sys_.ms.kf_valid.sum()) == REF_DEMO_KF
    assert abs(int(sys_.ms.mp_valid.sum()) - REF_DEMO_MP) <= MP_TOL * REF_DEMO_MP
    check_demo_outputs(out)


@pytest.mark.slow
def test_synthetic_demo_twin_matches_reference_demo(tmp_path):
    """Both demos as their users run them: the same events and map logs,
    the same keyframes, and the recorded counts still the reference's."""
    ref_out, out = str(tmp_path / "ref"), str(tmp_path / "port")
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "run_synthetic_demo.py"),
         "--cpu", "--out", ref_out], capture_output=True, text=True,
        timeout=900)
    assert run.returncode == 0, run.stderr
    assert f"server events: {REF_DEMO_EVENTS}" in run.stdout
    assert f"done: {REF_DEMO_KF} keyframes, {REF_DEMO_MP} map points" in \
        run.stdout
    example("torch_run_synthetic_demo").run(out, 50, "cpu")
    for name in ("MapLogs.txt", "TrackingStatus_0.txt",
                 "TrackingStatus_1.txt"):
        with open(os.path.join(ref_out, name)) as a, \
                open(os.path.join(out, name)) as b:
            assert a.read() == b.read(), name
    check_demo_outputs(out)


def test_euroc_twin_on_rendered_sequence(tmp_path):
    """torch_make_rendered_dataset's merge arcs (short) through the
    EuRoC twin's own functions, two agents interleaved: every frame
    decoded, drawn every 5th frame, the artifact set, map.png and ATE.txt
    written."""
    from mam3slam_tpu_torch.io import render

    data = example("torch_make_rendered_dataset")
    twin = example("torch_run_euroc")
    cam = render.RenderCam(width=160, height=120, fx=80.0, fy=80.0, cx=80.0,
                           cy=60.0)
    scene = render.RoomScene(seed=3, device="cpu")
    seqs = []
    for name, traj in data.jobs(24)[1:]:
        seqs.append(str(tmp_path / name))
        render.write_asl_sequence(seqs[-1], scene, traj[:12], cam)
    out = str(tmp_path / "out")
    mas, agents = twin.build_system(seqs, out, "cpu", n_features=300,
                                    n_levels=4)
    rows = twin.run_sequences(mas, agents, seqs, out, frames_png=5)
    assert [len(rows[a]) for a in agents] == [12, 12]
    twin.finish(mas, agents, seqs, out)
    for a in agents:
        assert sorted(os.listdir(os.path.join(out, f"frames_{a}"))) == [
            "000000.png", "000005.png", "000010.png"]
        img = cv2.imread(os.path.join(out, f"frames_{a}", "000005.png"))
        assert img.shape == (120 + 22, 160, 3)
    for name in ("Trajectory_0.txt", "Trajectory_1.txt", "KF_traj.txt",
                 "MapLogs.txt", "map.png", "cam_0.yaml", "cam_1.yaml"):
        assert os.path.exists(os.path.join(out, name)), name


def test_daemon_twin_track_loop(tmp_path):
    """torch_run_daemon's tracking loop and map view on the CPU: frames
    from a camera thread over TCP, each taken frame tracked, drawn and
    published, the map view publishing /map and /mapdata, and the loop
    ending by itself once the camera is done."""
    import socket
    import threading

    from mam3slam_tpu_torch import api
    from mam3slam_tpu_torch.io import render
    from mam3slam_tpu_torch.io.daemon import (FrameIngestServer, MjpegServer,
                                              send_frame)
    from mam3slam_tpu_torch.io.stream import LatestFrameBuffer

    twin = example("torch_run_daemon")
    yaml_path = tmp_path / "cam.yaml"
    yaml_path.write_text(twin.DEMO_YAML)
    mas = api.MultiAgentSystem(device="cpu")
    buffers = {mas.add_agent(str(yaml_path)): LatestFrameBuffer()}
    cam = render.RenderCam(width=320, height=240, fx=160.0, fy=160.0,
                           cx=160.0, cy=120.0)
    scene = render.RoomScene(seed=1, device="cpu")
    frames = [scene.render(R, t, cam).numpy().astype(np.uint8)
              for R, t, _ in render.orbit_trajectory(12, 0.0, 10.0,
                                                     radius=2.5, bob=0.05)]
    ingest = FrameIngestServer(buffers)
    live = MjpegServer(device="cpu")
    stop, map_stats = threading.Event(), {}
    map_thread = threading.Thread(target=twin.map_view_loop,
                                  args=(mas, live, stop),
                                  kwargs=dict(stats=map_stats))

    def camera():
        with socket.create_connection(("127.0.0.1", ingest.port),
                                      timeout=5) as sock:
            for i, img in enumerate(frames):
                send_frame(sock, 0, i / 20.0, img)
                time.sleep(0.05)

    cam_thread = threading.Thread(target=camera)
    try:
        map_thread.start()
        cam_thread.start()
        stats = twin.track_loop(mas, buffers, live, idle_exit_s=2.0)[0]
        cam_thread.join(timeout=30)
        assert not cam_thread.is_alive()
        time.sleep(1.2)                      # one more map view
    finally:
        stop.set()
        map_thread.join(timeout=30)
        ingest.close()
        live.close()
    assert not map_thread.is_alive() and "error" not in map_stats
    buf = buffers[0]
    assert buf.n_pushed == 12 and stats["tracked"] == buf.n_taken
    assert buf.n_taken + buf.n_dropped == 12 and buf.n_taken >= 2
    for key in ("states", "track_ms", "draw_ms", "encode_ms", "jpeg_bytes"):
        assert len(stats[key]) == stats["tracked"], key
    assert min(stats["jpeg_bytes"]) > 1000
    assert map_stats["render_ms"] and "map" in live._json
    mas.shutdown(out_dir=str(tmp_path / "out"))
    assert os.path.exists(tmp_path / "out" / "Trajectory_0.txt")
