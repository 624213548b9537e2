"""Port parity of the MultiAgentSystem facade (mam3slam_tpu_torch.api) on
KannalaBrandt8 frames: the reference's renderer draws the fixture camera
at 1/3 scale (320x320), and both facades, built from one settings file
(4 levels, 400 features), track and map the same 30 frames with the loop
server off.  Both take the same RANSAC draws: the port's system is
handed the reference's ``jax.random`` draws (``reference_draws``), since
the two packages' generators differ.  The
facades must agree on every frame's tracking state, the keyframe count,
the live map points (within 1%), every camera centre (within 1e-3 of the
arc's span) and the text of the artifacts (timestamps, agents, reference
keyframes; poses within 1e-3 of the span).  Also: the INTER_AREA resize
against cv2 and the facade's device and mode options."""

import os

import cv2
import numpy as np
import pytest
import torch

from mam3slam_tpu import api as japi
from mam3slam_tpu.io import render as jrender
from mam3slam_tpu_torch import api as tapi
from mam3slam_tpu_torch.slam import system as tsys
from test_torch_capacity import reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

N_FRAMES = 30
# small arena and window-BA caps keep the CPU run short; the map stays
# well inside them (~400 points), so they change no result
OVERRIDES = dict(max_kf=16, max_mp=2048, min_init_matches=80,
                 kf_max_interval=8, lba_pt_cap=1024)


def _yaml(cam) -> str:
    k1, k2, k3, k4 = cam.k
    return f"""%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: {cam.fx}
Camera1.fy: {cam.fy}
Camera1.cx: {cam.cx}
Camera1.cy: {cam.cy}
Camera1.k1: {k1}
Camera1.k2: {k2}
Camera1.k3: {k3}
Camera1.k4: {k4}
Camera.width: {cam.width}
Camera.height: {cam.height}
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 400
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module")
def facade_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("facade")
    cam = jrender.reference_kb8_cam(1 / 3)
    scene = jrender.RoomScene(seed=5)
    traj = jrender.orbit_trajectory(N_FRAMES, 0.0, 1.875 * N_FRAMES,
                                    radius=2.5, bob=0.05)
    frames = [scene.render(R, t, cam).astype(np.float32)
              for R, t, _, _ in traj]
    path = str(d / "kb8.yaml")
    with open(path, "w") as f:
        f.write(_yaml(cam))
    runs = {}
    for name, mk in (
            ("port", lambda: tapi.MultiAgentSystem(
                active_loop_closing=False, slam_overrides=OVERRIDES,
                device="cpu")),
            ("ref", lambda: japi.MultiAgentSystem(
                active_loop_closing=False, slam_overrides=OVERRIDES))):
        mas = mk()
        aid = mas.add_agent(path)
        if name == "port":
            reference_draws(mas.sys, 0)
        states = [mas.track_monocular(aid, img, i / 20.0)[0]
                  for i, img in enumerate(frames)]
        out = str(d / name)
        mas.shutdown(out_dir=out)
        ms = mas.sys.ms
        runs[name] = dict(
            states=states, events=list(mas.sys.events), out=out,
            n_kf=int(np.asarray(ms.kf_valid).sum()),
            n_mp=int(np.asarray(ms.mp_valid).sum()),
            centres=np.asarray([r[2] for r in mas.sys.trajectory_world(aid)]),
            cfg=mas.sys.cfg, kind=mas.sys.agents[aid].cam.kind, mas=mas)
    gt = np.asarray([C for _, _, C, _ in traj])
    runs["span"] = float(np.ptp(gt, axis=0).max())
    return runs


def test_facade_tracks_kb8_like_the_reference(facade_runs):
    port, ref = facade_runs["port"], facade_runs["ref"]
    assert port["kind"] == ref["kind"] == 1
    assert port["cfg"].n_feat == ref["cfg"].n_feat == 512
    assert port["states"] == ref["states"]
    first_ok = ref["states"].index(tsys.OK)
    assert first_ok <= 2 and all(s == tsys.OK
                                 for s in ref["states"][first_ok:])
    assert [e.split()[0] for e in port["events"]] == ["INIT"]
    assert port["events"][0].split()[:3] == ref["events"][0].split()[:3]
    assert port["n_kf"] == ref["n_kf"] >= 5
    assert abs(port["n_mp"] - ref["n_mp"]) <= 0.01 * ref["n_mp"]
    assert port["centres"].shape == ref["centres"].shape
    err = np.linalg.norm(port["centres"] - ref["centres"], axis=1).max()
    assert err <= 1e-3 * facade_runs["span"], err / facade_runs["span"]


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f]


def test_facade_artifacts_match_reference(facade_runs):
    """The shutdown artifacts: the same files and rows; timestamps,
    agents, maps, states and reference-keyframe stamps identical, poses
    within 1e-3 of the span (positions) and 1e-3 (quaternions)."""
    port, ref = facade_runs["port"], facade_runs["ref"]
    names = sorted(os.listdir(ref["out"]))
    assert names == sorted(os.listdir(port["out"]))
    for must in ("Trajectory_0.txt", "KF_traj.txt", "MapLogs.txt",
                 "TrackingStatus_0.txt", "TimesT_0.txt", "reloc.txt"):
        assert must in names
    tol = {c: 1e-3 * facade_runs["span"] for c in (1, 2, 3)}
    tol.update({c: 1e-3 for c in (4, 5, 6, 7)})
    for name in names:
        if name.startswith("Times"):   # wall times: only their count
            assert len(_rows(os.path.join(ref["out"], name))) == len(
                _rows(os.path.join(port["out"], name)))
            continue
        rr = _rows(os.path.join(ref["out"], name))
        pr = _rows(os.path.join(port["out"], name))
        assert len(rr) == len(pr), name
        pose_file = name in ("Trajectory_0.txt", "KF_traj.txt")
        for a, b in zip(rr, pr):
            assert len(a) == len(b)
            for c, (x, y) in enumerate(zip(a, b)):
                if pose_file and c in tol and not x.isalpha():
                    assert abs(float(x) - float(y)) <= tol[c], (name, a, b)
                else:
                    assert x == y, (name, c, a, b)
    rows = _rows(os.path.join(port["out"], "Trajectory_0.txt"))[1:]
    q = np.asarray([[float(v) for v in r[4:8]] for r in rows])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)


def test_facade_queries_and_single_writers(facade_runs, tmp_path):
    """``agents``, ``get_agents_in_map`` and the facade's one-file writers
    give what ``shutdown`` wrote."""
    mas, out = facade_runs["port"]["mas"], facade_runs["port"]["out"]
    assert [a.agent_id for a in mas.agents] == [0]
    assert mas.get_agents_in_map(mas.agents[0].map_id) == [0]
    assert mas.get_agents_in_map(mas.agents[0].map_id + 1) == []
    mas.save_kf_trajectory(str(tmp_path / "kf.txt"))
    mas.save_trajectory(0, str(tmp_path / "traj.txt"))
    mas.save_times(str(tmp_path / "times"))
    for mine, theirs in (("kf.txt", "KF_traj.txt"),
                         ("traj.txt", "Trajectory_0.txt"),
                         ("times/TimesT_0.txt", "TimesT_0.txt")):
        assert _rows(tmp_path / mine) == _rows(os.path.join(out, theirs))


@pytest.mark.parametrize("scale", [0.75, 0.5])
def test_area_resize_matches_cv2(scale):
    """INTER_AREA downscale of the 960x960 fixture frame and of a
    752x480 frame (fractional and integer factors): max abs difference
    <= 1e-3 on 0..255 pixels."""
    rng = np.random.default_rng(int(scale * 100))
    for h, w in ((960, 960), (480, 752)):
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
        dh, dw = int(h * scale), int(w * scale)
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
        got = tapi.area_resize(torch.tensor(img), dh, dw).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-3


def test_facade_resizes_frames_as_the_settings_ask(tmp_path):
    """``Camera.newWidth`` / ``newHeight``: the facade area-resizes a
    full-size frame to the working geometry, as cv2 does, and consumes a
    tensor of that geometry on its device as it is."""
    cam = jrender.reference_kb8_cam(1 / 3)
    path = tmp_path / "kb8.yaml"
    path.write_text(_yaml(cam).replace(
        "Camera.fps: 20", "Camera.fps: 20\nCamera.newWidth: 240\n"
        "Camera.newHeight: 240"))
    mas = tapi.MultiAgentSystem(active_loop_closing=False, device="cpu",
                                slam_overrides=OVERRIDES)
    aid = mas.add_agent(str(path))
    assert (mas.sys.cfg.width, mas.sys.cfg.height) == (240, 240)
    img = np.random.default_rng(0).uniform(0, 255, (320, 320)).astype(
        np.float32)
    st = mas._settings[aid]
    got = mas._frame_tensor(st, img)
    ref = cv2.resize(img, (240, 240), interpolation=cv2.INTER_AREA)
    assert np.abs(got.numpy() - ref).max() <= 1e-3
    # a full-size tensor (here uint8) is cast and resized where it lies
    img8 = img.astype(np.uint8)
    ref8 = cv2.resize(img8.astype(np.float32), (240, 240),
                      interpolation=cv2.INTER_AREA)
    got8 = mas._frame_tensor(st, torch.tensor(img8))
    assert got8.dtype == torch.float32
    assert np.abs(got8.numpy() - ref8).max() <= 1e-3
    staged = torch.tensor(ref)
    assert mas._frame_tensor(st, staged) is staged
    np.testing.assert_allclose(mas.sys.agents[aid].cam.params[:4].numpy(),
                               np.float32([cam.fx * 0.75, cam.fy * 0.75,
                                           cam.cx * 0.75, cam.cy * 0.75]))


def test_facade_guards(tmp_path):
    """Asynchronous mapping and pipelining reach the system as the
    reference's facade passes them (depth 1; the worker joined at
    shutdown).  The facade defaults to the card and raises where there is
    none."""
    path = str(tmp_path / "kb8.yaml")
    with open(path, "w") as f:
        f.write(_yaml(jrender.reference_kb8_cam(1 / 3)))
    for kw in (dict(async_mapping=True), dict(pipeline=True)):
        mas = tapi.MultiAgentSystem(device="cpu", active_loop_closing=False,
                                    slam_overrides=OVERRIDES, **kw)
        mas.add_agent(path)
        ref = japi.MultiAgentSystem(active_loop_closing=False,
                                    slam_overrides=OVERRIDES, **kw)
        assert (mas.sys.async_mapping, mas.sys.pipeline,
                mas.sys.pipeline_depth) == (
            kw.get("async_mapping", False), kw.get("pipeline", False), 1)
        assert (ref._async_mapping, ref._pipeline) == (
            mas._async_mapping, mas._pipeline)
        mas.shutdown()
        if mas.sys.async_mapping:
            assert not mas.sys._worker.is_alive()
    if torch.cuda.is_available():
        assert tapi.MultiAgentSystem().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tapi.MultiAgentSystem()
