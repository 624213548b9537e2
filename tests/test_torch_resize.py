"""Port parity of the facade's INTER_AREA resize in every direction
(mam3slam_tpu_torch.api.area_resize against ``cv2.resize(...,
cv2.INTER_AREA)``, which the reference facade calls on the host): the
area tables when no axis grows, OpenCV's two-tap rule on both axes once
either axis grows, within 1e-3 on 0..255 pixels (and the two-tap rule
bit for bit: the facade's parity on upscaled frames depends on it).  Then both packages'
``MultiAgentSystem`` on KB8 frames rendered at 240x240 under a settings
file that upscales them to 320x320 (``Camera.newWidth`` /
``newHeight``), held to tests/test_torch_api.py's tolerances, and a
frame smaller than ``Camera.width`` / ``height`` with no ``newWidth``,
which both facades resize up to the settings' size."""

import cv2
import numpy as np
import pytest
import torch

from mam3slam_tpu import api as japi
from mam3slam_tpu.io import render as jrender
from mam3slam_tpu_torch import api as tapi
from mam3slam_tpu_torch.slam import system as tsys
from test_torch_api import OVERRIDES, _yaml
from test_torch_capacity import reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

# tests/test_torch_api.py's orbit, frame count and f32 frames.  Two
# variants are too ill-conditioned to hold both packages to 1e-3 of the
# span, with the resize bit-exact and the extracted features equal
# (tools/upscale_twin_spread.py): on the first 20 frames (another
# sampling of the orbit) the initial pair's fundamental matrix turns a
# last-bit difference between the packages' KB8 undistortion into
# another baseline (centres 1.4e-3 of the span apart), and on these
# frames rounded to u8 the port's own poses move with its torch thread
# count (7.8e-3 from the reference with one thread, 3.6e-4 with two or
# eight)
N_FRAMES = 30
# (source h, w) -> (destination h, w); the downscales are
# tests/test_torch_api.py's
SHAPES = {
    "x2": ((100, 120), (200, 240)),
    "x3": ((100, 120), (300, 360)),
    # 120 -> 170: scale = 1 / (170 / 120) puts 17 * scale on 12 exactly;
    # 120 / 170 puts it on 11.999..., another source pixel
    "fractional": ((100, 120), (150, 170)),
    "one_axis_up_one_equal": ((480, 640), (480, 752)),
    "up_rows_down_cols": ((100, 120), (150, 90)),
    "down_rows_up_cols": ((100, 120), (64, 200)),
    "tiny": ((7, 9), (10, 13)),
    "fixture_up": ((600, 600), (720, 720)),
    "mixed_euroc": ((400, 800), (480, 752)),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_area_resize_matches_cv2_in_every_direction(name):
    (h, w), (dh, dw) = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
    got = tapi.area_resize(torch.tensor(img), dh, dw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-3
    # OpenCV's order and rounding: near ties between the FAST scores of an
    # upscaled frame turn on the last bit
    np.testing.assert_array_equal(got.numpy(), ref)


def test_equal_axis_is_the_identity():
    """An axis of equal size in the two-tap rule copies its pixels."""
    img = np.random.default_rng(9).uniform(0, 255, (30, 40)).astype(
        np.float32)
    got = tapi.area_resize(torch.tensor(img), 45, 40).numpy()
    ref = cv2.resize(img, (40, 45), interpolation=cv2.INTER_AREA)
    assert np.abs(got - ref).max() <= 1e-3
    rows = tapi.area_resize(torch.tensor(img), 30, 50).numpy()
    assert np.abs(rows - cv2.resize(img, (50, 30),
                                    interpolation=cv2.INTER_AREA)).max() \
        <= 1e-3
    i0, i1, w0, w1 = (t.numpy() for t in tapi._linear_area_taps(
        40, 40, torch.device("cpu")))
    np.testing.assert_array_equal(i0, np.arange(40))
    assert (w0 == 1).all() and (w1 == 0).all()


def _frames():
    """``N_FRAMES`` f32 KB8 frames at 240x240 (the fixture camera at 1/4)
    on tests/test_torch_api.py's orbit, and the orbit's span."""
    cam = jrender.reference_kb8_cam(0.25)
    scene = jrender.RoomScene(seed=5)
    traj = jrender.orbit_trajectory(N_FRAMES, 0.0, 1.875 * N_FRAMES,
                                    radius=2.5, bob=0.05)
    frames = [scene.render(R, t, cam).astype(np.float32)
              for R, t, _, _ in traj]
    gt = np.asarray([C for _, _, C, _ in traj])
    return cam, frames, float(np.ptp(gt, axis=0).max())


@pytest.fixture(scope="module")
def upscale_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("upscale")
    cam, frames, span = _frames()
    path = str(d / "kb8_up.yaml")
    with open(path, "w") as f:
        f.write(_yaml(cam).replace(
            "Camera.fps: 20", "Camera.fps: 20\nCamera.newWidth: 320\n"
            "Camera.newHeight: 320"))
    runs = {"span": span}
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
        mas.shutdown()
        ms = mas.sys.ms
        runs[name] = dict(
            states=states, events=list(mas.sys.events),
            n_kf=int(np.asarray(ms.kf_valid).sum()),
            n_mp=int(np.asarray(ms.mp_valid).sum()),
            centres=np.asarray([r[2] for r in mas.sys.trajectory_world(aid)]),
            geometry=(mas.sys.cfg.width, mas.sys.cfg.height),
            params=np.asarray(mas.sys.agents[aid].cam.params[:4]))
    return runs


def test_facade_upscales_like_the_reference(upscale_runs):
    """Both facades upscale every 240x240 frame to the settings' 320x320
    (intrinsics x 4/3) and track them alike: every frame's state, the
    keyframe count, the live points within 1% and every camera centre
    within 1e-3 of the arc's span (tests/test_torch_api.py's
    tolerances)."""
    port, ref = upscale_runs["port"], upscale_runs["ref"]
    assert port["geometry"] == ref["geometry"] == (320, 320)
    np.testing.assert_allclose(port["params"], ref["params"], rtol=1e-6)
    cam = jrender.reference_kb8_cam(0.25)
    np.testing.assert_allclose(
        port["params"], np.float32([cam.fx, cam.fy, cam.cx, cam.cy]) * 4 / 3,
        rtol=1e-6)
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
    assert err <= 1e-3 * upscale_runs["span"], err / upscale_runs["span"]


def test_smaller_frame_than_the_settings_is_resized_up(tmp_path):
    """A 240x240 u8 frame, as a camera delivers it, under settings that
    name a 320x320 camera and no ``newWidth``: both packages work at
    320x320 with the settings' intrinsics as they are, and the port's
    staged frame is the reference's cv2 resize of it; both facades then
    track such frames alike."""
    _, frames, _ = _frames()
    frames = [np.rint(f).astype(np.uint8) for f in frames[:3]]
    big = jrender.reference_kb8_cam(1 / 3)
    path = tmp_path / "kb8_320.yaml"
    path.write_text(_yaml(big))
    port = tapi.MultiAgentSystem(active_loop_closing=False, device="cpu",
                                 slam_overrides=OVERRIDES)
    ref = japi.MultiAgentSystem(active_loop_closing=False,
                                slam_overrides=OVERRIDES)
    for mas in (port, ref):
        mas.add_agent(str(path))
        assert (mas.sys.cfg.width, mas.sys.cfg.height) == (320, 320)
    np.testing.assert_allclose(
        port.sys.agents[0].cam.params[:4].numpy(),
        np.float32([big.fx, big.fy, big.cx, big.cy]), rtol=1e-6)
    img = frames[0]
    got = port._frame_tensor(port._settings[0], img)
    want = cv2.resize(img.astype(np.float32), (320, 320),
                      interpolation=cv2.INTER_AREA)
    assert got.dtype == torch.float32 and got.shape == (320, 320)
    assert np.abs(got.numpy() - want).max() <= 1e-3
    # a u8 tensor of the frame's shape is cast and resized where it lies
    got8 = port._frame_tensor(port._settings[0], torch.tensor(img))
    assert np.abs(got8.numpy() - want).max() <= 1e-3
    reference_draws(port.sys, 0)
    states = [[mas.track_monocular(0, f, i / 20.0)[0]
               for i, f in enumerate(frames)] for mas in (port, ref)]
    assert states[0] == states[1]
    assert states[0][-1] == tsys.OK
