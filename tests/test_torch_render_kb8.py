"""Port parity of the KB8 half of the renderer (mam3slam_tpu_torch.io.render):
the fisheye ray grid and rendered frames at the fixture camera's 1/4
scale, the photometric degradations, the ASL sequence writer (PNGs
written with zlib, decoded by the native loader and by cv2) and the
float16 render cache, each against the reference's on the same scene and
poses.  Frames agree with the reference's to f32 rounding (3e-4 on
0..255 pixels)."""

import os

import cv2
import numpy as np
import pytest

from mam3slam_tpu.io import euroc as jeuroc
from mam3slam_tpu.io import render as J
from mam3slam_tpu_torch.io import euroc as teuroc
from mam3slam_tpu_torch.io import render as P


def _cams(scale=0.25):
    ref = J.reference_kb8_cam(scale)
    port = P.reference_kb8_cam(scale)
    return ref, port


def test_render_cam_defaults_match_reference():
    assert P.RenderCam() == P.RenderCam(**{
        f: getattr(J.RenderCam(), f) for f in J.RenderCam.__dataclass_fields__})
    for s in (1.0, 0.75, 1 / 3, 0.25):
        ref, port = _cams(s)
        assert tuple(getattr(port, f) for f in ref.__dataclass_fields__) \
            == tuple(getattr(ref, f) for f in ref.__dataclass_fields__)


def test_kb8_ray_grid_and_render_match_reference():
    ref_cam, cam = _cams()
    np.testing.assert_array_equal(P._kb8_unproject_grid(cam),
                                  J._kb8_unproject_grid(ref_cam))
    js, ps = J.RoomScene(seed=5), P.RoomScene(seed=5, device="cpu")
    assert ps.seed == 5
    for (R, t, C, q), (R2, t2, C2) in zip(
            J.orbit_trajectory(4, 0, 450, bob=0.05),
            P.orbit_trajectory(4, 0, 450, bob=0.05)):
        ref = js.render(R, t, ref_cam)
        got = ps.render(R2, t2, cam).numpy()
        assert got.shape == (240, 240)
        np.testing.assert_allclose(got, ref, atol=3e-4, rtol=0)
    # the rays are computed once per camera on the scene's device
    assert len(ps._kb8_rays) == 1
    assert ps.camera_rays(cam) is ps.camera_rays(cam)


def test_photometric_matches_reference():
    img = np.random.default_rng(4).uniform(0, 255, (60, 80)).astype(
        np.float32)
    for kw in ({}, dict(blur_sigma=0.0, noise_sigma=0.0), dict(vignette=0.0)):
        for i in (0, 17):
            np.testing.assert_array_equal(P.Photometric(**kw).apply(img, i),
                                          J.Photometric(**kw).apply(img, i))


def test_write_asl_sequence_matches_reference(tmp_path):
    """The same ASL layout and text files as the reference's; the PNGs
    decode, through the native loader and through cv2, to the port's
    rendered frames cast to u8, and to the reference's pixels except where
    f32 rounding crosses an integer (<= 1 grey level, <= 0.2% of pixels)."""
    ref_cam, cam = _cams()
    jtraj = J.orbit_trajectory(3, 10, 30, bob=0.05)
    ptraj = P.orbit_trajectory(3, 10, 30, bob=0.05)
    J.write_asl_sequence(str(tmp_path / "ref"), J.RoomScene(seed=2), jtraj,
                         ref_cam)
    scene = P.RoomScene(seed=2, device="cpu")
    P.write_asl_sequence(str(tmp_path / "port"), scene, ptraj, cam)
    for rel in ("mav0/cam0/data.csv", "mav0/cam0/sensor.yaml",
                "mav0/state_groundtruth_estimate0/data.csv"):
        assert (open(tmp_path / "ref" / rel).read()
                == open(tmp_path / "port" / rel).read()), rel
    assert teuroc.load_sensor_yaml(str(tmp_path / "port")) == \
        jeuroc.load_sensor_yaml(str(tmp_path / "ref"))
    native = list(teuroc.frames(str(tmp_path / "port"), backend="native"))
    via_cv2 = list(teuroc.frames(str(tmp_path / "port"), backend="cv2"))
    ref = list(jeuroc.frames(str(tmp_path / "ref"), backend="native"))
    assert len(native) == len(via_cv2) == len(ref) == 3
    for (ts, a), (ts2, b), (ts3, r), (R, t, _) in zip(native, via_cv2, ref,
                                                      ptraj):
        assert ts == ts2 == ts3
        own = scene.render(R, t, cam).numpy().astype(np.uint8)
        np.testing.assert_array_equal(a, own)
        np.testing.assert_array_equal(b, own)
        diff = np.abs(a - r)
        assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3


def test_euroc_index_and_groundtruth_match_reference(tmp_path):
    _, cam = _cams(0.125)
    P.write_asl_sequence(str(tmp_path), P.RoomScene(seed=1, device="cpu"),
                         P.orbit_trajectory(4, 0, 12), cam, t0=1.5)
    seq = str(tmp_path)
    assert teuroc.load_image_index(seq) == jeuroc.load_image_index(seq)
    np.testing.assert_array_equal(teuroc.load_groundtruth(seq),
                                  jeuroc.load_groundtruth(seq))
    assert list(teuroc.frames(seq, max_frames=2))[1][0] == pytest.approx(1.55)
    with pytest.raises(FileNotFoundError):
        teuroc.load_image_index(str(tmp_path / "nowhere"))


def test_render_sequence_cached_round_trip_and_keys(tmp_path):
    """The twins of tests/test_render_cache.py, plus the cache's own tag:
    port files never share a name with the reference's."""
    scene = P.RoomScene(seed=9, px_per_m=20.0, device="cpu")
    cam = P.RenderCam(width=64, height=48, fx=40.0, fy=40.0, cx=32.0,
                      cy=24.0)
    traj = P.orbit_trajectory(5, 0.0, 40.0, radius=2.5)
    d = str(tmp_path / "c")
    f1 = P.render_sequence_cached(scene, traj, cam, cache_dir=d)
    assert f1.shape == (5, 48, 64) and f1.dtype == np.float16
    direct = scene.render(traj[2][0], traj[2][1], cam).numpy()
    np.testing.assert_allclose(f1[2].astype(np.float32), direct, atol=0.25)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("torch_")
    scene.render = None  # a second render would fail: the cache answers
    np.testing.assert_array_equal(
        f1, P.render_sequence_cached(scene, traj, cam, cache_dir=d))

    # seed, trajectory and camera model are all part of the key
    k = str(tmp_path / "k")
    for seed, tr, c in ((1, traj, cam), (2, traj, cam),
                        (1, P.orbit_trajectory(5, 5.0, 45.0), cam),
                        (1, traj, P.RenderCam(width=64, height=48, fx=40.0,
                                              fy=40.0, cx=32.0, cy=24.0,
                                              model="kb8"))):
        P.render_sequence_cached(P.RoomScene(seed=seed, px_per_m=20.0,
                                             device="cpu"), tr, c,
                                 cache_dir=k)
    assert len(os.listdir(k)) == 4

    # the reference writes its file beside the port's, under another name
    J.render_sequence_cached(J.RoomScene(seed=9, px_per_m=20.0),
                             J.orbit_trajectory(5, 0.0, 40.0, radius=2.5),
                             J.RenderCam(width=64, height=48, fx=40.0,
                                         fy=40.0, cx=32.0, cy=24.0),
                             cache_dir=d)
    assert len(set(os.listdir(d))) == 2


def test_png_writer_is_standard(tmp_path):
    """write_png_gray's files decode byte-exactly with cv2."""
    img = np.random.default_rng(5).integers(0, 256, (37, 53), dtype=np.uint8)
    P.write_png_gray(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED), img)
