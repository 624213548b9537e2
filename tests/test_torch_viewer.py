"""Port parity of the viewer (mam3slam_tpu_torch.io.viewer): the map
snapshot of one reference run's state in both packages within 1e-4, the
annotated tracking frame pixel for pixel against the reference's cv2
drawing above the banner, the map render, and the numpy raster's
segments and text."""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from mam3slam_tpu.io import viewer as jviewer
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.io import viewer as tviewer
from mam3slam_tpu_torch.slam import system as tsys
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def twin_systems():
    """A reference SlamSystem run on the synthetic world
    (tests/test_slam_e2e.py) with a second agent holding a copy of the
    first one's trajectory, and a port SlamSystem holding the same map
    state (convert.map_state_from_numpy), agents, last frames and
    trajectories."""
    from test_slam_e2e import run_slam

    jsys, aid, _, _ = run_slam(n_frames=30, seed=7)
    jsys.add_agent()
    jsys.agents[1].trajectory = list(jsys.agents[aid].trajectory[5:])
    jsys.agents[1].state = 3
    cfg = tsys.SlamConfig(**{f: getattr(jsys.cfg, f)
                             for f in tsys.SlamConfig.__dataclass_fields__})
    psys = tsys.SlamSystem(cfg, tcam.make_pinhole(
        *np.asarray(jsys.cam.params)[:4], device="cpu"))
    psys.ms = convert.map_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsys.ms), device="cpu")
    for ja in jsys.agents:
        k = psys.add_agent()
        pa = psys.agents[k]
        pa.map_id, pa.state = ja.map_id, ja.state
        pa.trajectory = [(ts, ref, np.asarray(q), np.asarray(t), st)
                         for ts, ref, q, t, st in ja.trajectory]
        if ja.last_frame is not None:
            pa.last_frame = convert.frame_from_numpy(ja.last_frame, "cpu")
        if ja.last_feat_mp is not None:
            pa.last_feat_mp = convert.tensor(ja.last_feat_mp, "cpu")
    psys.culled_kf = dict(jsys.culled_kf)
    return jsys, psys


def test_map_snapshot_matches_reference(twin_systems):
    jsys, psys = twin_systems
    ref = jviewer.map_snapshot(jsys)
    got = tviewer.map_snapshot(psys)
    json.dumps(got)
    assert got["stats"] == ref["stats"]
    assert got["stats"]["kfs"] >= 2 and got["stats"]["agents"] == 2
    assert got["pmap"] == ref["pmap"] and got["scls"] == ref["scls"]
    assert {2, 3} <= set(got["scls"])          # both agents' trajectories
    for k in ("points", "segs"):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.size, k
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    assert abs(got["span"] - ref["span"]) <= 1e-4
    # the subsample to max_points takes the same rows
    small_r = jviewer.map_snapshot(jsys, max_points=37)
    small_p = tviewer.map_snapshot(psys, max_points=37)
    assert len(small_p["points"]) == 37 and small_p["pmap"] == small_r["pmap"]
    np.testing.assert_allclose(small_p["points"], small_r["points"],
                               atol=1e-4, rtol=0)


def test_draw_tracking_frame_matches_cv2(twin_systems):
    jsys, psys = twin_systems
    h, w = psys.cfg.height, psys.cfg.width
    img = np.random.default_rng(3).uniform(0, 255, (h, w)).astype(np.float32)
    for aid in (0, 1):
        ref = jviewer.draw_tracking_frame(jsys, aid, img)
        got = tviewer.draw_tracking_frame(psys, aid, img)
        assert got.shape == ref.shape == (h + 22, w, 3)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got[:h], ref[:h])
        bar = got[h:]
        assert bar.any() and set(np.unique(bar)) == {0, 255}
    # the banner's text is the reference's, with its own counts
    a = jsys.agents[0]
    uv = np.asarray(a.last_frame.uv)
    valid = np.asarray(a.last_frame.valid)
    fmp = np.asarray(a.last_feat_mp)
    xy = np.rint(uv).astype(int)
    inside = valid & (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (
        xy[:, 1] < h)
    n_tracked = int((inside & (fmp >= 0)).sum())
    assert n_tracked > 20
    n_kf = int(np.asarray(jsys.ms.kf_valid).sum())
    n_mp = int(np.asarray(jsys.ms.mp_valid).sum())
    assert tviewer.banner_text(psys, 0, n_kf, n_mp, n_tracked) == (
        f"SLAM | agent 0 map {a.map_id} | KFs: {n_kf}  MPs: {n_mp}  "
        f"matches: {n_tracked}")


def test_draw_tracking_frame_edges_and_overlaps():
    """Keypoints on and off the border and on top of each other draw as
    cv2 draws them one after another."""

    class Agent:
        state, map_id = 2, 0

    class System:
        pass

    h, w = 40, 50
    uv = np.array([[0.4, 0.4], [49.6, 39.4], [25.0, 20.0], [26.5, 20.5],
                   [27.0, 22.0], [-1.0, 5.0], [10.0, 40.2], [3.0, 37.0]],
                  np.float32)
    fmp = np.array([5, -1, 7, -1, 9, 3, 2, -1], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    a = Agent()
    a.last_frame = type("F", (), dict(uv=torch.tensor(uv),
                                      valid=torch.tensor(valid)))()
    a.last_feat_mp = torch.tensor(fmp)
    sys_ = System()
    sys_.agents = [a]
    sys_.ms = type("M", (), dict(kf_valid=torch.ones(3, dtype=torch.bool),
                                 mp_valid=torch.ones(9, dtype=torch.bool)))()
    img = np.full((h, w), 90, np.uint8)
    got = tviewer.draw_tracking_frame(sys_, 0, img)
    ref = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    for i in np.flatnonzero(valid):
        x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        if fmp[i] >= 0:
            cv2.rectangle(ref, (x - 3, y - 3), (x + 3, y + 3), (0, 200, 0), 1)
            cv2.circle(ref, (x, y), 1, (0, 200, 0), -1)
        else:
            cv2.circle(ref, (x, y), 1, (200, 120, 0), -1)
    np.testing.assert_array_equal(got[:h], ref)
    assert "matches: 3" in tviewer.banner_text(sys_, 0, 3, 9, 3)


def test_render_map_png(tmp_path, twin_systems):
    """The port's twin of tests/test_io_api.py's test_viewer_renders."""
    _, psys = twin_systems
    path = str(tmp_path / "map.png")
    tviewer.render_map(psys, path)
    assert os.path.getsize(path) > 10000
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img is not None and img.shape == (960, 1200, 3)
    live = tviewer.draw_map_image(psys)
    assert live.shape == (448, 560, 3) and live.dtype == np.uint8
    # every agent's trajectory colour appears in the view
    for k in (0, 1):
        colour = tviewer._TAB10[k]
        assert (live == colour).all(axis=2).any(), k


def test_raster_segments_and_text():
    """Known segments give known pixels; text lands in its box."""
    img = np.zeros((20, 30, 3), np.uint8)
    a = np.array([[2.0, 3.0], [5.0, 1.0], [0.0, 0.0], [25.0, 18.0]])
    b = np.array([[12.0, 3.0], [5.0, 9.0], [6.0, 6.0], [40.0, 18.0]])
    cols = np.array([(1, 1, 1), (2, 2, 2), (3, 3, 3), (4, 4, 4)], np.uint8)
    tviewer._segments(img, a, b, cols)
    want = np.zeros((20, 30), np.uint8)
    want[3, 2:13] = 1
    want[1:10, 5] = 2
    for i in range(7):
        want[i, i] = 3
    want[18, 25:30] = 4                 # clipped at the right edge
    np.testing.assert_array_equal(img[..., 0], want)
    assert (img[..., 0] == img[..., 2]).all()

    canvas = np.zeros((12, 40, 3), np.uint8)
    tviewer.put_text(canvas, "KF:1|", 2, 9, (255, 255, 255))
    ys, xs = np.nonzero(canvas[..., 0])
    assert ys.min() >= 3 and ys.max() <= 9
    assert xs.min() >= 2 and xs.max() < 2 + 5 * tviewer.GLYPH_W
    np.testing.assert_array_equal(
        tviewer.text_mask("|")[:, :5],
        np.tile([0, 0, 1, 0, 0], (7, 1)).astype(bool))
    assert tviewer.text_mask("é").any()       # unknown -> '?'
