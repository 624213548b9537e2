"""Port parity: ORB extraction (mam3slam_tpu_torch.ops.orb) and the plain
describe of ops/cuda_orb_desc.py against the JAX reference on rendered
frames (CPU XLA path; the Pallas describe kernel in interpret mode)."""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mam3slam_tpu.ops.orb as JO
from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.io import render
from mam3slam_tpu.ops import pallas_orb_desc as POD
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.ops import cuda_orb_desc as CO
from mam3slam_tpu_torch.ops import orb as TO

W, H = 376, 240                       # EuRoC cam0 at half resolution
FX, FY, CX, CY = 229.327, 228.648, 183.6075, 124.1875
DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
_SCENE = render.RoomScene(seed=5)


def _frame(i, w=W, h=H):
    s = w / W
    cam = render.RenderCam(w, h, FX * s, FY * s, CX * s, CY * s)
    R, t, _, _ = render.orbit_trajectory(40, 0, 40, bob=0.05)[i]
    return _SCENE.render(R, t, cam).astype(np.float32)


def _hamming(a, b):
    return np.unpackbits(a ^ b, axis=-1).sum(axis=-1)


def _assert_extraction_matches(img, jcfg, tcfg, jc, tc, min_valid):
    """extract_orb + with_undistorted of both packages on ``img``, held to
    this file's tolerances."""
    assert tcfg.level_budgets == jcfg.level_budgets
    ref = JO.with_undistorted(
        jax.jit(lambda x: JO.extract_orb(x, jcfg))(jnp.asarray(img)), jc)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got = TO.with_undistorted(TO.extract_orb(torch.tensor(img), tcfg), tc)
    got = type(got)(*(x.numpy() for x in got))

    same = ((ref.xy == got.xy).all(1) & (ref.level == got.level)
            & (ref.valid == got.valid))
    live = ref.valid | got.valid
    assert ref.valid.sum() > min_valid
    # level 0 is the image itself: keypoints identical
    assert same[live & (ref.level == 0)].all()
    # higher levels come from float resizes: >= 99% identical
    assert same[live].mean() >= 0.99, same[live].mean()
    sh = same & ref.valid
    np.testing.assert_allclose(got.angle[sh], ref.angle[sh], atol=1e-4)
    np.testing.assert_allclose(got.uv[sh], ref.uv[sh], atol=1e-3)
    np.testing.assert_allclose(got.response[sh], ref.response[sh],
                               atol=1e-3)
    # descriptors: measured identical on these frames; held to the
    # Pallas-vs-XLA budget of tests/test_pallas_orb_desc.py
    ham = _hamming(got.desc[sh], ref.desc[sh])
    assert ham.max() <= 6 and ham.mean() <= 0.5, (ham.max(), ham.mean())
    assert (ham == 0).mean() >= 0.8


@pytest.mark.parametrize("i", [0, 17])
def test_extract_orb_matches_reference(i):
    _assert_extraction_matches(
        _frame(i), JO.OrbConfig(height=H, width=W, n_features=300,
                                n_levels=4),
        TO.OrbConfig(height=H, width=W, n_features=300, n_levels=4),
        jcam.make_pinhole(FX, FY, CX, CY, DIST),
        tcam.make_pinhole(FX, FY, CX, CY, DIST, device="cpu"), 250)


def test_extract_orb_matches_reference_at_the_fixture_point():
    """The reference fixture's operating point: its KB8 camera at 0.75x
    (720x720), 8 levels, 700 features (768 slots), on a frame of the
    fixture orbit; KB8 keeps the raw keypoints as its match space."""
    cam = render.reference_kb8_cam(0.75)
    R, t, _, _ = render.orbit_trajectory(240, 0.0, 450.0, radius=2.5,
                                         bob=0.05)[40]
    img = _SCENE.render(R, t, cam).astype(np.float32)
    jcfg = JO.OrbConfig(height=720, width=720, n_features=700, n_levels=8)
    tcfg = TO.OrbConfig(height=720, width=720, n_features=700, n_levels=8)
    assert tcfg.capacity == 768
    k = (cam.fx, cam.fy, cam.cx, cam.cy, *cam.k)
    _assert_extraction_matches(img, jcfg, tcfg, jcam.make_kb8(*k),
                               tcam.make_kb8(*k, device="cpu"), 650)


def test_pyramid_blur_fast_nms_match_reference():
    img = _frame(5)
    jcfg = JO.OrbConfig(height=H, width=W, n_levels=4)
    tcfg = TO.OrbConfig(height=H, width=W, n_levels=4)
    jp = JO.compute_pyramid(jnp.asarray(img), jcfg)
    tp = TO.compute_pyramid(torch.tensor(img), tcfg)
    for lv, (a, b) in enumerate(zip(jp, tp)):
        if lv == 0:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:  # f32 products summed in another order
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-3)
    stack = np.stack([np.asarray(x)[:60, :90] for x in jp])
    js, ts = jnp.asarray(stack), torch.tensor(stack)
    np.testing.assert_array_equal(TO.gaussian_blur(ts).numpy(),
                                  np.asarray(JO.gaussian_blur(js)))
    score = JO.fast_score_map(js)
    np.testing.assert_array_equal(TO.fast_score_map(ts).numpy(),
                                  np.asarray(score))
    np.testing.assert_array_equal(
        TO._nms3(torch.tensor(np.asarray(score))).numpy(),
        np.asarray(JO._nms3(score)))


def test_plain_describe_matches_pallas_interpret():
    """ic_brief_plain against POD.ic_brief_fused(interpret=True) on the
    same stacks and keypoints (the Pallas kernel's extents: H % 8 == 0,
    W % 128 == 0)."""
    h, w = 240, 384
    cfg = JO.OrbConfig(height=h, width=w, n_features=96, n_levels=4)
    img = _frame(9, w=w, h=h)
    L = cfg.n_levels
    Hp, Wp = cfg.level_sizes[0]
    pyr = JO.compute_pyramid(jnp.asarray(img), cfg)
    stack = jnp.stack([jnp.pad(p, ((0, Hp - p.shape[0]), (0, Wp - p.shape[1])))
                       for p in pyr])
    blur = jnp.stack([jnp.pad(jnp.round(JO.gaussian_blur(p)),
                              ((0, Hp - p.shape[0]), (0, Wp - p.shape[1])))
                      for p in pyr])
    xy, _, valid = JO._select_keypoints_stacked(JO.fast_score_map(stack), cfg)
    _, lvl_np, _, hws_np = JO._stack_constants(cfg)
    lvl = jnp.asarray(lvl_np)
    N = xy.shape[0]
    assert N % POD.CHUNK == 0
    y0, x0 = POD.window_origins(xy[:, 1], xy[:, 0], Hp, Wp)
    hw = jnp.asarray(hws_np)
    z = jnp.zeros_like(y0)
    meta = jnp.stack([xy[:, 1], xy[:, 0], y0, x0, hw[:, 0], hw[:, 1], z, z],
                     axis=-1).astype(jnp.int32)
    dma = jnp.stack([(lvl * Hp + y0) // 8, x0 // 128]).astype(jnp.int32)
    pat = jnp.asarray(JO._PATTERN, jnp.float32)
    pat4 = jnp.zeros((4, 512), jnp.float32)
    pat4 = pat4.at[0].set(jnp.concatenate([pat[:, 0], pat[:, 2]]))
    pat4 = pat4.at[1].set(jnp.concatenate([pat[:, 1], pat[:, 3]]))
    ang_ref, bits = POD.ic_brief_fused(stack.reshape(L * Hp, Wp),
                                       blur.reshape(L * Hp, Wp), dma, meta,
                                       pat4, interpret=True)
    desc_ref = np.asarray(JO.pack_bits_256(bits > 0.5))

    ang, desc = CO.ic_brief_plain(
        torch.tensor(np.asarray(stack)), torch.tensor(np.asarray(blur)),
        torch.tensor(np.asarray(xy)), torch.tensor(lvl_np),
        torch.tensor(hws_np))
    ok = np.asarray(valid)
    assert ok.sum() > 80
    # the Pallas kernel sums its moments over another window: same
    # bounds as tests/test_pallas_orb_desc.py
    np.testing.assert_allclose(ang.numpy()[ok], np.asarray(ang_ref)[ok],
                               atol=2e-3)
    ham = _hamming(desc.numpy()[ok], desc_ref[ok])
    assert ham.max() <= 6 and ham.mean() <= 0.5, (ham.max(), ham.mean())
    assert (ham == 0).mean() >= 0.8


def test_kernel_umax_table_matches_reference():
    """The CUDA kernel's constant umax table is the reference's."""
    path = os.path.join(os.path.dirname(CO.__file__), "..", "csrc",
                        "orb_desc.cu")
    with open(path) as f:
        src = f.read()
    body = re.search(r"c_umax\[[^\]]*\]\s*=\s*\{([^}]*)\}", src).group(1)
    table = [int(v) for v in body.replace("\n", " ").split(",")]
    assert table == [int(v) for v in JO._circular_umax()]
    assert table == [int(v) for v in CO.circular_umax()]
    np.testing.assert_array_equal(CO.load_pattern(), JO._PATTERN)
