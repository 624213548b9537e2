"""The copied roofline counts (``ref/work.py``) give the bounds that
chip_smoke.py's phase 3 and 13 printed at their inputs (PERF.md §6):
describe 0.876 us at the EuRoC frame's 1000 keypoints, masked match
0.458 us at Q=4096 x F=1024, min_hamming2 0.248 us at 1024 x 1024, and
the caps' (point, slot) segment sum between its output floor and its
all-rows ceiling around 272.46 us.  The frozen ORB equals the program's
plain extraction on a rendered frame, bit for bit."""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import check  # noqa: E402
from slambench.ref import orb, render, work  # noqa: E402

W, H = 752, 480
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375


def euroc_frame():
    """Phase 3's describe frame: room seed 5, the first pose of a 30-31
    degree arc, the EuRoC pinhole."""
    cam = render.RenderCam(W, H, FX, FY, CX, CY)
    R, t, _ = render.orbit_trajectory(2, 30, 31, bob=0.05)[0]
    return render.RoomScene(seed=5).render(R, t, cam)


def phase3_match_inputs():
    """Phase 3's masked and unmasked search inputs, drawn in its order."""
    rng = np.random.default_rng(0)
    Q, F = 4096, 1024
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    quv = rng.uniform(0, W, (Q, 2)).astype(np.float32)
    tuv = rng.uniform(0, W, (F, 2)).astype(np.float32)
    dt[:400] = dq[:400]
    tuv[:400] = quv[:400] + rng.uniform(-4, 4, (400, 2))
    dt[400:450], tuv[400:450] = dt[350:400], tuv[350:400]
    rad = rng.uniform(2.5, 24.0, Q).astype(np.float32)
    ql = rng.integers(0, 8, Q).astype(np.int32)
    tl = ql[np.arange(F) % Q]
    qv = rng.random(Q) > 0.05
    tv = rng.random(F) > 0.05
    return tuple(torch.tensor(x) for x in (quv, rad, ql, qv, tuv, tl, tv))


def test_describe_bound_at_the_euroc_frame():
    cfg = orb.OrbConfig(H, W, n_features=1000)
    img = euroc_frame()
    f = orb.extract(img, cfg)
    v = f["valid"]
    _, _, _, hws = orb.stack_constants(cfg, img.device)
    shape = (cfg.n_levels,) + cfg.level_sizes[0]
    b = work.bound_s(*work.describe_work(shape, f["xy"][v], f["level"][v],
                                         hws[v], f["angle"][v]))
    assert abs(b * 1e6 - 0.876) < 0.0005, b * 1e6


def test_masked_and_best_two_bounds_at_phase3_inputs():
    quv, rad, ql, qv, tuv, tl, tv = phase3_match_inputs()
    b = work.bound_s(*work.masked_work(quv, rad, ql, qv, tuv, tl, tv))
    assert abs(b * 1e6 - 0.458) < 0.0005, b * 1e6
    b2 = work.bound_s(*work.best2_work(qv[:1024], tv))
    assert abs(b2 * 1e6 - 0.248) < 0.0005, b2 * 1e6


def test_segsum_bound_at_the_caps_point_slot_shape():
    """393216 rows -> 12582912 x 18 f32: the output alone takes 270.4 us
    at 3.35 TB/s, every row kept 280.8 us; phase 13's plan, which drops
    the rows of unused slots, read 272.46."""
    E, n_out, C = 393216, 12582912, 18
    empty = torch.zeros(E, dtype=torch.int32)
    floor = work.bound_s(*work.segsum_work(empty, empty, n_out, (E, C),
                                           torch.float32))
    one = torch.arange(E, dtype=torch.int32)
    ceil = work.bound_s(*work.segsum_work(one, one + 1, n_out, (E, C),
                                          torch.float32))
    assert floor * 1e6 < 272.46 < ceil * 1e6
    assert abs(floor * 1e6 - 271.84) < 0.01 and abs(ceil * 1e6 - 280.77) < 0.01


def test_frozen_orb_equals_the_programs_plain_extraction():
    from mam3slam_tpu_torch.ops import orb as program_orb

    img = torch.round(euroc_frame())
    cfg = orb.OrbConfig(H, W, n_features=1000)
    ref = check.ref_features(img, cfg)
    f = program_orb.extract_orb(img, program_orb.OrbConfig(
        H, W, n_features=1000))
    v = f.valid.numpy()
    lvl = f.level.numpy()[v]
    xy = np.floor(f.xy.numpy()[v] / np.asarray(cfg.scales)[lvl][:, None]
                  + 0.5).astype(np.int64)
    prog = dict(level=lvl, x=xy[:, 0], y=xy[:, 1], desc=f.desc.numpy()[v])
    assert check.orb_gap(prog, ref) == (0, len(ref["x"]), 0, len(ref["x"]))
    assert np.array_equal(f.angle.numpy()[v],
                          orb.extract(img, cfg)["angle"].numpy()[
                              orb.extract(img, cfg)["valid"].numpy()])


def test_control_in_bfloat16_moves_keypoints_and_bits():
    img = torch.round(euroc_frame())
    cfg = orb.OrbConfig(H, W, n_features=1000)
    ref = check.ref_features(img, cfg)
    low = check.ref_features(img, cfg, torch.bfloat16)
    only, union, bits, shared = check.orb_gap(low, ref)
    assert only / union > 0.05 and bits / shared > 1.0
