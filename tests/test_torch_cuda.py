"""The port's CUDA kernels against their plain PyTorch versions on the
card (small shapes; chip_smoke.py checks them at the tracking path's
shapes).  Marked ``cuda``: they skip where torch sees no CUDA device.

    pytest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import cuda_match as CM
from mam3slam_tpu_torch.ops import cuda_orb_desc as CO
from mam3slam_tpu_torch.ops import cuda_pose as CP
from mam3slam_tpu_torch.ops import orb as O

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counted(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


def test_match_kernels_equal_plain(dev):
    rng = np.random.default_rng(1)
    Q, F = 300, 200
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    dt[:80] = dq[:80]
    dt[80:100] = dt[60:80]                                  # ties
    quv = rng.uniform(0, 200, (Q, 2)).astype(np.float32)
    tuv = quv[np.arange(F) % Q] + rng.uniform(-5, 5, (F, 2)).astype(
        np.float32)
    args = [torch.tensor(x, device=dev) for x in (
        dq, quv, rng.uniform(2, 10, Q).astype(np.float32),
        rng.integers(0, 4, Q).astype(np.int32), rng.random(Q) > 0.1,
        dt, tuv, rng.integers(0, 4, F).astype(np.int32), rng.random(F) > 0.1)]
    got = _counted("masked_match", lambda: CM.fused_masked_match(*args))
    for g, p in zip(got, CM.fused_masked_match_plain(*args)):
        assert torch.equal(g, p)
    h = (args[0], args[4], args[5], args[8])
    got = _counted("min_hamming2", lambda: CM.min_hamming2(*h))
    for g, p in zip(got, CM.min_hamming2_plain(*h)):
        assert torch.equal(g, p)


def test_masked_match_at_fuse_shape_equals_plain(dev):
    """The mapping epoch's fuse: all 24576 arena points as queries, most
    of them not visible, against one keyframe's 1024 features."""
    rng = np.random.default_rng(4)
    Q, F = 24576, 1024
    dt = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    tuv = rng.uniform(0, 752, (F, 2)).astype(np.float32)
    tl = rng.integers(0, 8, F).astype(np.int32)
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    quv = rng.uniform(0, 752, (Q, 2)).astype(np.float32)
    ql = rng.integers(0, 8, Q).astype(np.int32)
    dq[:500], quv[:500], ql[:500] = dt[:500], tuv[:500] + 1.0, tl[:500]
    vis = rng.random(Q) < 0.1
    vis[:500] = True
    rad = (3.0 * 1.2 ** ql).astype(np.float32)
    args = [torch.tensor(x, device=dev) for x in (
        dq, quv, rad, ql, vis, dt, tuv, tl, rng.random(F) > 0.02)]
    got = _counted("masked_match", lambda: CM.fused_masked_match(*args))
    for g, p in zip(got, CM.fused_masked_match_plain(*args)):
        assert torch.equal(g, p)
    assert int((got[1][:500] == 0).sum()) >= 450


@pytest.mark.parametrize("th", [8.0, 5.0])
def test_masked_match_at_sim3_search_equals_plain(dev, th):
    """The loop server's Sim3-guided projection search: the candidate
    window's points among all 24576 arena points, radius th * 1.2^level
    (th 8, then 5 through the optimised Sim3), against one keyframe."""
    rng = np.random.default_rng(5)
    Q, F = 24576, 1024
    dt = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    tuv = rng.uniform(0, 752, (F, 2)).astype(np.float32)
    tl = rng.integers(0, 8, F).astype(np.int32)
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    quv = rng.uniform(0, 752, (Q, 2)).astype(np.float32)
    ql = rng.integers(0, 8, Q).astype(np.int32)
    dq[:500], ql[:500] = dt[:500], tl[:500]
    quv[:500] = tuv[:500] + rng.uniform(-6, 6, (500, 2))
    dq[500:550] = dt[450:500]                               # ties
    vis = rng.random(Q) < 0.15
    vis[:550] = True
    args = [torch.tensor(x, device=dev) for x in (
        dq, quv, (th * 1.2 ** ql).astype(np.float32), ql, vis, dt, tuv, tl,
        rng.random(F) > 0.02)]
    got = _counted("masked_match", lambda: CM.fused_masked_match(*args))
    for g, p in zip(got, CM.fused_masked_match_plain(*args)):
        assert torch.equal(g, p)
    assert int((got[1][:500] == 0).sum()) >= 400


def test_min_hamming2_with_partial_masks_equals_plain(dev):
    """BoW-space matching in verification and relocalization: only the
    features with a map point take part, on both sides."""
    rng = np.random.default_rng(6)
    n = 1024
    dq = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    dt[:300] = dq[:300]
    dt[300:340] = dt[260:300]                               # ties
    args = [torch.tensor(x, device=dev) for x in (
        dq, rng.random(n) < 0.6, dt, rng.random(n) < 0.6)]
    got = _counted("min_hamming2", lambda: CM.min_hamming2(*args))
    for g, p in zip(got, CM.min_hamming2_plain(*args)):
        assert torch.equal(g, p)


def test_describe_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    cfg = O.OrbConfig(120, 160, n_features=100, n_levels=3)
    img = torch.tensor(rng.uniform(0, 255, (120, 160)).astype(np.float32),
                       device=dev)
    stack = O.build_stack(img, cfg)
    xy, _, valid = O._select_keypoints_stacked(O.fast_score_map(stack), cfg)
    blur = torch.round(O.gaussian_blur(stack))
    _, lvl, _, hws = O._device_constants(cfg, dev)
    ang, desc = _counted("orb_desc",
                         lambda: CO.ic_brief(stack, blur, xy, lvl, hws))
    p_ang, p_desc = CO.ic_brief_plain(stack, blur, xy, lvl, hws)
    assert (ang - p_ang).abs()[valid].max() <= 1e-4
    bits = (CM.unpack_bits(desc) != CM.unpack_bits(p_desc)).sum(-1)[valid]
    assert (bits == 0).float().mean() >= 0.99 and bits.max() <= 2


def test_pose_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    n = 300
    pts = torch.tensor(np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                                 rng.uniform(3, 12, n)], 1).astype(np.float32),
                       device=dev)
    q_true = lie.so3_exp_quat(torch.tensor([0.03, -0.02, 0.01], device=dev))
    t_true = torch.tensor([0.1, -0.05, 0.2], device=dev)
    xc = lie.quat_rotate(q_true[None], pts) + t_true
    uv = xc[:, :2] / xc[:, 2:] * 450.0 + 300.0
    uv[:20] += 40.0
    fxycxy = torch.tensor([450.0, 450.0, 300.0, 300.0], device=dev)
    w = torch.ones(n, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q0 = lie.quat_normalize(q_true + 0.01)
    t0 = t_true + 0.05
    args = (q0[None], t0[None], fxycxy[None], pts[None], uv[None], w[None],
            valid[None])
    q, t, inl, n_in = _counted(
        "pose_opt", lambda: CP.pose_optimization_pinhole(*args))
    pq, pt, pinl, pn = CP.pose_optimization_plain(
        q0, t0, torch.cat([fxycxy, torch.zeros_like(fxycxy)]), 0, pts, uv, w,
        valid)
    assert 2 * torch.acos(torch.clamp((q[0] * pq).sum().abs(), max=1.0)) < 2e-3
    assert (t[0] - pt).norm() < 5e-3
    assert (inl[0] == pinl).float().mean() >= 0.99
    assert int(n_in[0]) == int(inl[0].sum())
