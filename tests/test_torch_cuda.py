"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes and at the callers' shapes (tracking, fuse, Sim3
search; the pose at a batch of two and past the edges kept in
registers, and at the agent batches of ``batched_pose_optimization``).
Marked ``cuda``: they skip where torch sees no CUDA device.

    pytest --noconftest tests/test_torch_cuda.py
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


def _planted(rng, Q, F, n_match, width=752.0):
    """Queries and targets with ``n_match`` planted matches, then copies of
    some matched targets further along (equal distances in other lanes and,
    past 2048 targets, in another shared-memory pass)."""
    dq = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    quv = rng.uniform(0, width, (Q, 2)).astype(np.float32)
    tuv = rng.uniform(0, width, (F, 2)).astype(np.float32)
    ql = rng.integers(0, 8, Q).astype(np.int32)
    tl = rng.integers(0, 8, F).astype(np.int32)
    dt[:n_match], tl[:n_match] = dq[:n_match], ql[:n_match]
    tuv[:n_match] = quv[:n_match] + rng.uniform(-3, 3, (n_match, 2))
    k = n_match // 4
    for start in (n_match, F - k):
        dt[start:start + k] = dt[n_match - k:n_match]
        tuv[start:start + k] = tuv[n_match - k:n_match]
        tl[start:start + k] = tl[n_match - k:n_match]
    return dq, quv, ql, dt, tuv, tl


@pytest.mark.parametrize("F", [1024, 2500])
def test_masked_match_at_tracking_shape_equals_plain(dev, F):
    """Tracking: 4096 projected candidates against the frame's features;
    F = 2500 spans two shared-memory passes of the kernel."""
    rng = np.random.default_rng(8)
    Q = 4096
    dq, quv, ql, dt, tuv, tl = _planted(rng, Q, F, 400)
    args = [torch.tensor(x, device=dev) for x in (
        dq, quv, rng.uniform(2.5, 24.0, Q).astype(np.float32), ql,
        rng.random(Q) > 0.05, dt, tuv, tl, rng.random(F) > 0.05)]
    got = _counted("masked_match", lambda: CM.fused_masked_match(*args))
    for g, p in zip(got, CM.fused_masked_match_plain(*args)):
        assert torch.equal(g, p)
    assert int(((got[1] == got[2]) & (got[1] < CM.BIG)).sum()) >= 20
    assert int((got[1] == 0).sum()) >= 300


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


def _best2_problem(rng, Q, M):
    """Queries near seeded targets, with copies of the targets 2, 8 and
    128 columns on (equal distances in another lane group, warp and round
    of the tensor-core kernel)."""
    dt = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    near = (7 * np.arange(Q)) % M
    dq = dt[near] ^ (rng.integers(0, 256, (Q, 32), dtype=np.uint8)
                     & rng.integers(0, 256, (Q, 32), dtype=np.uint8) & 0x11)
    for step in (2, 8, 128):
        src = near[near + step < M][::3]
        dt[src + step] = dt[src]
    return dq, dt


def _min_hamming2_equals_plain(dev, dq, qv, dt, tv):
    args = [torch.tensor(x, device=dev) for x in (dq, qv, dt, tv)]
    got = _counted("min_hamming2", lambda: CM.min_hamming2(*args))
    plain = CM.min_hamming2_plain(*args)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    return got


@pytest.mark.parametrize("Q,M", [(1, 1), (33, 77), (1000, 1024),
                                 (1024, 2500)])
def test_min_hamming2_ragged_sizes_equal_plain(dev, Q, M):
    """Q and M not multiples of the 16 x 8 tile, invalid rows and
    columns, ties planted across lanes, warps and rounds."""
    rng = np.random.default_rng(30 + Q + M)
    dq, dt = _best2_problem(rng, Q, M)
    qv, tv = rng.random(Q) > 0.1, rng.random(M) > 0.1
    qv[0] = tv[0] = True
    got = _min_hamming2_equals_plain(dev, dq, qv, dt, tv)
    if M >= 77:
        assert int(((got[1] == got[2]) & (got[1] < CM.BIG)).sum()) >= 3


@pytest.mark.parametrize("case", ["queries_invalid", "targets_invalid",
                                  "single_target", "ties_everywhere"])
def test_min_hamming2_edge_masks_equal_plain(dev, case):
    rng = np.random.default_rng(12)
    Q, M = 100, 1000
    dq, dt = _best2_problem(rng, Q, M)
    qv, tv = np.ones(Q, bool), np.ones(M, bool)
    if case == "queries_invalid":
        qv[:] = False
    elif case == "targets_invalid":
        tv[:] = False
    elif case == "single_target":
        tv[:] = False
        tv[rng.integers(0, M)] = True
    else:
        dt[13::5] = dq[3]          # d = 0 from column 13 on, every 5th
    got = _min_hamming2_equals_plain(dev, dq, qv, dt, tv)
    if case == "ties_everywhere":
        assert int(got[0][3]) == 13 and int(got[2][3]) == 0


@pytest.mark.parametrize("n", [1, 33, 1000, 3000])
def test_describe_kernel_at_sizes_and_level_edges_matches_plain(dev, n):
    """Keypoints on every level of the EuRoC stack, every fourth on an
    edge or corner of its level, where the circle and the rotated taps
    clamp; phase 3's gates."""
    rng = np.random.default_rng(40 + n)
    cfg = O.OrbConfig(480, 752, n_features=1000)
    img = torch.tensor(rng.uniform(0, 255, (480, 752)).astype(np.float32),
                       device=dev)
    stack = O.build_stack(img, cfg)
    blur = torch.round(O.gaussian_blur(stack))
    lvl = rng.integers(0, cfg.n_levels, n)
    hw = np.asarray(cfg.level_sizes)[lvl]
    x = (rng.random(n) * hw[:, 1]).astype(np.int64)
    y = (rng.random(n) * hw[:, 0]).astype(np.int64)
    edge = np.arange(0, n, 4)
    x[edge[0::4]] = 0
    y[edge[0::4]] = 0
    x[edge[1::4]] = hw[edge[1::4], 1] - 1
    y[edge[2::4]] = 1
    y[edge[3::4]] = hw[edge[3::4], 0] - 1
    x[edge[3::4]] = hw[edge[3::4], 1] - 2
    args = (stack, blur,
            torch.tensor(np.stack([x, y], 1).astype(np.int32), device=dev),
            torch.tensor(lvl.astype(np.int32), device=dev),
            torch.tensor(hw.astype(np.int32), device=dev))
    ang, desc = _counted("orb_desc", lambda: CO.ic_brief(*args))
    p_ang, p_desc = CO.ic_brief_plain(*args)
    assert (ang - p_ang).abs().max() <= 1e-4
    bits = (CM.unpack_bits(desc) != CM.unpack_bits(p_desc)).sum(-1)
    assert (bits == 0).float().mean() >= 0.99 and bits.max() <= 2


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


@pytest.mark.parametrize("B,n", [(1, 1024), (2, 1024), (1, 1500)])
def test_pose_kernel_batch_and_long_edge_lists_match_plain(dev, B, n):
    """The tracking shape, a batch of two agents, and more edges than the
    kernel keeps in registers (2 x 512)."""
    rng = np.random.default_rng(9 + B + n)
    fx, fy, cx, cy = 458.654, 457.296, 367.215, 248.375
    fxycxy = torch.tensor([fx, fy, cx, cy], device=dev)
    cols = [torch.stack(x) for x in zip(*[_pose_problem(rng, n, fxycxy, dev)
                                          for _ in range(B)])]
    q0, t0, pts, uv, valid = cols
    w = torch.ones(B, n, device=dev)
    params = torch.cat([fxycxy, torch.zeros_like(fxycxy)])
    q, t, inl, n_in = _counted("pose_opt", lambda: CP.pose_optimization_batched(
        q0, t0, params.expand(B, 8).contiguous(), 0, pts, uv, w, valid))
    for b in range(B):
        pq, pt, pinl, _ = CP.pose_optimization_plain(
            q0[b], t0[b], params, 0, pts[b], uv[b], w[b], valid[b])
        dot = (q[b] * pq).sum().abs().clamp(max=1.0)
        assert 2 * torch.acos(dot) < 2e-3
        assert (t[b] - pt).norm() < 5e-3
        assert (inl[b] == pinl).float().mean() >= 0.99
        assert int(n_in[b]) == int(inl[b].sum())


@pytest.mark.parametrize("B", [4, 8])
def test_batched_pose_optimization_is_one_launch(dev, B, tmp_path):
    """``parallel.dist_ba.batched_pose_optimization`` on a one-rank mesh
    (gloo, CUDA tensors): the B agents' problems go to the pose kernel's
    batch axis in one launch, each within the plain version's tolerance
    (rotation 2e-3 rad, translation 5e-3, >= 99% of the edges alike)."""
    from mam3slam_tpu_torch.parallel import dist_ba, mesh

    rng = np.random.default_rng(40 + B)
    n = 1024
    fxycxy = torch.tensor([458.654, 457.296, 367.215, 248.375], device=dev)
    q0, t0, pts, uv, valid = [torch.stack(x) for x in zip(
        *[_pose_problem(rng, n, fxycxy, dev) for _ in range(B)])]
    w = torch.ones(B, n, device=dev)
    params = torch.cat([fxycxy, torch.zeros_like(fxycxy)])
    cams = params.expand(B, 8).contiguous()
    m = mesh.init_mesh((1,), ("agent",), "gloo", f"file://{tmp_path}/s",
                       device=dev)
    try:
        fn = dist_ba.batched_pose_optimization(m, 0)
        res = _counted("pose_opt", lambda: fn(q0, t0, cams, pts, uv, w,
                                               valid))
    finally:
        mesh.close_mesh()
    for b in range(B):
        pq, pt, pinl, _ = CP.pose_optimization_plain(
            q0[b], t0[b], params, 0, pts[b], uv[b], w[b], valid[b])
        dot = (res.q[b] * pq).sum().abs().clamp(max=1.0)
        assert 2 * torch.acos(dot) < 2e-3
        assert (res.t[b] - pt).norm() < 5e-3
        assert (res.inlier[b] == pinl).float().mean() >= 0.99
        assert int(res.n_inliers[b]) == int(res.inlier[b].sum())


def _pose_problem(rng, n, fxycxy, dev):
    """A seeded pose problem: points 3-12 m ahead, pixel noise 0.6 px, 6%
    gross outliers, every 29th edge invalid, a perturbed start."""
    T = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    pts = T(np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                      rng.uniform(3, 12, n)], 1))
    q_true = lie.so3_exp_quat(T(rng.normal(0, 0.05, 3)))
    t_true = T(rng.normal(0, 0.2, 3))
    xc = lie.quat_rotate(q_true[None], pts) + t_true
    uv = xc[:, :2] / xc[:, 2:] * fxycxy[:2] + fxycxy[2:]
    uv = uv + T(rng.normal(0, 0.6, (n, 2)))
    n_out = int(0.06 * n)
    uv[:n_out] += T(rng.uniform(20, 80, (n_out, 2)))
    q0 = lie.quat_normalize(lie.quat_mul(
        lie.so3_exp_quat(T(rng.normal(0, 0.02, 3))), q_true))
    t0 = t_true + T(rng.normal(0, 0.05, 3))
    valid = torch.tensor(np.arange(n) % 29 != 0, device=dev)
    return q0, t0, pts, uv, valid


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
    params = torch.cat([fxycxy, torch.zeros_like(fxycxy)])
    args = (q0[None], t0[None], params[None], 0, pts[None], uv[None], w[None],
            valid[None])
    q, t, inl, n_in = _counted(
        "pose_opt", lambda: CP.pose_optimization_batched(*args))
    pq, pt, pinl, pn = CP.pose_optimization_plain(q0, t0, params, 0, pts, uv,
                                                  w, valid)
    assert 2 * torch.acos(torch.clamp((q[0] * pq).sum().abs(), max=1.0)) < 2e-3
    assert (t[0] - pt).norm() < 5e-3
    assert (inl[0] == pinl).float().mean() >= 0.99
    assert int(n_in[0]) == int(inl[0].sum())


@pytest.mark.parametrize("B,n,degenerate", [(1, 768, False), (2, 1024, True),
                                            (1, 1500, True)])
def test_pose_kernel_kb8_matches_plain(dev, B, n, degenerate):
    """The KB8 kernel at the fixture camera (reference_kb8_cam(0.75)) and
    past the edges kept in registers; ``degenerate`` puts points behind
    the camera and on the optical axis (r ~ 0, where the KB8 jacobian
    takes its clamp r^2 >= 1e-18).  Tolerance as the pinhole kernel's:
    rotation 2e-3 rad, translation 5e-3, >= 99% of inliers alike; the
    inlier count equals the returned set."""
    from mam3slam_tpu_torch.geometry import cameras as C

    rng = np.random.default_rng(21 + B + n)
    cam = C.make_kb8(352.65, 352.65, 359.925, 359.925, 0.0034823894,
                     0.00071503485, -0.0020532361, 0.00020293674, device=dev)
    T = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    cols = []
    for _ in range(B):
        # a wide fisheye field: up to ~70 degrees off the axis
        pts = T(np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                          rng.uniform(1.5, 10, n)], 1))
        q_true = lie.so3_exp_quat(T(rng.normal(0, 0.05, 3)))
        t_true = T(rng.normal(0, 0.2, 3))
        if degenerate:
            # on the optical axis at the true pose, and behind the camera
            axis = torch.cat([T(rng.normal(0, 1e-7, (8, 2))), pts[:8, 2:]], 1)
            pts[:8] = lie.quat_rotate(lie.quat_conj(q_true)[None],
                                      axis - t_true)
            pts[8:16, 2] = -pts[8:16, 2]
        uv = C.project(cam, lie.quat_rotate(q_true[None], pts) + t_true)
        uv = uv + T(rng.normal(0, 0.6, (n, 2)))
        n_out = int(0.06 * n)
        uv[16:16 + n_out] += T(rng.uniform(20, 80, (n_out, 2)))
        q0 = lie.quat_normalize(lie.quat_mul(
            lie.so3_exp_quat(T(rng.normal(0, 0.02, 3))), q_true))
        t0 = t_true + T(rng.normal(0, 0.05, 3))
        valid = torch.tensor(np.arange(n) % 29 != 0, device=dev)
        cols.append((q0, t0, pts, uv, valid))
    q0, t0, pts, uv, valid = [torch.stack(x) for x in zip(*cols)]
    w = torch.ones(B, n, device=dev)
    params = cam.params.expand(B, 8).contiguous()
    q, t, inl, n_in = _counted("pose_opt", lambda: CP.pose_optimization_batched(
        q0, t0, params, C.KANNALA_BRANDT8, pts, uv, w, valid))
    for b in range(B):
        pq, pt, pinl, _ = CP.pose_optimization_plain(
            q0[b], t0[b], cam.params, C.KANNALA_BRANDT8, pts[b], uv[b], w[b],
            valid[b])
        dot = (q[b] * pq).sum().abs().clamp(max=1.0)
        assert 2 * torch.acos(dot) < 2e-3
        assert (t[b] - pt).norm() < 5e-3
        assert (inl[b] == pinl).float().mean() >= 0.99
        assert int(n_in[b]) == int(inl[b].sum())
        if degenerate:
            assert not inl[b, 8:16].any()


def test_pipelined_readback_equals_blocking_read(dev):
    """Depth-1 pipelined tracking on the card (half the EuRoC cam0 point,
    a rendered room): every deferred frame completes, and each frame's
    packed vector read from its pinned copy equals a blocking read of the
    same device tensor."""
    from mam3slam_tpu_torch.geometry import cameras
    from mam3slam_tpu_torch.io import render
    from mam3slam_tpu_torch.slam import steps
    from mam3slam_tpu_torch.slam import system as tsys

    W, H, f, cx, cy = 376, 240, 229.3, 183.6, 124.2
    cam_r = render.RenderCam(W, H, f, f, cx, cy)
    cam = cameras.make_pinhole(f, f, cx, cy, device=dev)
    orb_cfg = O.OrbConfig(height=H, width=W, n_features=500)
    sys_ = tsys.SlamSystem(tsys.SlamConfig(
        width=W, height=H, n_feat=orb_cfg.capacity, max_kf=64,
        max_mp=8192), cam)
    sys_.pipeline = True
    checked = []
    read = sys_._read_vec

    def compare(pend):
        host = read(pend)
        assert "staged" in pend and pend["staged"][0].is_pinned()
        np.testing.assert_array_equal(host, pend["vec"].cpu().numpy())
        checked.append(pend["ts"])
        return host

    sys_._read_vec = compare
    aid = sys_.add_agent()
    scene = render.RoomScene(seed=5, device=dev)
    n = 40
    for i, (R, t, _) in enumerate(render.orbit_trajectory(
            n, 0.0, 0.8 * n, radius=2.5, bob=0.05)):
        f_ = O.with_undistorted(O.extract_orb(scene.render(R, t, cam_r),
                                              orb_cfg), cam)
        sys_.track(aid, steps.FrameObs(f_.uv, f_.level, f_.angle, f_.desc,
                                       f_.valid), i * 0.05)
    sys_.flush()
    a = sys_.agents[aid]
    assert a.state == tsys.OK and not a.pending_q
    tracked = [row[0] for row in a.trajectory]
    assert checked and checked == tracked[-len(checked):]
    assert len(checked) >= n - 10


def _segsum_case(rng, E, n_out, C, dtype=np.float32, drop=0.1):
    """Rows by a random index into ``n_out`` rows, ``drop`` of them outside
    (summed nowhere), a few long segments among short ones."""
    idx = rng.integers(0, max(n_out, 1), E)
    idx[: E // 4] = rng.integers(0, 3, E // 4) if n_out >= 3 else 0
    idx[rng.random(E) < drop] = -1
    return idx, rng.normal(size=(E, C)).astype(dtype)


@pytest.mark.parametrize("E,n_out,C,dtype", [
    (1, 1, 1, np.float32), (100, 5, 27, np.float32),
    (5000, 24, 27, np.float32), (3000, 3000 * 24, 18, np.float32),
    (2000, 40 * 40, 49, np.float32), (4000, 300, 7, np.float64),
    (777, 1, 3, np.float64)])
def test_segsum_kernel_equals_plain_bit_for_bit(dev, E, n_out, C, dtype):
    from mam3slam_tpu_torch.ops import segsum as SS

    rng = np.random.default_rng(E + n_out)
    idx, v = _segsum_case(rng, E, n_out, C, dtype)
    plan = SS.segment_plan(torch.tensor(idx, device=dev), n_out)
    vals = torch.tensor(v, device=dev)
    got = _counted("segsum", lambda: SS.segment_sum(plan, vals))
    again = SS.segment_sum(plan, vals)
    cpu_plan = SS.segment_plan(torch.tensor(idx), n_out)
    for p_dev, p_cpu in zip(plan[:4], cpu_plan[:4]):
        assert torch.equal(p_dev.cpu(), p_cpu)
    want = SS.segment_sum_plain(cpu_plan, torch.tensor(v))
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)


def test_segsum_kernel_with_every_row_dropped(dev):
    from mam3slam_tpu_torch.ops import segsum as SS

    plan = SS.segment_plan(torch.full((64,), 9, device=dev), 9)
    out = SS.segment_sum(plan, torch.ones(64, 5, device=dev))
    assert torch.equal(out, torch.zeros(9, 5, device=dev))
