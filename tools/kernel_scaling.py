#!/usr/bin/env python3
"""Device time of the port's four kernels across their sizes, to split a
kernel's time into what grows with the work and what does not.

    python3 tools/kernel_scaling.py     (needs a CUDA device)

Pose: one problem of N edges (N = 32 ... 2048; 4 rounds of iters + 1
evaluations, iters = 0 and 5): at N = 32 the passes over the edges cost
next to nothing, so the time per evaluation there is the chain of block
reductions, solves and barriers.  Masked match: Q queries against 1024
targets with a share of them valid (as the fuse and the Sim3 search
pass the whole arena with 10-17% visible).  Best-two (min_hamming2):
Q = M in {128, 1024, 4096} with a valid share of 0.6 or 1.0 on each
side.  Describe: N in {100, 1000, 4000} keypoints spread over the levels
of an EuRoC-size stack.  Device times come from chip_smoke.device_ms
(torch.profiler), each beside its bound (``slambench/ref/work.py``'s
count of the work, as chip_smoke.py phase 3 takes it); one line per
point, with the card's nvidia-smi name and power limit first.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from slambench.ref import work  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_scaling: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch.geometry import lie
    from mam3slam_tpu_torch.ops import cuda_match as CM
    from mam3slam_tpu_torch.ops import cuda_orb_desc as CO
    from mam3slam_tpu_torch.ops import cuda_pose as CP
    from mam3slam_tpu_torch.ops import orb as O

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    rng = np.random.default_rng(0)

    def T(x):
        return torch.tensor(x, device=dev)

    fxycxy = T(np.float32([cs.FX, cs.FY, cs.CX, cs.CY]))
    params = torch.cat([fxycxy, torch.zeros_like(fxycxy)])
    for n in (32, 256, 1024, 2048):
        pts = T(np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                          rng.uniform(3, 12, n)], 1).astype(np.float32))
        uv = pts[:, :2] / pts[:, 2:] * fxycxy[:2] + fxycxy[2:]
        uv = uv + T(rng.normal(0, 0.6, (n, 2)).astype(np.float32))
        q0 = lie.so3_exp_quat(T(np.float32([0.02, -0.03, 0.01])))
        t0 = T(np.float32([0.05, -0.04, 0.08]))
        args = (q0[None], t0[None], params[None], 0, pts[None], uv[None],
                torch.ones(1, n, device=dev),
                torch.ones(1, n, dtype=torch.bool, device=dev))
        for iters in (0, 5):
            ms, timer, _ = cs.device_ms(
                lambda: CP.pose_optimization_batched(*args, iters=iters))
            evals = 4 * (iters + 1)
            cs.log("pose", N=n, iters=iters, evaluations=evals, device_us=(
                ms * 1e3), us_per_evaluation=ms * 1e3 / evals, timer=timer)

    F = 1024
    dt = T(rng.integers(0, 256, (F, 32), dtype=np.uint8))
    tuv = T(rng.uniform(0, cs.W, (F, 2)).astype(np.float32))
    tl = T(rng.integers(0, 8, F).astype(np.int32))
    tv = torch.ones(F, dtype=torch.bool, device=dev)
    for Q in (4096, 24576):
        dq = T(rng.integers(0, 256, (Q, 32), dtype=np.uint8))
        quv = T(rng.uniform(0, cs.W, (Q, 2)).astype(np.float32))
        ql = T(rng.integers(0, 8, Q).astype(np.int32))
        rad = T((8 * 1.2 ** rng.integers(0, 8, Q)).astype(np.float32))
        for share in (0.0, 0.1, 0.5, 1.0):
            qv = T(rng.random(Q) < share)
            args = (dq, quv, rad, ql, qv, dt, tuv, tl, tv)
            ms, timer, _ = cs.device_ms(lambda: CM.fused_masked_match(*args))
            cs.log("masked_match", Q=Q, F=F, visible=int(qv.sum()),
                   device_us=ms * 1e3, timer=timer)

    for n in (128, 1024, 4096):
        dq = T(rng.integers(0, 256, (n, 32), dtype=np.uint8))
        dt = T(rng.integers(0, 256, (n, 32), dtype=np.uint8))
        for share in (0.6, 1.0):
            args = (dq, T(rng.random(n) < share), dt, T(rng.random(n) < share))
            ms, timer, _ = cs.device_ms(lambda: CM.min_hamming2(*args))
            b_ms, b_by = cs.bound(work.best2_work(args[1], args[3]))
            cs.log("min_hamming2", Q=n, M=n, valid_share=share,
                   device_us=ms * 1e3, bound_us=b_ms * 1e3, bound_by=b_by,
                   timer=timer)

    cfg = O.OrbConfig(cs.H, cs.W, n_features=cs.N_FEATURES)
    stack = O.build_stack(T(rng.uniform(0, 255, (cs.H, cs.W)).astype(
        np.float32)), cfg)
    blur = torch.round(O.gaussian_blur(stack))
    for n in (100, 1000, 4000):
        lvl = rng.integers(0, cfg.n_levels, n)
        hw = np.asarray(cfg.level_sizes)[lvl]
        xy = np.stack([rng.random(n) * hw[:, 1], rng.random(n) * hw[:, 0]],
                      1).astype(np.int32)
        args = (stack, blur, T(xy), T(lvl.astype(np.int32)),
                T(hw.astype(np.int32)))
        ms, timer, _ = cs.device_ms(lambda: CO.ic_brief(*args))
        angle = CO.ic_brief(*args)[0]
        b_ms, b_by = cs.bound(work.describe_work(stack.shape, *args[2:],
                                                 angle))
        cs.log("orb_desc", N=n, device_us=ms * 1e3, bound_us=b_ms * 1e3,
               bound_by=b_by, timer=timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
