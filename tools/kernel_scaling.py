#!/usr/bin/env python3
"""Device time of the pose and masked-match kernels across their sizes, to
split a kernel's time into what grows with the work and what does not.

    python3 tools/kernel_scaling.py     (needs a CUDA device)

Pose: one problem of N edges (N = 32 ... 2048; 4 rounds of iters + 1
evaluations, iters = 0 and 5): at N = 32 the passes over the edges cost
next to nothing, so the time per evaluation there is the chain of block
reductions, solves and barriers.  Masked match: Q queries against 1024
targets with a share of them valid (as the fuse and the Sim3 search
pass the whole arena with 10-17% visible).  Device times come from
chip_smoke.device_ms (torch.profiler); one line per point, with the
card's nvidia-smi name and power limit first.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_scaling: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch.geometry import lie
    from mam3slam_tpu_torch.ops import cuda_match as CM
    from mam3slam_tpu_torch.ops import cuda_pose as CP

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    rng = np.random.default_rng(0)

    def T(x):
        return torch.tensor(x, device=dev)

    fxycxy = T(np.float32([cs.FX, cs.FY, cs.CX, cs.CY]))
    for n in (32, 256, 1024, 2048):
        pts = T(np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                          rng.uniform(3, 12, n)], 1).astype(np.float32))
        uv = pts[:, :2] / pts[:, 2:] * fxycxy[:2] + fxycxy[2:]
        uv = uv + T(rng.normal(0, 0.6, (n, 2)).astype(np.float32))
        q0 = lie.so3_exp_quat(T(np.float32([0.02, -0.03, 0.01])))
        t0 = T(np.float32([0.05, -0.04, 0.08]))
        args = (q0[None], t0[None], fxycxy[None], pts[None], uv[None],
                torch.ones(1, n, device=dev),
                torch.ones(1, n, dtype=torch.bool, device=dev))
        for iters in (0, 5):
            ms, timer, _ = cs.device_ms(
                lambda: CP.pose_optimization_pinhole(*args, iters=iters))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
