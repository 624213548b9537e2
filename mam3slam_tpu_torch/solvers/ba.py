"""Motion-only pose optimisation (reference Optimizer::PoseOptimization).

Port of ``mam3slam_tpu.solvers.ba.pose_optimization``.  A problem on CUDA
tensors runs the pose kernel of ``ops/cuda_pose.py`` for either camera
kind (the reference sends only PINHOLE to its Pallas kernel and KB8 to
XLA); CPU tensors take the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.ops import cuda_pose

CHI2_MONO = cuda_pose.CHI2_MONO


class PoseOptResult(NamedTuple):
    q: torch.Tensor          # [4]
    t: torch.Tensor          # [3]
    inlier: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor  # [] int32


def pose_optimization(q0, t0, cam_params, kind: int, pts, uv, w, valid,
                      rounds: int = 4, iters: int = 5) -> PoseOptResult:
    """Motion-only BA of one SE3 vertex over unary reprojection edges:
    4 rounds with chi2 = 5.991 re-classification between rounds and the
    Huber kernel in rounds 0-1."""
    if _build.is_cuda(pts):
        q, t, inlier, n = cuda_pose.pose_optimization_batched(
            q0[None].contiguous(), t0[None].contiguous(),
            cam_params[None].contiguous(), kind, pts[None].contiguous(),
            uv[None].contiguous(), w[None].contiguous(),
            valid[None].contiguous(), rounds=rounds, iters=iters)
        return PoseOptResult(q=q[0], t=t[0], inlier=inlier[0],
                             n_inliers=n[0])
    return PoseOptResult(*cuda_pose.pose_optimization_plain(
        q0, t0, cam_params, kind, pts, uv, w, valid, rounds=rounds,
        iters=iters))
