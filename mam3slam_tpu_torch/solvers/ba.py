"""Motion-only pose optimisation (reference Optimizer::PoseOptimization)
and the edge helpers of the visual-inertial solvers.

Port of ``mam3slam_tpu.solvers.ba.pose_optimization``.  A problem on CUDA
tensors runs the pose kernel of ``ops/cuda_pose.py`` for either camera
kind (the reference sends only PINHOLE to its Pallas kernel and KB8 to
XLA); CPU tensors take the plain version.  ``Obs``, ``_edge_linearize``
and ``_segsum`` are the reference's reprojection-edge helpers that
``solvers/vi.py`` uses (its Huber weight and 3x3 SPD inverse are
``ba_window``'s).  ``run_ba`` and ``build_local_ba_problem`` are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.ops import cuda_pose

CHI2_MONO = cuda_pose.CHI2_MONO


class Obs(NamedTuple):
    """Observation edges, [E]-shaped tensors."""

    cam: torch.Tensor    # [E] i32 camera index
    pt: torch.Tensor     # [E] i32 point index
    uv: torch.Tensor     # [E, 2] measured pixel
    w: torch.Tensor      # [E] information 1 / sigma^2
    valid: torch.Tensor  # [E] bool


def _edge_linearize(cam_q, cam_t, cam_params, kind, pts, obs: Obs):
    """Residuals r = pred - uv [E, 2], analytic jacobians Jc [E, 2, 6]
    (left se3 tangent [rho, phi]) and Jp [E, 2, 3], and depth > 1e-3."""
    ci, pi = obs.cam.long(), obs.pt.long()
    q = cam_q[ci]
    Xc = lie.quat_rotate(q, pts[pi]) + cam_t[ci]
    cam = cam_mod.Camera(cam_params[ci], kind)
    r = cam_mod.project_ideal(cam, Xc) - obs.uv
    dpi = cam_mod.project_jac(cam, Xc)
    Jc = torch.cat([dpi, -dpi @ lie.hat(Xc)], -1)
    Jp = dpi @ lie.quat_to_matrix(q)
    return r, Jc, Jp, Xc[..., 2] > 1e-3


def _segsum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of per-edge values into ``n`` vertex rows."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx.long(), vals)


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
