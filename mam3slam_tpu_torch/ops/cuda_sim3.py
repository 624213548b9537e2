"""Sim3 kernel: OptimizeSim3's Gauss-Newton refinement in one launch.

Wrapper of ``csrc/sim3.cu`` (replaces no Pallas kernel: the reference
refines the Sim3 in XLA, ``mam3slam_tpu/solvers/sim3.py:optimize_sim3``)
and its plain PyTorch version, that XLA path's port:

  for each of ``iters`` iterations, at the current S12 = (q, t, s):
    residuals of both directions of every pair, r1 = (pi1(s R pc2 + t) -
    uv1) / sigma1 and r2 = (pi2(R^T (pc1 - t) / s) - uv2) / sigma2;
    each direction Huber-weighted on its chi2 at delta^2 = ``huber2``,
    valid pairs only; H = J^T W J + 1e-6 I, g = J^T W r, dx = -H^-1 g in
    the tangent [rho, phi, sigma]: t += rho, q = normalize(exp(phi) q),
    log s += sigma;
  then inlier = valid & chi2_1 < 9.21 & chi2_2 < 9.21.

The cameras may be of different kinds (two agents' maps merging).
"""

from __future__ import annotations

import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.utils import autodiff

KINDS = (cam_mod.PINHOLE, cam_mod.KANNALA_BRANDT8)


def optimize_sim3_plain(q12, t12, s12, pc1, pc2, uv1, uv2, valid,
                        cam1: cam_mod.Camera, cam2: cam_mod.Camera,
                        sigma2_1, sigma2_2, iters: int = 20,
                        huber2: float = 100.0):
    """Plain PyTorch OptimizeSim3 on camera-frame points pc1 / pc2 [N, 3]
    (reference Optimizer::OptimizeSim3, Huber delta^2 = 100).  The [4N, 7]
    jacobian is forward-mode (``utils.autodiff.jacfwd``) in the tangent
    [rho, phi, sigma], left-perturbing the rotation.  Returns (q [4],
    t [3], s [], inliers [N] bool, n_inliers [] i64)."""
    _build.count_plain("sim3_opt")
    sig1 = torch.sqrt(sigma2_1)[:, None]
    sig2 = torch.sqrt(sigma2_2)[:, None]

    def residuals(q, t, log_s):
        s = torch.exp(log_s)
        p12 = s * lie.quat_rotate(q[None], pc2) + t[None]
        r1 = (cam_mod.project_ideal(cam1, p12) - uv1) / sig1
        p21 = (1.0 / s) * lie.quat_rotate(lie.quat_conj(q)[None],
                                          pc1 - t[None])
        r2 = (cam_mod.project_ideal(cam2, p21) - uv2) / sig2
        return r1, r2

    eye7 = torch.eye(7, dtype=pc1.dtype, device=pc1.device)
    q, t = q12, t12
    log_s = torch.log(torch.clamp(torch.as_tensor(s12, dtype=pc1.dtype,
                                                  device=pc1.device),
                                  min=1e-6))
    act2 = torch.cat([valid, valid])
    for _ in range(iters):
        def res_tangent(xi):
            nq = lie.quat_normalize(lie.quat_mul(lie.so3_exp_quat(xi[3:6]),
                                                 q))
            r1, r2 = residuals(nq, t + xi[0:3], log_s + xi[6])
            r = torch.cat([r1, r2], dim=0).reshape(-1)
            return r, r

        xi0 = torch.zeros(7, dtype=pc1.dtype, device=pc1.device)
        J, r = autodiff.jacfwd(res_tangent, xi0, has_aux=True)  # [4N, 7]
        chi = (r.reshape(-1, 2) ** 2).sum(-1)
        wh = torch.where(chi <= huber2, 1.0,
                         torch.sqrt(huber2 / torch.clamp(chi, min=1e-12)))
        wr = torch.where(act2, wh, 0.0).repeat_interleave(2)
        H = J.T @ (J * wr[:, None]) + 1e-6 * eye7
        g = J.T @ (r * wr)
        dx = torch.linalg.solve_ex(H, -g)[0]
        q = lie.quat_normalize(lie.quat_mul(lie.so3_exp_quat(dx[3:6]), q))
        t = t + dx[0:3]
        log_s = log_s + dx[6]
    r1, r2 = residuals(q, t, log_s)
    inl = valid & ((r1 ** 2).sum(-1) < 9.21) & ((r2 ** 2).sum(-1) < 9.21)
    return q, t, torch.exp(log_s), inl, inl.sum()


def optimize_sim3(q12, t12, s12, pc1, pc2, uv1, uv2, valid,
                  cam1: cam_mod.Camera, cam2: cam_mod.Camera, sigma2_1,
                  sigma2_2, iters: int = 20, huber2: float = 100.0):
    """OptimizeSim3 of S12 = (q12 [4], t12 [3], s12 []) on N pairs: camera-
    frame points pc1 / pc2 [N, 3], their pixels uv1 / uv2 [N, 2] in cam1 /
    cam2 (PINHOLE projects without distortion, KB8 in the full model),
    level sigma^2 [N], valid [N] bool.  Returns (q [4], t [3], s [],
    inliers [N] bool, n_inliers [] i64), on the inputs' device.  CUDA
    tensors launch ``csrc/sim3.cu``; CPU tensors run the plain version."""
    s12 = torch.as_tensor(s12, dtype=pc1.dtype, device=pc1.device)
    args = (q12, t12, s12, pc1, pc2, uv1, uv2, valid, sigma2_1, sigma2_2)
    if not _build.is_cuda(*args, cam1.params, cam2.params):
        return optimize_sim3_plain(*args[:8], cam1, cam2, *args[8:],
                                   iters=iters, huber2=huber2)
    for cam in (cam1, cam2):
        if cam.kind not in KINDS:
            raise ValueError(f"camera kind {cam.kind}: the Sim3 kernel "
                             f"takes {KINDS}")
    N = pc1.shape[0]
    f32 = torch.float32
    for x, name, dtype, shape in (
            (q12, "q12", f32, (4,)), (t12, "t12", f32, (3,)),
            (s12, "s12", f32, ()), (cam1.params, "cam1", f32, (8,)),
            (cam2.params, "cam2", f32, (8,)), (pc1, "pc1", f32, (N, 3)),
            (pc2, "pc2", f32, (N, 3)), (uv1, "uv1", f32, (N, 2)),
            (uv2, "uv2", f32, (N, 2)), (sigma2_1, "sigma2_1", f32, (N,)),
            (sigma2_2, "sigma2_2", f32, (N,)),
            (valid, "valid", torch.bool, (N,))):
        _build.check(x, name, dtype, shape)
    dev = pc1.device
    x = torch.empty(8, dtype=f32, device=dev)               # q, t, s
    inliers = torch.empty(N, dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int64, device=dev)
    order = torch.empty(N, dtype=torch.int32, device=dev)   # scratch
    _build.launch("mam3_sim3_opt", q12.data_ptr(), t12.data_ptr(),
                  s12.data_ptr(), cam1.params.data_ptr(), cam1.kind,
                  cam2.params.data_ptr(), cam2.kind, pc1.data_ptr(),
                  pc2.data_ptr(), uv1.data_ptr(), uv2.data_ptr(),
                  sigma2_1.data_ptr(), sigma2_2.data_ptr(), valid.data_ptr(),
                  N, iters, huber2, order.data_ptr(), x.data_ptr(),
                  inliers.data_ptr(), n_in.data_ptr())
    return x[:4], x[4:7], x[7], inliers, n_in
