"""Pose kernel: motion-only pose optimisation (4 LM rounds) in one launch.

Wrapper of ``csrc/pose.cu`` (replaces the Pallas kernel
``mam3slam_tpu/ops/pallas_pose.py:pose_optimization_pinhole``, and for the
KannalaBrandt8 camera the reference's XLA path, which that kernel does not
cover) and its plain PyTorch version, the XLA path of
``mam3slam_tpu.solvers.ba.pose_optimization``:

  for each of ``rounds`` rounds (Huber delta^2 = 5.991 in rounds 0-1):
    ``iters + 1`` evaluations; each linearises at the current pose, takes
    it as the best pose if its robust cost is lower (lambda x0.5, else
    x4), then steps from the best pose with this linearisation:
    (H + (lambda max(diag H, 1e-6) + 1e-8) I) dx = -g, left-multiplied
    SE3 exp;
  then re-classifies: active = valid & depth > 1e-3 & chi2 <= 5.991.

The pose is carried as a unit quaternion.  Points, pixels, weights and
the camera are fixed.
"""

from __future__ import annotations

import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie

CHI2_MONO = 5.991
KINDS = (cam_mod.PINHOLE, cam_mod.KANNALA_BRANDT8)


def _huber_w(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def pose_optimization_plain(q0, t0, cam_params, kind: int, pts, uv, w, valid,
                            rounds: int = 4, iters: int = 5):
    """Plain PyTorch motion-only BA for one problem: q0 [4], t0 [3],
    cam_params [8], pts [N, 3], uv [N, 2], w [N], valid [N] bool ->
    (q [4], t [3], inlier [N] bool, n_inliers [] int32)."""
    _build.count_plain("pose_opt")
    delta2 = CHI2_MONO
    cam = cam_mod.Camera(cam_params, kind)
    eye6 = torch.eye(6, dtype=torch.float32, device=pts.device)

    def linearize(q, t):
        Xc = lie.quat_rotate(q[None, :], pts) + t[None, :]
        r = cam_mod.project_ideal(cam, Xc) - uv
        dpi = cam_mod.project_jac(cam, Xc)
        Jc = torch.cat([dpi, -dpi @ lie.hat(Xc)], dim=-1)      # [N, 2, 6]
        depth_ok = Xc[:, 2] > 1e-3
        chi2 = w * torch.sum(r * r, dim=-1)
        return r, Jc, chi2, depth_ok

    def lm_rounds(q, t, active, robust):
        bq, bt = q, t
        bcost = torch.tensor(float("inf"), device=pts.device)
        lam = torch.tensor(1e-3, dtype=torch.float32, device=pts.device)
        for _ in range(iters + 1):
            r, Jc, chi2, depth_ok = linearize(q, t)
            rho = torch.where(chi2 <= delta2, chi2,
                              2.0 * torch.sqrt(delta2 * torch.clamp(
                                  chi2, min=1e-12)) - delta2)
            act = active & depth_ok
            cost = torch.sum(torch.where(act, rho, 0.0))
            accept = cost < bcost
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 4.0, max=1e4))
            bq = torch.where(accept, q, bq)
            bt = torch.where(accept, t, bt)
            bcost = torch.where(accept, cost, bcost)
            w_rob = _huber_w(chi2, delta2) if robust else torch.ones_like(chi2)
            we = torch.where(act, w * w_rob, 0.0)
            wJ = Jc * we[:, None, None]
            H = torch.einsum("eik,eij->kj", wJ, Jc)
            g = torch.einsum("eij,ei->j", wJ, r)
            H = H + (lam * torch.clamp(torch.diagonal(H), min=1e-6)
                     + 1e-8) * eye6
            dT = lie.se3_exp(torch.linalg.solve(H, -g))
            q = lie.quat_normalize(lie.quat_mul(dT.q, bq))
            t = lie.quat_rotate(dT.q, bt) + dT.t
        return bq, bt

    q, t = q0, t0
    active = valid
    for rd in range(rounds):
        q, t = lm_rounds(q, t, active, robust=rd < 2)
        _, _, chi2, depth_ok = linearize(q, t)
        active = valid & depth_ok & (chi2 <= delta2)
    return q, t, active, active.to(torch.int32).sum()


def pose_optimization_batched(q0, t0, cam_params, kind: int, pts, uv, w,
                              valid, rounds: int = 4, iters: int = 5):
    """Batched pose optimisation: q0 [B, 4], t0 [B, 3], cam_params [B, 8]
    of camera ``kind`` (PINHOLE projects without distortion, KB8 in the
    full model), pts [B, N, 3], uv [B, N, 2], w [B, N], valid [B, N] bool
    -> (q [B, 4], t [B, 3], inlier [B, N] bool, n_inliers [B] int32).
    CUDA tensors launch ``csrc/pose.cu`` (one block per problem); CPU
    tensors run the plain version per problem."""
    if kind not in KINDS:
        raise ValueError(f"camera kind {kind}: the pose kernel takes {KINDS}")
    args = (q0, t0, cam_params, pts, uv, w, valid)
    if not _build.is_cuda(*args):
        outs = [pose_optimization_plain(*(x[b] for x in args[:3]), kind,
                                        *(x[b] for x in args[3:]),
                                        rounds=rounds, iters=iters)
                for b in range(q0.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    B, N = pts.shape[0], pts.shape[1]
    _build.check(q0, "q0", torch.float32, (B, 4))
    _build.check(t0, "t0", torch.float32, (B, 3))
    _build.check(cam_params, "cam_params", torch.float32, (B, 8))
    _build.check(pts, "pts", torch.float32, (B, N, 3))
    _build.check(uv, "uv", torch.float32, (B, N, 2))
    _build.check(w, "w", torch.float32, (B, N))
    _build.check(valid, "valid", torch.bool, (B, N))
    dev = pts.device
    q = torch.empty((B, 4), dtype=torch.float32, device=dev)
    t = torch.empty((B, 3), dtype=torch.float32, device=dev)
    inlier = torch.empty((B, N), dtype=torch.bool, device=dev)
    n_in = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _build.launch("mam3_pose_opt", q0.data_ptr(), t0.data_ptr(),
                      cam_params.data_ptr(), kind, pts.data_ptr(),
                      uv.data_ptr(), w.data_ptr(), valid.data_ptr(), B, N,
                      rounds, iters, q.data_ptr(), t.data_ptr(),
                      inlier.data_ptr(), n_in.data_ptr())
    return q, t, inlier, n_in
