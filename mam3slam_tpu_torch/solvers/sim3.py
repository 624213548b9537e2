"""Sim3 estimation: Horn's closed form and batched RANSAC.

Port of ``mam3slam_tpu.solvers.sim3`` (the reference's Sim3Solver; its
Optimizer::OptimizeSim3 is ``ops/cuda_sim3.py``): every RANSAC
hypothesis is one batched Horn solve (a 4x4 ``eigh``) scored by one
fused bidirectional reprojection test.  The hypotheses' 3-point samples
come from ``probe [R, 3]``, uniform draws in [0, 1) that the caller
makes, so a test can hand both packages the same draws.  On a degenerate
sample ``eigh`` may return another eigenvector than LAPACK does in the
reference, so only the chosen Sim3 and its inliers are comparable, never
hypothesis indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie


class Sim3Result(NamedTuple):
    ok: torch.Tensor         # [] bool
    q: torch.Tensor          # [4] rotation 1 <- 2
    t: torch.Tensor          # [3]
    s: torch.Tensor          # [] scale
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] i64


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, w=None,
              fix_scale: bool = False):
    """Closed-form similarity p1 ~= s R p2 + t of point sets [..., N, 3]
    with optional weights [..., N] (Horn's quaternion method).  Returns
    (q [..., 4], t [..., 3], s [...])."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c1 = (p1 * wn[..., None]).sum(-2)
    c2 = (p2 * wn[..., None]).sum(-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    Mm = torch.einsum("...ni,...nj,...n->...ij", q1, q2, wn)
    Sxx, Sxy, Sxz = Mm[..., 0, 0], Mm[..., 0, 1], Mm[..., 0, 2]
    Syx, Syy, Syz = Mm[..., 1, 0], Mm[..., 1, 1], Mm[..., 1, 2]
    Szx, Szy, Szz = Mm[..., 2, 0], Mm[..., 2, 1], Mm[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    q = torch.linalg.eigh(N).eigenvectors[..., :, -1]  # largest eigenvalue
    # Horn's eigenvector rotates set 1 onto set 2; p1 = R p2 is its
    # conjugate
    q = lie.quat_conj(lie.quat_normalize(
        q * torch.where(q[..., :1] < 0, -1.0, 1.0)))
    if fix_scale:
        s = torch.ones(q.shape[:-1], dtype=p1.dtype, device=p1.device)
    else:
        rot_q2 = lie.quat_rotate(q[..., None, :], q2)
        den = torch.clamp(((q2 * q2).sum(-1) * wn).sum(-1), min=1e-12)
        s = torch.clamp(((q1 * rot_q2).sum(-1) * wn).sum(-1) / den,
                        min=1e-6)
    t = c1 - s[..., None] * lie.quat_rotate(q, c2)
    return q, t, s


def _bidirectional_inliers(q, t, s, pc1, pc2, uv1, uv2, cam1, cam2,
                           sigma2_1, sigma2_2, valid, chi2_th):
    """[R, N] inlier masks of hypotheses S12 = (q, t, s) [R, ...]: pc2
    projected through S12 into camera 1 and pc1 through S12^-1 into
    camera 2, both within ``chi2_th`` of the observations."""
    p12 = (s[:, None, None] * lie.quat_rotate(q[:, None, :], pc2[None])
           + t[:, None, :])
    e1 = (((cam_mod.project_ideal(cam1, p12) - uv1[None]) ** 2).sum(-1)
          / sigma2_1[None])
    qi = lie.quat_conj(q)
    si = 1.0 / s
    ti = -si[:, None] * lie.quat_rotate(qi, t)
    p21 = (si[:, None, None] * lie.quat_rotate(qi[:, None, :], pc1[None])
           + ti[:, None, :])
    e2 = (((cam_mod.project_ideal(cam2, p21) - uv2[None]) ** 2).sum(-1)
          / sigma2_2[None])
    return (e1 < chi2_th) & (e2 < chi2_th) & valid[None]


def ransac_sim3(p1, p2, valid, uv1, uv2, cam1: cam_mod.Camera,
                cam2: cam_mod.Camera, q1_cw, t1_cw, q2_cw, t2_cw, probe,
                sigma2_1, sigma2_2, chi2_th: float = 9.21,
                min_inliers: int = 20) -> Sim3Result:
    """Batched RANSAC Sim3 from 3D-3D matches (world points p1 / p2 [N, 3]
    of two maps, their pixels uv1 / uv2 in keyframes 1 / 2 with poses
    (q, t)_cw), with the reference's bidirectional chi2 gate (9.21).
    Estimates S12 between the CAMERA frames; the best hypothesis is
    refined by one weighted Horn solve on its inliers when that loses
    none."""
    pc1 = lie.quat_rotate(q1_cw[None], p1) + t1_cw[None]
    pc2 = lie.quat_rotate(q2_cw[None], p2) + t2_cw[None]
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    n_valid = valid.sum()
    pos = (probe * torch.clamp(n_valid, min=3).to(probe.dtype)).to(
        torch.int64)
    samples = order[pos]                                    # [R, 3]
    qh, th, sh = horn_sim3(pc1[samples], pc2[samples])
    score_args = (pc1, pc2, uv1, uv2, cam1, cam2, sigma2_1, sigma2_2, valid,
                  chi2_th)
    inl = _bidirectional_inliers(qh, th, sh, *score_args)   # [R, N]
    counts = inl.sum(-1)
    best = torch.argmax(counts)

    qr, tr, sr = horn_sim3(pc1[None], pc2[None],
                           inl[best].to(p1.dtype)[None])
    inl_r = _bidirectional_inliers(qr, tr, sr, *score_args)[0]
    better = inl_r.sum() >= counts[best]
    q_f = torch.where(better, qr[0], qh[best])
    t_f = torch.where(better, tr[0], th[best])
    s_f = torch.where(better, sr[0], sh[best])
    inl_f = torch.where(better, inl_r, inl[best])
    n_in = inl_f.sum()
    return Sim3Result(ok=n_in >= min_inliers, q=q_f, t=t_f, s=s_f,
                      inliers=inl_f, n_inliers=n_in)
