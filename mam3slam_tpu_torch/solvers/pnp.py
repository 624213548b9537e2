"""Absolute pose from 2D-3D matches (PnP) with batched RANSAC.

Port of ``mam3slam_tpu.solvers.pnp`` (the reference's MLPnP, used by
relocalization): hypotheses from a batched DLT resection over 6-point
samples, the best polished by Gauss-Newton in the tangent plane of each
observed bearing under the 2x2 information propagated from pixel noise.
The samples come from ``probe [R, 6]``, uniform draws in [0, 1) that the
caller makes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.solvers.pgo import batched_jacfwd


class PnPResult(NamedTuple):
    ok: torch.Tensor         # [] bool
    q: torch.Tensor          # [4] T_cw
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] i32


def _dlt_pnp(X: torch.Tensor, xn: torch.Tensor):
    """Batched DLT resection: world points X [S, M, 3] and normalised
    image coordinates xn [S, M, 2] -> (R [S, 3, 3], t [S, 3]).  The sign
    of the null vector cancels out of R and t."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)   # [S, M, 4]
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -xn[..., 0:1] * Xh], dim=-1),
                   torch.cat([z, Xh, -xn[..., 1:2] * Xh], dim=-1)], dim=-2)
    P = torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :].reshape(
        -1, 3, 4)
    u, sv, vt2 = torch.linalg.svd(P[:, :, :3])
    # the nearest rotation to P[:, :, :3] / lambda is sign(lambda) u vt
    sgn = torch.sign(torch.linalg.det(u @ vt2))
    sgn = torch.where(sgn == 0, 1.0, sgn)
    R = sgn[:, None, None] * (u @ vt2)
    lam = sgn * sv.mean(-1)
    t = P[:, :, 3] / torch.where(torch.abs(lam) < 1e-12, 1e-12, lam)[:, None]
    return R, t


def _bearing_tangent_basis(v: torch.Tensor):
    """Orthonormal (r, s) spanning the tangent plane of unit bearings
    v [N, 3]."""
    ref = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], dtype=v.dtype,
                       device=v.device)
    ref = torch.where(torch.abs(v[:, 2:3]) < 0.9, ref[0], ref[1])
    r = torch.linalg.cross(v, ref, dim=-1)
    r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                        min=1e-12)
    return r, torch.linalg.cross(v, r, dim=-1)


def bearing_information(cam: cam_mod.Camera, uv: torch.Tensor,
                        sigma2_px: torch.Tensor):
    """Bearings v [N, 3], their tangent bases r, s and the 2x2 tangent
    information W [N, 2, 2] = (B J sigma2 J^T B^T)^-1, J = d unit ray /
    d uv by forward mode through ``cameras.unproject``."""
    def unit_ray(x):
        ray = cam_mod.unproject(cam, x)
        return ray / torch.clamp(torch.linalg.vector_norm(
            ray, dim=-1, keepdim=True), min=1e-12)

    v, J = batched_jacfwd(unit_ray, uv)                     # J [N, 3, 2]
    r, s = _bearing_tangent_basis(v)
    JB = torch.stack([r, s], dim=1) @ J                     # [N, 2, 2]
    Sigma = JB @ JB.transpose(-1, -2) * sigma2_px[:, None, None]
    a, b = Sigma[:, 0, 0], Sigma[:, 0, 1]
    c, d = Sigma[:, 1, 0], Sigma[:, 1, 1]
    det = torch.clamp(a * d - b * c, min=1e-18)
    W = torch.stack([torch.stack([d, -b], -1),
                     torch.stack([-c, a], -1)], -2) / det[:, None, None]
    return v, r, s, W


def ml_refine(pts, uv, weights_ok, cam: cam_mod.Camera, q0, t0, sigma2_px,
              iters: int = 8):
    """Gauss-Newton on the MLPnP objective e_i = B_i^T normalize(R p_i +
    t) under the propagated information W_i, over the masked points."""
    _, r, s, W = bearing_information(cam, uv, sigma2_px)
    B = torch.stack([r, s], dim=1)                          # [N, 2, 3]
    wmask = weights_ok.to(pts.dtype)
    eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device)
    eye6 = torch.eye(6, dtype=pts.dtype, device=pts.device)
    q, t = q0, t0
    for _ in range(iters):
        Xc = lie.quat_rotate(q[None], pts) + t[None]
        nrm = torch.clamp(torch.linalg.vector_norm(Xc, dim=-1, keepdim=True),
                          min=1e-12)
        u = Xc / nrm
        e = torch.einsum("nij,nj->ni", B, u)                # [N, 2]
        P = (eye3[None] - u[:, :, None] * u[:, None, :]) / nrm[:, :, None]
        Jx = torch.cat([eye3.expand(pts.shape[0], 3, 3), -lie.hat(Xc)],
                       dim=-1)                              # [N, 3, 6]
        J = B @ P @ Jx                                      # [N, 2, 6]
        WJ = W @ J * wmask[:, None, None]
        H = torch.einsum("nia,nib->ab", WJ, J)
        g = torch.einsum("nia,ni->a", WJ, e)
        dx = -torch.linalg.solve_ex(H + 1e-8 * eye6, g)[0]
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        dT = lie.se3_exp(dx)
        q = lie.quat_normalize(lie.quat_mul(dT.q, q))
        t = lie.quat_rotate(dT.q, t) + dT.t
    return q, t


def ransac_pnp(pts: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               cam: cam_mod.Camera, probe: torch.Tensor,
               inv_sigma2: torch.Tensor, chi2_th: float = 5.991,
               min_inliers: int = 15) -> PnPResult:
    """RANSAC DLT-PnP of world points pts [N, 3] seen at pixels uv [N, 2];
    ``probe [R, m]`` picks R samples of m points among the valid ones.
    The winner's MLPnP polish is kept when it loses no inlier."""
    m = probe.shape[1]
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    n_valid = valid.sum()
    pos = (probe * torch.clamp(n_valid, min=m).to(probe.dtype)).to(
        torch.int64)
    samples = order[pos]                                    # [R, m]
    rays = cam_mod.unproject(cam, uv)[:, :2]
    R, t = _dlt_pnp(pts[samples], rays[samples])

    Xc = torch.einsum("sij,nj->sni", R, pts) + t[:, None, :]
    chi2 = ((cam_mod.project_ideal(cam, Xc) - uv[None]) ** 2).sum(-1) \
        * inv_sigma2[None]
    inl = (chi2 < chi2_th) & (Xc[..., 2] > 0.01) & valid[None]
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    q = lie.quat_from_matrix(R[best])
    tb = t[best]
    q_r, t_r = ml_refine(pts, uv, inl[best], cam, q, tb,
                         1.0 / torch.clamp(inv_sigma2, min=1e-9))
    Xc_r = lie.quat_rotate(q_r[None], pts) + t_r[None]
    chi_r = ((cam_mod.project_ideal(cam, Xc_r) - uv) ** 2).sum(-1) \
        * inv_sigma2
    inl_r = (chi_r < chi2_th) & (Xc_r[..., 2] > 0.01) & valid
    better = inl_r.sum() >= counts[best]
    n_in = torch.maximum(inl_r.sum(), counts[best])
    return PnPResult(ok=n_in >= min_inliers,
                     q=torch.where(better, q_r, q),
                     t=torch.where(better, t_r, tb),
                     inliers=torch.where(better, inl_r, inl[best]),
                     n_inliers=n_in.to(torch.int32))
