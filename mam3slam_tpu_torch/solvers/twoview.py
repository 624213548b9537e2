"""Monocular two-view reconstruction: batched H/F RANSAC and cheirality.

Port of ``mam3slam_tpu.solvers.twoview`` (reference
TwoViewReconstruction): every RANSAC hypothesis of H and F is estimated at
once by batched SVDs and scored in one [R, N] reduction, the winning
models are refined on all their inliers, and all 12 motion hypotheses
(4 from E, 8 from H) are triangulated and checked together.

The hypotheses' minimal sets come from ``probe [R, 8]``, uniform draws in
[0, 1) that the caller makes (``SlamSystem`` from its own generator), so a
test can hand both packages the same draws.  SVD signs and the order of
equal singular values may differ from the reference's; the chosen motion
and points do not depend on them.  Inverses use ``inv_ex``: a singular
hypothesis yields non-finite scores instead of an error, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_CAP = 5.991  # both models scored with the same cap (reference)


class TwoViewResult(NamedTuple):
    ok: torch.Tensor               # [] bool
    R21: torch.Tensor              # [3, 3] rotation frame1 -> frame2
    t21: torch.Tensor              # [3] unit-norm translation
    points3d: torch.Tensor         # [N, 3] in frame-1 coords
    is_triangulated: torch.Tensor  # [N] bool
    used_homography: torch.Tensor  # [] bool


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A)[0]


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of each
    [..., m, n] matrix (the full V when m < n)."""
    _, _, vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return vt[..., -1, :]


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalisation (mean 0, mean abs deviation 1) over valid
    points; returns (normalised uv, 3x3 T)."""
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    md = (torch.abs(uv - mean) * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(md, min=1e-8)
    T = torch.eye(3, dtype=uv.dtype, device=uv.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (uv - mean) * s, T


def _dlt_F(p1, p2, w=None):
    """8-point fundamental matrices from [S, P, 2] normalised samples
    (optional row weights [S, P]), rank 2 enforced -> [S, 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    if w is not None:
        A = A * w[..., None]
    F = _null_vector(A).reshape(-1, 3, 3)
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., :, None] * vt)


def _dlt_H(p1, p2, w=None):
    """Normalised DLT homographies from [S, P, 2] samples -> [S, 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    return _null_vector(A).reshape(-1, 3, 3)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)


def _score(chi2_1, chi2_2, th, valid):
    """Reference scoring: capped chi2 credit per direction; an inlier
    passes both."""
    in1 = (chi2_1 < th) & valid[None, :]
    in2 = (chi2_2 < th) & valid[None, :]
    score = (torch.where(in1, SCORE_CAP - chi2_1, 0.0)
             + torch.where(in2, SCORE_CAP - chi2_2, 0.0))
    return score.sum(-1), in1 & in2


def _score_F(F, uv1, uv2, valid, sigma: float):
    """Symmetric epipolar transfer score (reference CheckFundamental)."""
    x1, x2 = _homog(uv1), _homog(uv2)
    inv_s2 = 1.0 / (sigma * sigma)
    l2 = torch.einsum("sij,nj->sni", F, x1)
    num2 = torch.einsum("ni,sni->sn", x2, l2)
    chi2_1 = (num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2,
                                        min=1e-12)) * inv_s2
    l1 = torch.einsum("sji,nj->sni", F, x2)
    num1 = torch.einsum("ni,sni->sn", x1, l1)
    chi2_2 = (num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2,
                                        min=1e-12)) * inv_s2
    return _score(chi2_1, chi2_2, CHI2_F, valid)


def _dehomog(p):
    z = p[..., 2:3]
    return p[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)


def _score_H(H, uv1, uv2, valid, sigma: float):
    """Symmetric transfer score for H (reference CheckHomography)."""
    x1, x2 = _homog(uv1), _homog(uv2)
    inv_s2 = 1.0 / (sigma * sigma)
    p12 = _dehomog(torch.einsum("sij,nj->sni", H, x1))
    chi2_1 = ((uv2[None] - p12) ** 2).sum(-1) * inv_s2
    p21 = _dehomog(torch.einsum("sij,nj->sni", _inv(H), x2))
    chi2_2 = ((uv1[None] - p21) ** 2).sum(-1) * inv_s2
    return _score(chi2_1, chi2_2, CHI2_H, valid)


def triangulate_dlt(P1, P2, uv1, uv2) -> torch.Tensor:
    """Batched DLT triangulation: P1, P2 [..., 3, 4] projection matrices,
    uv1, uv2 [..., 2] -> [..., 3] points; NaN where an input is not
    finite (a KB8 pixel whose undistortion diverged: the reference's SVD
    returns NaN there, torch's refuses the whole batch)."""
    A = torch.stack([uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
                     uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
                     uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
                     uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)
    finite = torch.isfinite(A).all(-1).all(-1)
    X = _null_vector(torch.where(finite[..., None, None], A, 0.0))
    w = X[..., 3:4]
    X = X[..., :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return torch.where(finite[..., None], X, float("nan"))


def _check_rt(R, t, uv1, uv2, valid, K, sigma: float):
    """Cheirality + reprojection check of H motion hypotheses at once
    (reference CheckRT): R [H, 3, 3], t [H, 3], valid [H, N].
    Returns (n_good [H], parallax_deg [H], points [H, N, 3], good [H, N])."""
    Hn, N = valid.shape
    th2 = 4.0 * sigma * sigma
    P1 = torch.cat([K, torch.zeros_like(K[:, :1])], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)          # [H, 3, 4]
    X = triangulate_dlt(P1.expand(Hn, N, 3, 4), P2[:, None].expand(
        Hn, N, 3, 4), uv1.expand(Hn, N, 2), uv2.expand(Hn, N, 2))
    finite = torch.isfinite(X).all(-1)
    X = torch.where(finite[..., None], X, 0.0)

    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]      # [H, 3]
    n2 = X - C2[:, None]
    d1 = torch.linalg.vector_norm(X, dim=-1)
    d2 = torch.linalg.vector_norm(n2, dim=-1)
    cos_par = (X * n2).sum(-1) / torch.clamp(d1 * d2, min=1e-12)
    X2 = X @ R.transpose(-1, -2) + t[:, None]
    e1 = ((_dehomog(X @ K.T) - uv1) ** 2).sum(-1)
    e2 = ((_dehomog(X2 @ K.T) - uv2) ** 2).sum(-1)
    good = (valid & finite & (cos_par < 0.99998) & (X[..., 2] > 0)
            & (X2[..., 2] > 0) & (e1 < th2) & (e2 < th2))
    n_good = good.sum(-1)

    # parallax statistic: the min(50, n_good - 1)-th largest angle
    par_deg = torch.rad2deg(torch.arccos(torch.clamp(cos_par, -1.0, 1.0)))
    par_sorted = torch.sort(torch.where(good, par_deg, 0.0), dim=-1,
                            descending=True).values
    k = torch.clamp(torch.clamp(n_good - 1, min=0), max=50)
    parallax = torch.take_along_dim(par_sorted, k[:, None], -1)[:, 0]
    return n_good, parallax, X, good


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _decompose_E(E):
    """E -> 4 (R, t) hypotheses."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2] / torch.clamp(torch.linalg.vector_norm(u[:, 2]), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H, K):
    """Faugeras-Lustman decomposition of a homography -> 8 (R, t)."""
    u, d, vt = torch.linalg.svd(_inv(K) @ H @ K)
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    x1s = (1.0, 1.0, -1.0, -1.0)
    x3s = (1.0, -1.0, 1.0, -1.0)
    sign_s = (1.0, -1.0, -1.0, 1.0)
    cross = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                   min=0.0))
    zero = torch.zeros_like(d1)
    Rs, ts = [], []
    # case d' = d2
    stheta = cross / torch.clamp((d1 + d3) * d2, min=1e-12)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for i in range(4):
        st = sign_s[i] * stheta
        Rp = torch.stack([torch.stack([ctheta, zero, -st]),
                          torch.stack([zero, zero + 1.0, zero]),
                          torch.stack([st, zero, ctheta])])
        Rs.append(s * u @ Rp @ vt)
        tp = torch.stack([x1s[i] * aux1, zero, -x3s[i] * aux3]) * (d1 - d3)
        ts.append(u @ tp)
    # case d' = -d2
    sphi = cross / torch.clamp((d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for i in range(4):
        sp = sign_s[i] * sphi
        Rp = torch.stack([torch.stack([cphi, zero, sp]),
                          torch.stack([zero, zero - 1.0, zero]),
                          torch.stack([sp, zero, -cphi])])
        Rs.append(s * u @ Rp @ vt)
        tp = torch.stack([x1s[i] * aux1, zero, x3s[i] * aux3]) * (d1 + d3)
        ts.append(u @ tp)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return torch.stack(Rs), ts


def reconstruct_two_views(uv1, uv2, valid, K, probe, sigma: float = 1.0,
                          min_triangulated: int = 50,
                          min_parallax: float = 1.0) -> TwoViewResult:
    """Monocular initialisation from matched pixel pairs (row i of uv1
    matches row i of uv2; ``valid [N]``; ``K [3, 3]`` ideal intrinsics).

    ``probe [R, 8]`` holds the uniform draws that pick the R minimal sets
    among the valid matches.  H and F are RANSAC'd together, the winner
    chosen by score ratio RH > 0.5, and the motion recovered under the
    reference's cheirality, parallax and uniqueness gates, with a gated
    fallback to the other model."""
    n_valid = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    pos = (probe * torch.clamp(n_valid, min=8).to(probe.dtype)).to(
        torch.int64)
    samples = order[pos]                                    # [R, 8]

    uvn1, T1 = _normalize(uv1, valid)
    uvn2, T2 = _normalize(uv2, valid)
    p1, p2 = uvn1[samples], uvn2[samples]
    F = T2.T @ _dlt_F(p1, p2) @ T1
    H = _inv(T2) @ _dlt_H(p1, p2) @ T1
    scores_F, inliers_F = _score_F(F, uv1, uv2, valid, sigma)
    scores_H, inliers_H = _score_H(H, uv1, uv2, valid, sigma)
    iF, iH = torch.argmax(scores_F), torch.argmax(scores_H)
    SF, SH = scores_F[iF], scores_H[iH]
    inF, inH = inliers_F[iF], inliers_H[iH]

    # all-inlier refinement of the winners, kept when it does not degrade
    w = uvn1.dtype
    bestF = T2.T @ _dlt_F(uvn1[None], uvn2[None], inF[None].to(w))[0] @ T1
    bestH = _inv(T2) @ _dlt_H(uvn1[None], uvn2[None], inH[None].to(w))[0] @ T1
    sF2, inF2 = _score_F(bestF[None], uv1, uv2, valid, sigma)
    sH2, inH2 = _score_H(bestH[None], uv1, uv2, valid, sigma)
    use_rF = sF2[0] >= SF
    bestF = torch.where(use_rF, bestF, F[iF])
    inF = torch.where(use_rF, inF2[0], inF)
    SF = torch.maximum(sF2[0], SF)
    use_rH = sH2[0] >= SH
    bestH = torch.where(use_rH, bestH, H[iH])
    inH = torch.where(use_rH, inH2[0], inH)
    SH = torch.maximum(sH2[0], SH)
    prefer_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.5

    # 4 motions from E, 8 from H, each checked against its model's inliers
    Rs_E, ts_E = _decompose_E(K.T @ bestF @ K)
    Rs_H, ts_H = _decompose_H(bestH, K)
    Rs = torch.cat([Rs_E, Rs_H])
    ts = torch.cat([ts_E, ts_H])
    from_H = torch.arange(12, device=uv1.device) >= 4
    hyp_valid = torch.where(from_H[:, None], inH[None, :], inF[None, :])
    n_good, parallax, X, good = _check_rt(Rs, ts, uv1, uv2, hyp_valid, K,
                                          sigma)

    def group_gate(is_h: bool):
        """A unique clear winner that explains >= 90% of the model's
        inliers with enough parallax (reference ReconstructF/H)."""
        gn = torch.where(from_H == is_h, n_good, -1)
        max_good = gn.max()
        best = torch.argmax(gn)
        n_similar = (gn > 0.7 * max_good).sum()
        n_inl = (inH if is_h else inF).sum()
        min_good = torch.clamp((0.9 * n_inl).to(torch.int64),
                               min=min_triangulated)
        ok = ((max_good >= min_good) & (n_similar == 1)
              & (parallax[best] > min_parallax))
        return ok, best

    ok_F, best_F = group_gate(False)
    ok_H, best_H = group_gate(True)
    primary_ok = torch.where(prefer_H, ok_H, ok_F)
    use_H = torch.where(primary_ok, prefer_H, ok_H)
    best = torch.where(use_H, best_H, best_F)
    return TwoViewResult(
        ok=primary_ok | ok_F | ok_H, R21=Rs[best], t21=ts[best],
        points3d=X[best], is_triangulated=good[best] & (n_good[best] > 0),
        used_homography=use_H)
