"""Distributed window bundle adjustment over a ``DeviceMesh`` axis.

Port of ``mam3slam_tpu.parallel.dist_window_ba``.  Every rank passes the
whole (replicated) ``WindowProblem`` and gets the whole result; inside,
each takes its shard along ``mesh[axis]`` and the ranks meet in
collectives over that axis (``parallel/mesh.py``).  Three solvers:

* ``dist_run_window_ba``: the implicit-Schur PCG with points
  owner-partitioned and the camera-major grid row-sharded (camera state
  replicated); each CG product gathers the eliminated point increments
  ``[Pw, 3]`` and the partial products ``[Kc, 6]``.
* ``dist_run_window_ba_dense``: points owner-partitioned, the camera
  block replicated; one packed all-reduce per LM iteration (the Schur
  coupling ``(6 Kc)^2``, the camera blocks, the RHS and the cost), then
  the same reduced system is factored on every rank.
* ``dist_run_window_ba_psum``: points dealt round-robin, each rank with
  its own camera-major gather grid over its edges; one packed [Kc, 54]
  all-reduce per LM iteration and one [Kc, 6] all-reduce per CG product.

``dist_solve_window_ba`` takes the dense solver up to ``dense_free_cap``
free cameras and the psum-CG one beyond.  ``dist_global_ba`` is the loop
server's global BA on a mesh (``ServerConfig.gba_mesh``): the server's
rank sends the problem to the other ranks, which wait in ``serve``, and
all solve it together.  The point-major linearisation of a shard is
``ba_window.pm_linearize_all`` (the reference keeps a private copy).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.parallel import mesh as M
from mam3slam_tpu_torch.slam import steps
from mam3slam_tpu_torch.solvers import ba_window as bw
from mam3slam_tpu_torch.solvers.ba import _damp, _pcg

CHI2 = bw.CHI2_MONO
CUDA = torch.device("cuda")
_CAM_ROWS = ("cam_idx", "cam_valid", "cam_q", "cam_t", "cam_params",
             "cm_uv", "cm_w", "cm_pt", "cm_mslot", "cm_valid")
_PT_ROWS = ("pt_idx", "pt_valid", "pts", "pm_kf", "pm_feat", "pm_cslot",
            "pm_uv", "pm_w", "pm_valid", "pm_q0", "pm_t0", "pm_params0")


# ---------------------------------------------------------------------------
# edge list -> WindowProblem (host numpy, for callers holding a flat
# observation list rather than a MapState)
# ---------------------------------------------------------------------------

def window_problem_from_edges(cam_q, cam_t, cam_params, pts, obs_cam,
                              obs_pt, obs_uv, obs_w, cam_free, pt_free,
                              max_obs: int = 24, feat_cap: int = None,
                              compact_free: bool = False,
                              device=CUDA) -> bw.WindowProblem:
    """Group a flat observation list into the two-view layout, on
    ``device``.  By default every camera keeps its index (fixed ones are
    not in ``cam_free``); with ``compact_free`` the camera block holds only
    the free cameras and fixed observers appear only through the
    point-major pose snapshots (a smaller reduced system)."""
    def host(x, dtype=None):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(x, dtype)

    cam_q, cam_t = host(cam_q, np.float32), host(cam_t, np.float32)
    cam_params, pts = host(cam_params, np.float32), host(pts, np.float32)
    oc, op = host(obs_cam), host(obs_pt)
    ouv, ow = host(obs_uv, np.float32), host(obs_w, np.float32)
    cam_free, pt_free = host(cam_free), host(pt_free)
    K, Pn, E = cam_q.shape[0], pts.shape[0], oc.shape[0]

    if compact_free:
        rows = np.flatnonzero(cam_free)
        slot_of = np.full(K, -1, np.int32)
        slot_of[rows] = np.arange(len(rows), dtype=np.int32)
    else:
        rows = np.arange(K)
        slot_of = np.where(cam_free, np.arange(K, dtype=np.int32),
                           -1).astype(np.int32)
    Kr = len(rows)
    in_cm = slot_of[oc] >= 0 if compact_free else np.ones(E, bool)

    # per-camera-row feature lists
    F = feat_cap or max(1, int(np.bincount(
        oc[in_cm] if compact_free else oc, minlength=K).max()))
    cm_pt = np.full((Kr, F), -1, np.int32)
    cm_uv = np.zeros((Kr, F, 2), np.float32)
    cm_w = np.ones((Kr, F), np.float32)
    feat_of_edge = np.zeros(E, np.int32)
    fill = np.zeros(Kr, np.int32)
    for e in np.argsort(oc, kind="stable"):
        s = slot_of[oc[e]] if compact_free else oc[e]
        if s < 0 or fill[s] >= F:
            continue
        f = fill[s]
        cm_pt[s, f], cm_uv[s, f], cm_w[s, f] = op[e], ouv[e], ow[e]
        feat_of_edge[e] = f
        fill[s] = f + 1

    # per-point observation lists
    pm_kf = np.full((Pn, max_obs), -1, np.int32)
    pm_feat = np.full((Pn, max_obs), -1, np.int32)
    pm_uv = np.zeros((Pn, max_obs, 2), np.float32)
    pm_w = np.ones((Pn, max_obs), np.float32)
    mslot_of_edge = np.zeros(E, np.int32)
    pfill = np.zeros(Pn, np.int32)
    for e in np.argsort(op, kind="stable"):
        p = op[e]
        m = pfill[p]
        if m >= max_obs:
            continue
        pm_kf[p, m], pm_feat[p, m] = oc[e], feat_of_edge[e]
        pm_uv[p, m], pm_w[p, m] = ouv[e], ow[e]
        mslot_of_edge[e] = m
        pfill[p] = m + 1
    pm_valid = pm_kf >= 0
    pm_cslot = np.where(pm_valid, slot_of[np.clip(pm_kf, 0, None)],
                        -1).astype(np.int32)

    # the camera-major <-> point-major bridge
    cm_mslot = np.zeros((Kr, F), np.int32)
    cm_valid = np.zeros((Kr, F), bool)
    for e in range(E):
        s = slot_of[oc[e]] if compact_free else oc[e]
        if s < 0:
            continue
        f = feat_of_edge[e]
        if cm_pt[s, f] == op[e]:
            cm_mslot[s, f] = mslot_of_edge[e]
            cm_valid[s, f] = mslot_of_edge[e] < max_obs and \
                pm_kf[op[e], mslot_of_edge[e]] == oc[e]
    cm_valid &= cam_free[rows][:, None] & (cm_pt >= 0)

    kfc = np.clip(pm_kf, 0, None)
    fields = dict(
        cam_idx=np.where(cam_free[rows], rows, -1).astype(np.int32),
        cam_valid=cam_free[rows].astype(bool), cam_q=cam_q[rows],
        cam_t=cam_t[rows], cam_params=cam_params[rows],
        cm_uv=cm_uv, cm_w=cm_w, cm_pt=cm_pt, cm_mslot=cm_mslot,
        cm_valid=cm_valid, pt_idx=np.arange(Pn, dtype=np.int32),
        pt_valid=pt_free.astype(bool), pts=pts, pm_kf=pm_kf,
        pm_feat=pm_feat, pm_cslot=pm_cslot, pm_uv=pm_uv, pm_w=pm_w,
        pm_valid=pm_valid, pm_q0=cam_q[kfc], pm_t0=cam_t[kfc],
        pm_params0=cam_params[kfc], cam_slot_of=slot_of,
        pt_slot_of=np.arange(Pn, dtype=np.int32))
    return bw.WindowProblem(**{k: torch.from_numpy(np.ascontiguousarray(v))
                               .to(device) for k, v in fields.items()})


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-x.shape[0]) % n
    if pad == 0:
        return x
    return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                     device=x.device)])


def pad_problem(prob: bw.WindowProblem, n: int) -> bw.WindowProblem:
    """Camera and point axes padded to multiples of ``n`` with invalid,
    inert rows."""
    d = prob._asdict()
    for k in _CAM_ROWS + _PT_ROWS:
        d[k] = _pad_rows(d[k], n)
    d["cam_idx"] = torch.where(d["cam_valid"], d["cam_idx"], -1)
    d["pt_idx"] = torch.where(d["pt_valid"], d["pt_idx"], -1)
    return bw.WindowProblem(**d)


def _point_shard(prob: bw.WindowProblem, mesh, axis: str,
                 cams: bool = False) -> bw.WindowProblem:
    """This rank's block of the point rows (and with ``cams`` of the
    camera-major rows too); the rest replicated."""
    keys = _PT_ROWS + (_CAM_ROWS if cams else ())
    return prob._replace(**{k: M.shard_rows(getattr(prob, k), mesh, axis)
                            for k in keys if k not in ("cam_q", "cam_t")})


# ---------------------------------------------------------------------------
# camera-sharded implicit-Schur PCG
# ---------------------------------------------------------------------------

def dist_run_window_ba(prob: bw.WindowProblem, mesh, kind: int,
                       axis: str = "shard", iters: int = 10,
                       cg_iters: int = 30, huber_delta2: float = CHI2,
                       robust: bool = True,
                       chi2_th: float = CHI2) -> bw.WindowResult:
    """Owner-partitioned LM over ``mesh[axis]``: each rank eliminates its
    points once and reduces its rows of the camera-major grid; the [Kc, 6]
    camera vectors of the PCG are replicated.  Needs the camera-major
    view.  ``pts`` and ``pm_inlier`` cover the padded rows."""
    n = M.axis_size(mesh, axis)
    prob = pad_problem(prob, n)
    Kn = prob.cam_q.shape[0] // n
    my = M.axis_rank(mesh, axis)
    sl = slice(my * Kn, (my + 1) * Kn)
    lp = _point_shard(prob, mesh, axis, cams=True)
    csl = torch.clamp(lp.pm_cslot, min=0).long()
    ptc = torch.clamp(lp.cm_pt, min=0).long()

    def agather(x):
        return M.all_gather_rows(x, mesh, axis)

    def lm_iter(cam_q, cam_t, pts_local, lam):
        pts_full = agather(pts_local)
        # point-owner side: the elimination blocks
        r_pm, Jp_pm, Jc_pm, dok_pm = bw.pm_linearize_all(
            lp, kind, cam_q, cam_t, pts_local)
        chi2 = lp.pm_w * (r_pm * r_pm).sum(-1)
        active = lp.pm_valid & dok_pm
        cost_here = M.psum(torch.where(active, bw._rho(chi2, huber_delta2),
                                       0.0).sum(), mesh, axis)
        w_rob = bw._huber_w(chi2, huber_delta2) if robust \
            else torch.ones_like(chi2)
        w_pm = torch.where(active, lp.pm_w * w_rob, 0.0)
        wJp = Jp_pm * w_pm[..., None, None]
        g_p = torch.einsum("pmij,pmi->pj", wJp, r_pm)
        Hpp = torch.einsum("pmia,pmib->pab", wJp, Jp_pm)
        W_pm = torch.einsum("pmia,pmib->pmab", Jc_pm * w_pm[..., None, None],
                            Jp_pm)
        Hpp_inv = bw._spd_inv3(_damp(Hpp, lp.pt_valid, lam))
        Hpp_inv_full = agather(Hpp_inv)

        # camera-owner side: this rank's rows of the reduced system
        r_cm, Jc_cm, Jp_cm, dok_cm = bw._cm_linearize(
            lp, kind, cam_q[sl], cam_t[sl], pts_full)
        chi2_cm = lp.cm_w * (r_cm * r_cm).sum(-1)
        w_rob_cm = bw._huber_w(chi2_cm, huber_delta2) if robust \
            else torch.ones_like(chi2_cm)
        w_cm = torch.where(lp.cm_valid & dok_cm, lp.cm_w * w_rob_cm, 0.0)
        wJc = Jc_cm * w_cm[..., None, None]
        g_c_n = torch.einsum("kfij,kfi->kj", wJc, r_cm)
        Hcc_l_n = _damp(torch.einsum("kfia,kfib->kab", wJc, Jc_cm),
                        lp.cam_valid, lam)
        W_cm = torch.einsum("kfia,kfib->kfab", wJc, Jp_cm)
        WHW = torch.einsum("kfab,kfbc,kfdc->kad", W_cm, Hpp_inv_full[ptc],
                           W_cm)
        M_inv_n = bw._spd_inv6(Hcc_l_n - WHW)

        z0_full = agather(torch.einsum("pab,pb->pa", Hpp_inv, g_p))
        b = agather(-g_c_n + torch.einsum("kfab,kfb->ka", W_cm,
                                          z0_full[ptc]))

        def S_mv(v):
            u = torch.einsum("pmab,pma->pb", W_pm, v[csl])
            z_full = agather(torch.einsum("pab,pb->pa", Hpp_inv, u))
            back = torch.einsum("kfab,kfb->ka", W_cm, z_full[ptc])
            return agather(torch.einsum("kab,kb->ka", Hcc_l_n, v[sl]) - back)

        def precond(v):
            return agather(torch.einsum("kab,kb->ka", M_inv_n, v[sl]))

        x = _pcg(S_mv, precond, b, cg_iters)
        dx_c = torch.where(prob.cam_valid[:, None], x, 0.0)
        u = torch.einsum("pmab,pma->pb", W_pm, dx_c[csl])
        dx_p = torch.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
        dx_p = torch.where(lp.pt_valid[:, None], dx_p, 0.0)
        dT = lie.se3_exp(dx_c)
        return (lie.quat_normalize(lie.quat_mul(dT.q, cam_q)),
                lie.quat_rotate(dT.q, cam_t) + dT.t, pts_local + dx_p,
                cost_here)

    bq, bt, bp, bcost = bw._lm_loop(lm_iter, prob.cam_q, prob.cam_t, lp.pts,
                                    iters, 1e-4)
    r, _, _, dok = bw.pm_linearize_all(lp, kind, bq, bt, bp)
    chi2 = lp.pm_w * (r * r).sum(-1)
    inlier = lp.pm_valid & dok & (chi2 < chi2_th)
    return bw.WindowResult(cam_q=bq, cam_t=bt, pts=agather(bp),
                           pm_inlier=agather(inlier), cost=bcost)


# ---------------------------------------------------------------------------
# dense reduced camera system: one packed all-reduce per LM iteration
# ---------------------------------------------------------------------------

def dist_run_window_ba_dense(prob: bw.WindowProblem, mesh, kind: int,
                             axis: str = "shard", iters: int = 10,
                             huber_delta2: float = CHI2,
                             robust: bool = True,
                             chi2_th: float = CHI2) -> bw.WindowResult:
    """Distributed ``run_window_ba_dense``: each rank linearises and
    eliminates its points and forms its part of the reduced camera system;
    one all-reduce of the packed parts per LM iteration, then every rank
    factors the same ``[6 Kc, 6 Kc]`` system and back-substitutes its
    points.  ``pts`` and ``pm_inlier`` cover the padded rows."""
    n = M.axis_size(mesh, axis)
    prob = pad_problem(prob, n)
    lp = _point_shard(prob, mesh, axis)
    c = bw._flatten_consts(lp)
    group = M.axis_group(mesh, axis)
    bq, bt, bp, bcost = bw._lm_loop(
        lambda q, t, p, lam: bw._lm_iteration_dense(
            lp, c, kind, q, t, p, lam, c.valid, huber_delta2, robust,
            group), lp.cam_q, lp.cam_t, lp.pts, iters, 1e-4)
    inlier = bw._soa_inliers(c, kind, bq, bt, bp, *lp.pm_uv.shape[:2],
                             chi2_th)
    return bw.WindowResult(cam_q=bq, cam_t=bt,
                           pts=M.all_gather_rows(bp, mesh, axis),
                           pm_inlier=M.all_gather_rows(inlier, mesh, axis),
                           cost=bcost)


# ---------------------------------------------------------------------------
# owner-partitioned implicit-Schur PCG: one [Kc, 6] all-reduce per product
# ---------------------------------------------------------------------------

class PsumShardProblem(NamedTuple):
    """Rank-stacked window problem for ``dist_run_window_ba_psum``: the
    camera block replicated, the point shards stacked along dim 0 in rank
    order (rank d owns rows [d Pl, (d + 1) Pl)), and each rank's local
    camera-major gather grid ``cm_src`` [n Kc, F_l]: (camera, slot) ->
    flat local edge index (p_loc M + m), or -1."""

    cam_q: torch.Tensor        # [Kc, 4]
    cam_t: torch.Tensor        # [Kc, 3]
    cam_params: torch.Tensor   # [Kc, 8]
    cam_valid: torch.Tensor    # [Kc]
    pts: torch.Tensor          # [n Pl, 3]
    pt_valid: torch.Tensor     # [n Pl]
    pm_cslot: torch.Tensor     # [n Pl, M]
    pm_uv: torch.Tensor        # [n Pl, M, 2]
    pm_w: torch.Tensor         # [n Pl, M]
    pm_valid: torch.Tensor     # [n Pl, M]
    pm_q0: torch.Tensor        # [n Pl, M, 4]
    pm_t0: torch.Tensor        # [n Pl, M, 3]
    pm_params0: torch.Tensor   # [n Pl, M, 8]
    cm_src: torch.Tensor       # [n Kc, F_l]


def shard_problem_for_psum(prob: bw.WindowProblem, n: int):
    """Host partition of a ``WindowProblem`` for ``n`` ranks: points dealt
    round-robin (rank d owns the original points d::n), each rank's
    free-camera edges grouped by camera into its [Kc, F_l] grid in edge
    order.  Returns (PsumShardProblem, inv_perm): ``inv_perm`` maps the
    stacked point rows back to the original order."""
    Pw, M_ = prob.pm_uv.shape[:2]
    Kc = prob.cam_q.shape[0]
    Pl = -(-Pw // n)
    dev = prob.pts.device
    perm = np.argsort(np.arange(Pw) % n, kind="stable").astype(np.int32)

    def take(x):
        a = x.cpu().numpy()
        out = np.zeros((n * Pl,) + a.shape[1:], a.dtype)
        out[:Pw] = a[perm]
        return out

    pm_cslot, pm_valid = take(prob.pm_cslot), take(prob.pm_valid)
    p_idx, m_idx = np.nonzero(pm_valid & (pm_cslot >= 0))
    key = (p_idx // Pl) * Kc + pm_cslot[p_idx, m_idx]      # rank, camera
    order = np.argsort(key, kind="stable")
    ks = key[order]
    start = np.r_[0, np.flatnonzero(np.diff(ks)) + 1]
    fill = np.arange(len(ks)) - np.repeat(start, np.diff(np.r_[start,
                                                               len(ks)]))
    F_l = max(8, int(-(-(fill.max() + 1 if len(fill) else 0) // 8) * 8))
    cm_src = np.full((n * Kc, F_l), -1, np.int32)
    cm_src[ks, fill] = ((p_idx % Pl) * M_ + m_idx)[order]

    def t(a):
        return torch.from_numpy(a).to(dev)

    sp = PsumShardProblem(
        cam_q=prob.cam_q, cam_t=prob.cam_t, cam_params=prob.cam_params,
        cam_valid=prob.cam_valid, pts=t(take(prob.pts)),
        pt_valid=t(take(prob.pt_valid)), pm_cslot=t(pm_cslot),
        pm_uv=t(take(prob.pm_uv)), pm_w=t(take(prob.pm_w)),
        pm_valid=t(pm_valid), pm_q0=t(take(prob.pm_q0)),
        pm_t0=t(take(prob.pm_t0)), pm_params0=t(take(prob.pm_params0)),
        cm_src=t(cm_src))
    inv_perm = np.empty(Pw, np.int64)
    inv_perm[perm] = np.arange(Pw)
    return sp, torch.from_numpy(inv_perm).to(dev)


_PSUM_ROWS = ("pts", "pt_valid", "pm_cslot", "pm_uv", "pm_w", "pm_valid",
              "pm_q0", "pm_t0", "pm_params0", "cm_src")


def dist_run_window_ba_psum(prob: bw.WindowProblem, mesh, kind: int,
                            axis: str = "shard", iters: int = 10,
                            cg_iters: int = 30, huber_delta2: float = CHI2,
                            robust: bool = True,
                            chi2_th: float = CHI2) -> bw.WindowResult:
    """Owner-partitioned implicit-Schur PCG, the distributed global BA's
    solver for many free cameras: each rank holds its points with all
    their edges, point-major for the 3x3 eliminations and through its
    camera-major grid for the per-camera sums.  Per LM iteration one
    all-reduce of the per-camera parts (gradient 6, Hcc 21, Schur diagonal
    21, W z0 6, and the cost: 4 (54 Kc + 1) bytes); per CG product one
    [Kc, 6] all-reduce.  The result's points are in the original order."""
    n = M.axis_size(mesh, axis)
    sp, inv_perm = shard_problem_for_psum(prob, n)
    lp = sp._replace(**{k: M.shard_rows(getattr(sp, k), mesh, axis)
                        for k in _PSUM_ROWS})
    Kc = lp.cam_q.shape[0]
    Pl, Mo = lp.pm_uv.shape[:2]
    E_l = Pl * Mo
    dev = lp.pts.device
    group = M.axis_group(mesh, axis)
    c = bw._flatten_consts(lp)      # reads the pm_* fields alone
    src_ok = (lp.cm_src >= 0)[..., None]
    src = torch.clamp(lp.cm_src, min=0).long()
    iu = torch.tensor(bw._IU6, device=dev)

    def cm_sum(V):
        """Per-camera sums of per-edge rows [E_l, C] -> [Kc, C]."""
        return torch.where(src_ok, V[src], 0.0).sum(1)

    def per_edge(x):  # [Pl] -> [E_l]
        return x.repeat_interleave(Mo)

    def lm_iter(cam_q, cam_t, pts_local, lam):
        rx, ry, jp, jc, dok = bw._soa_linearize(c, kind, cam_q, cam_t,
                                                pts_local, Mo)
        chi2 = c.w0 * (rx * rx + ry * ry)
        active = c.valid & dok
        cost_part = torch.where(active, bw._rho(chi2, huber_delta2),
                                0.0).sum()
        w_rob = bw._huber_w(chi2, huber_delta2) if robust \
            else torch.ones_like(chi2)
        w = torch.where(active, c.w0 * w_rob, 0.0)

        # local point elimination; the per-edge camera-block values
        g_p, Hpp, cols, wb = bw._soa_blocks(w, rx, ry, jp, jc, Pl, Mo)
        Hpp_inv = bw._spd_inv3(_damp(Hpp, lp.pt_valid, lam))
        # A = Wblk L (L = chol(Hpp^-1), lower): the Schur diagonal A A^T
        L = bw._chol3(Hpp_inv)
        Le = [per_edge(L[:, a, b]) for a in range(3) for b in range(3)]
        A = []
        for a in range(6):
            A.append(wb[a * 3] * Le[0] + wb[a * 3 + 1] * Le[3]
                     + wb[a * 3 + 2] * Le[6])
            A.append(wb[a * 3 + 1] * Le[4] + wb[a * 3 + 2] * Le[7])
            A.append(wb[a * 3 + 2] * Le[8])
        dtri = [A[a * 3] * A[b * 3] + A[a * 3 + 1] * A[b * 3 + 1]
                + A[a * 3 + 2] * A[b * 3 + 2]
                for a in range(6) for b in range(a, 6)]
        z0 = torch.einsum("pab,pb->pa", Hpp_inv, g_p)
        z0e = [per_edge(z0[:, b]) for b in range(3)]
        bz = [wb[a * 3] * z0e[0] + wb[a * 3 + 1] * z0e[1]
              + wb[a * 3 + 2] * z0e[2] for a in range(6)]

        # the iteration's one assembly all-reduce: [Kc, 54] + cost
        flat = torch.cat([cm_sum(torch.stack(cols + dtri + bz, -1))
                          .reshape(-1), cost_part[None]])
        dist.all_reduce(flat, group=group)
        red = flat[:-1].reshape(Kc, 54)
        cost_here = flat[-1]
        Hcc_l = _damp(red[:, 6:27][:, iu], lp.cam_valid, lam)
        b = torch.where(lp.cam_valid[:, None], -red[:, :6] + red[:, 48:54],
                        0.0)
        M_inv = bw._spd_inv6(Hcc_l - red[:, 27:48][:, iu])
        W3 = torch.stack(wb, -1).reshape(E_l, 6, 3)

        def S_mv(v):
            """(Hcc_l - W Hpp^-1 W^T) v with one [Kc, 6] all-reduce."""
            u_e = torch.einsum("eab,ea->eb", W3, v[c.cslot])
            u = u_e.reshape(Pl, Mo, 3).sum(1)
            z = torch.einsum("pab,pb->pa", Hpp_inv, u)
            back = cm_sum(torch.einsum("eab,eb->ea", W3,
                                       z.repeat_interleave(Mo, 0)))
            dist.all_reduce(back, group=group)
            Sv = torch.einsum("kab,kb->ka", Hcc_l, v) - back
            return torch.where(lp.cam_valid[:, None], Sv, v)

        x = _pcg(S_mv, lambda v: torch.einsum("kab,kb->ka", M_inv, v), b,
                 cg_iters)
        dx_c = torch.where(lp.cam_valid[:, None], x, 0.0)
        u = torch.einsum("eab,ea->eb", W3, dx_c[c.cslot]).reshape(
            Pl, Mo, 3).sum(1)
        dx_p = torch.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
        dx_p = torch.where(lp.pt_valid[:, None], dx_p, 0.0)
        dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
        dT = lie.se3_exp(dx_c)
        return (lie.quat_normalize(lie.quat_mul(dT.q, cam_q)),
                lie.quat_rotate(dT.q, cam_t) + dT.t, pts_local + dx_p,
                cost_here)

    bq, bt, bp, bcost = bw._lm_loop(lm_iter, lp.cam_q, lp.cam_t, lp.pts,
                                    iters, 1e-4)
    inlier = bw._soa_inliers(c, kind, bq, bt, bp, Pl, Mo, chi2_th)
    return bw.WindowResult(
        cam_q=bq, cam_t=bt,
        pts=M.all_gather_rows(bp, mesh, axis)[inv_perm],
        pm_inlier=M.all_gather_rows(inlier, mesh, axis)[inv_perm],
        cost=bcost)


def dist_solve_window_ba(prob: bw.WindowProblem, mesh, kind: int,
                         axis: str = "shard", iters: int = 10,
                         cg_iters: int = 30, dense_free_cap: int = 32,
                         **kw) -> bw.WindowResult:
    """The dense one-all-reduce solver for up to ``dense_free_cap`` free
    cameras (its payload grows as (6 Kc)^2), the psum-CG one beyond
    (payload linear in Kc)."""
    if int(prob.cam_valid.sum()) <= dense_free_cap:
        return dist_run_window_ba_dense(prob, mesh, kind, axis=axis,
                                        iters=iters, **kw)
    return dist_run_window_ba_psum(prob, mesh, kind, axis=axis, iters=iters,
                                   cg_iters=cg_iters, **kw)


# ---------------------------------------------------------------------------
# the server's global BA on a mesh
# ---------------------------------------------------------------------------

STOP, SOLVE = 0, 1
PROBLEM_DTYPES = tuple(
    torch.bool if f.endswith("valid") else
    torch.int32 if f in ("cam_idx", "cm_pt", "cm_mslot", "pt_idx", "pm_kf",
                         "pm_feat", "pm_cslot", "cam_slot_of", "pt_slot_of")
    else torch.float32 for f in bw.WindowProblem._fields)


def dist_global_ba(ms: S.MapState, cfg, mesh, map_id: int, kind: int,
                   axis: str = "shard", iters: int = 10,
                   dense_free_cap: int = 32, cg_iters: int = 30):
    """The full-map BA epoch of ``programs()["global_ba"]`` (the map's
    oldest keyframe fixed, the arena's caps, the point-major problem) with
    its solve on ``mesh[axis]`` through ``dist_solve_window_ba``.  Called
    on the mesh's rank 0; on a mesh of several ranks the problem goes to
    the others (waiting in ``serve``) first.  Returns the updated
    MapState."""
    is2 = torch.tensor(cfg.inv_sigma2, device=ms.kf_q.device)
    in_map = ms.kf_valid & (ms.kf_map == map_id)
    anchor = torch.argmin(torch.where(in_map, ms.kf_seq, S.BIG_SEQ))
    prob = steps.build_window_problem(ms, S.set_at(in_map, anchor, False),
                                      is2, cfg.max_kf, cfg.max_mp)
    if dist.get_world_size() > 1:
        M.send(mesh, SOLVE,
               (kind, mesh.mesh_dim_names.index(axis), iters, cg_iters,
                dense_free_cap),
               [x.to(dt) for x, dt in zip(prob, PROBLEM_DTYPES)])
    res = dist_solve_window_ba(prob, mesh, kind, axis=axis, iters=iters,
                               cg_iters=cg_iters,
                               dense_free_cap=dense_free_cap)
    return steps.apply_window_result(ms, prob, res)


def serve(mesh) -> int:
    """The loop of every rank but 0: join each ``dist_global_ba`` solve
    rank 0 starts until it calls ``stop``.  Returns the solves joined."""
    n = 0
    while True:
        command, args, fields = M.receive(mesh, PROBLEM_DTYPES)
        if command == STOP:
            return n
        kind, axis, iters, cg_iters, cap = args[:5]
        dist_solve_window_ba(bw.WindowProblem(*fields), mesh, kind,
                             axis=mesh.mesh_dim_names[axis], iters=iters,
                             cg_iters=cg_iters, dense_free_cap=cap)
        n += 1


def stop(mesh) -> None:
    """Rank 0: end the other ranks' ``serve`` loop."""
    if dist.get_world_size() > 1:
        M.send(mesh, STOP)
