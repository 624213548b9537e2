"""Umeyama Sim3 alignment, ATE, and the room's surfaces.

``umeyama`` is copied from ``chip_smoke.py`` at commit 5e65ee5; the
room is the box of ``ref/render.py`` (half size S along x and z, half
height Hh along y), whose inside faces are the only surfaces a map point
can lie on.  Plain NumPy; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def umeyama(est: np.ndarray, gt: np.ndarray):
    """Sim3 (s, R, t) with gt ~ s R est + t (Umeyama)."""
    mx, my = est.mean(0), gt.mean(0)
    Xc, Yc = est - mx, gt - my
    U, D, Vt = np.linalg.svd(Yc.T @ Xc / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    s = np.trace(np.diag(D) @ S) / (Xc ** 2).sum() * len(est)
    Rm = U @ S @ Vt
    return s, Rm, my - s * Rm @ mx


def apply_sim3(sim3, pts: np.ndarray) -> np.ndarray:
    s, Rm, t = sim3
    return s * pts @ Rm.T + t


def ate(est: np.ndarray, gt: np.ndarray):
    """RMSE of camera centres after Sim3 alignment, the alignment, and the
    span of the true centres (the largest extent along an axis)."""
    sim3 = umeyama(est, gt)
    rmse = float(np.sqrt(((apply_sim3(sim3, est) - gt) ** 2).sum(1).mean()))
    return rmse, sim3, float(np.ptp(gt, axis=0).max())


def room_distance(pts: np.ndarray, half_size: float = 5.0,
                  half_height: float = 2.5) -> np.ndarray:
    """Distance of each world point to the nearest point of the room's
    faces (the absolute signed distance of the box)."""
    q = np.abs(pts) - np.array([half_size, half_height, half_size])
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
    return np.abs(outside + np.minimum(q.max(axis=1), 0.0))
