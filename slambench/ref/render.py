"""Frozen copy of the room renderer and orbit trajectories.

Copied from ``mam3slam_tpu_torch/io/render.py`` at commit 5e65ee5
(``RenderCam``, ``reference_kb8_cam``, ``_kb8_unproject_grid``,
``_texture``, ``_bilinear``, ``RoomScene``, ``orbit_pose``,
``orbit_trajectory``), with the ASL writer, the photometric
degradations and the disk cache left out, and the KB8 rays computed once
per camera for all rooms.  The benchmark renders its
frames with this copy so that a later change to the program's renderer
cannot change the traffic.  Plain PyTorch and NumPy; it imports nothing
of the program.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class RenderCam:
    width: int = 640
    height: int = 480
    fx: float = 320.0
    fy: float = 320.0
    cx: float = 320.0
    cy: float = 240.0
    fps: float = 20.0
    # "pinhole" or "kb8" (KannalaBrandt8 equidistant fisheye, k = k1..k4)
    model: str = "pinhole"
    k: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@functools.lru_cache(maxsize=4)
def _kb8_unproject_grid(cam: RenderCam) -> np.ndarray:
    """Per-pixel unit ray directions [H, W, 3] f32 (camera frame) of a KB8
    fisheye, in float64: theta_d = theta + k1 th^3 + k2 th^5 + k3 th^7 +
    k4 th^9 inverted by 10 Newton steps (computed once per camera, for
    every room)."""
    W, H = cam.width, cam.height
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    mx = (xs - cam.cx) / cam.fx
    my = (ys - cam.cy) / cam.fy
    theta_d = np.sqrt(mx * mx + my * my)
    k1, k2, k3, k4 = cam.k
    th = theta_d.copy()
    for _ in range(10):
        th2 = th * th
        f = th * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))) \
            - theta_d
        fp = 1 + th2 * (3 * k1 + th2 * (5 * k2 + th2 * (7 * k3
                                                        + th2 * 9 * k4)))
        th = th - f / np.maximum(fp, 1e-9)
    scale = np.where(theta_d > 1e-9, np.tan(th) / np.maximum(theta_d, 1e-9),
                     1.0)
    rays = np.stack([mx * scale, my * scale, np.ones_like(mx)], axis=-1)
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)
            ).astype(np.float32)
    rays.flags.writeable = False
    return rays


def _texture(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    """Band-limited two-octave noise texture, values ~[30, 225]."""
    from scipy.ndimage import gaussian_filter

    fine = gaussian_filter(rng.uniform(-1, 1, hw), 1.5, mode="wrap")
    coarse = gaussian_filter(rng.uniform(-1, 1, hw), 6.0, mode="wrap")
    t = fine / (np.abs(fine).max() + 1e-9) + coarse / (
        np.abs(coarse).max() + 1e-9)
    t = (t - t.min()) / (t.max() - t.min())
    return (t * 195 + 30).astype(np.float32)


def _bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    h, w = tex.shape
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = u.to(torch.int64)
    v0 = v.to(torch.int64)
    du = u - u0
    dv = v - v0
    t00 = tex[v0, u0]
    t01 = tex[v0, u0 + 1]
    t10 = tex[v0 + 1, u0]
    t11 = tex[v0 + 1, u0 + 1]
    return (t00 * (1 - du) * (1 - dv) + t01 * du * (1 - dv)
            + t10 * (1 - du) * dv + t11 * du * dv)


class RoomScene:
    """Interior of a textured box; world frame x right, y down, z forward.
    Faces: x=+-S (walls), z=+-S (walls), y=+Hh (floor), y=-Hh (ceiling).
    ``seed`` is anything ``np.random.default_rng`` takes."""

    def __init__(self, half_size: float = 5.0, half_height: float = 2.5,
                 seed=0, px_per_m: float = 100.0, device="cpu"):
        self.S = float(half_size)
        self.Hh = float(half_height)
        self.px_per_m = float(px_per_m)
        self.device = torch.device(device)
        self._kb8_rays = {}
        rng = np.random.default_rng(seed)
        wall_hw = (int(2 * self.Hh * px_per_m) + 2,
                   int(2 * self.S * px_per_m) + 2)
        cap_hw = (int(2 * self.S * px_per_m) + 2,
                  int(2 * self.S * px_per_m) + 2)
        normals = ([1.0, 0, 0], [-1.0, 0, 0], [0, 0, 1.0], [0, 0, -1.0],
                   [0, 1.0, 0], [0, -1.0, 0])
        offsets = (self.S, self.S, self.S, self.S, self.Hh, self.Hh)
        sizes = (wall_hw, wall_hw, wall_hw, wall_hw, cap_hw, cap_hw)
        self.normals = torch.tensor(normals, dtype=torch.float64,
                                    device=self.device)     # [6, 3]
        self.offsets = torch.tensor(offsets, dtype=torch.float64,
                                    device=self.device)     # [6]
        self.textures = [torch.tensor(_texture(rng, hw), device=self.device)
                         for hw in sizes]

    def _texcoords(self, i: int, pts: torch.Tensor):
        s = self.px_per_m
        if i < 2:        # x walls: (z, y)
            return (pts[:, 2] + self.S) * s, (pts[:, 1] + self.Hh) * s
        if i < 4:        # z walls: (x, y)
            return (pts[:, 0] + self.S) * s, (pts[:, 1] + self.Hh) * s
        return (pts[:, 0] + self.S) * s, (pts[:, 2] + self.S) * s

    def intersect(self, R, t, rays_c: torch.Tensor):
        """Nearest face hit by camera rays ``rays_c [N, 3]`` from the pose
        (R, t) world->cam: (face [N] int64, world points [N, 3] f32)."""
        Rwc = torch.as_tensor(np.asarray(R, np.float32).T, device=self.device)
        C = -Rwc @ torch.as_tensor(np.asarray(t, np.float32),
                                   device=self.device)
        rays_w = rays_c.to(torch.float32) @ Rwc.T
        denom = rays_w.to(torch.float64) @ self.normals.T     # [N, 6]
        num = self.offsets - self.normals @ C.to(torch.float64)
        hit = torch.abs(denom) > 1e-8
        lam = torch.where(hit, num / torch.where(hit, denom, 1.0),
                          float("inf")).to(torch.float32)
        lam = torch.where(lam > 0.05, lam, float("inf"))
        face = torch.argmin(lam, dim=1)
        lam = torch.gather(lam, 1, face[:, None])
        return face, C[None, :] + lam * rays_w

    def camera_rays(self, cam: RenderCam) -> torch.Tensor:
        """Camera-frame rays [H * W, 3] of every pixel: (x, y, 1) for the
        pinhole, unit rays for KB8 (computed once per camera)."""
        if cam.model == "kb8":
            key = (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
                   cam.k)
            if key not in self._kb8_rays:
                self._kb8_rays[key] = torch.tensor(
                    _kb8_unproject_grid(cam), device=self.device
                ).reshape(-1, 3)
            return self._kb8_rays[key]
        ys, xs = torch.meshgrid(
            torch.arange(cam.height, dtype=torch.float32, device=self.device),
            torch.arange(cam.width, dtype=torch.float32, device=self.device),
            indexing="ij")
        return torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                            torch.ones_like(xs)], dim=-1).reshape(-1, 3)

    def render(self, R, t, cam: RenderCam) -> torch.Tensor:
        """Grayscale f32 image [H, W] of the pose (R, t) world->cam."""
        rays = self.camera_rays(cam)
        face, pts = self.intersect(R, t, rays)
        img = torch.zeros(rays.shape[0], dtype=torch.float32,
                          device=self.device)
        for i, tex in enumerate(self.textures):
            sel = face == i
            u, v = self._texcoords(i, pts[sel])
            img[sel] = _bilinear(tex, u, v)
        return torch.clamp(img, 0, 255).reshape(cam.height, cam.width)


def orbit_pose(theta: float, radius: float):
    """Camera on a circle of ``radius`` in the y=0 plane looking radially
    outward.  Returns (R, t, C): world->cam rotation and translation, and
    the camera centre."""
    c, s = np.cos(theta), np.sin(theta)
    C = np.array([radius * c, 0.0, radius * s])
    z_cam = np.array([c, 0.0, s])
    x_cam = np.array([-s, 0.0, c])
    y_cam = np.cross(z_cam, x_cam)
    R = np.stack([x_cam, y_cam, z_cam])
    return R.astype(np.float32), (-R @ C).astype(np.float32), C


def orbit_trajectory(n_frames: int, start_deg: float, end_deg: float,
                     radius: float = 2.5, bob: float = 0.0
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(R, t, C) along an arc; ``bob`` adds a vertical oscillation."""
    out = []
    for i in range(n_frames):
        th = np.deg2rad(start_deg + (end_deg - start_deg) * i
                        / max(n_frames - 1, 1))
        R, t, C = orbit_pose(th, radius)
        if bob:
            C = C + np.array([0, bob * np.sin(4 * th), 0])
            t = -R @ C.astype(np.float32)
        out.append((R, t.astype(np.float32), C))
    return out
