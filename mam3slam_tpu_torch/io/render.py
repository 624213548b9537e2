"""Raycast renderer of a textured room, on torch tensors.

Port of the pinhole path of ``mam3slam_tpu.io.render``: the same scene
(interior of a box, each face a band-limited two-octave noise texture
drawn from the same seeded generator, so the textures are identical), the
same orbit trajectories, and the ray-plane depth that renders a pixel.
Rendering runs on the textures' device.
"""

from __future__ import annotations

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
    Faces: x=+-S (walls), z=+-S (walls), y=+Hh (floor), y=-Hh (ceiling)."""

    def __init__(self, half_size: float = 5.0, half_height: float = 2.5,
                 seed: int = 0, px_per_m: float = 100.0,
                 device=torch.device("cuda")):
        self.S = float(half_size)
        self.Hh = float(half_height)
        self.px_per_m = float(px_per_m)
        self.device = device
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
                                    device=device)          # [6, 3]
        self.offsets = torch.tensor(offsets, dtype=torch.float64,
                                    device=device)          # [6]
        self.textures = [torch.tensor(_texture(rng, hw), device=device)
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

    def render(self, R, t, cam: RenderCam) -> torch.Tensor:
        """Grayscale f32 image [H, W] of the pose (R, t) world->cam."""
        ys, xs = torch.meshgrid(
            torch.arange(cam.height, dtype=torch.float32, device=self.device),
            torch.arange(cam.width, dtype=torch.float32, device=self.device),
            indexing="ij")
        rays = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                            torch.ones_like(xs)], dim=-1).reshape(-1, 3)
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
