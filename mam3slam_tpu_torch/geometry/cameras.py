"""Batched camera models on torch tensors: Pinhole (+ radial-tangential)
and Kannala-Brandt8.

Port of ``mam3slam_tpu.geometry.cameras``.  A camera is a parameter tensor
``[..., 8]`` plus a static integer ``kind``:

  * PINHOLE:         [fx, fy, cx, cy, k1, k2, p1, p2]
  * KANNALA_BRANDT8: [fx, fy, cx, cy, k1, k2, k3, k4]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PINHOLE = 0
KANNALA_BRANDT8 = 1

_Z_EPS = 1e-6


class Camera(NamedTuple):
    params: torch.Tensor  # [..., 8] f32
    kind: int = PINHOLE

    @property
    def fx(self):
        return self.params[..., 0]

    @property
    def fy(self):
        return self.params[..., 1]

    @property
    def cx(self):
        return self.params[..., 2]

    @property
    def cy(self):
        return self.params[..., 3]

    def K(self) -> torch.Tensor:
        """[..., 3, 3] calibration matrix (no distortion)."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        k = torch.stack([self.fx, z, self.cx, z, self.fy, self.cy, z, z, o],
                        dim=-1)
        return k.reshape(self.params.shape[:-1] + (3, 3))


def make_pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0),
                 device=torch.device("cuda")) -> Camera:
    p = torch.tensor([fx, fy, cx, cy, *dist], dtype=torch.float32,
                     device=device)
    return Camera(p, PINHOLE)


def make_kb8(fx, fy, cx, cy, k1, k2, k3, k4,
             device=torch.device("cuda")) -> Camera:
    p = torch.tensor([fx, fy, cx, cy, k1, k2, k3, k4], dtype=torch.float32,
                     device=device)
    return Camera(p, KANNALA_BRANDT8)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < _Z_EPS, _Z_EPS, z)


def _project_pinhole(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    z = _safe_z(xc[..., 2])
    x = xc[..., 0] / z
    y = xc[..., 1] / z
    k1, k2, p1, p2 = cam.params[..., 4:8].unbind(-1)
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], dim=-1)


def _project_kb8(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    x, y, z = xc.unbind(-1)
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    k1, k2, k3, k4 = cam.params[..., 4:8].unbind(-1)
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = d / r
    return torch.stack([cam.fx * scale * x + cam.cx,
                        cam.fy * scale * y + cam.cy], dim=-1)


def project(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points ``[..., 3]`` -> pixels ``[..., 2]``."""
    if cam.kind == PINHOLE:
        return _project_pinhole(cam, xc)
    return _project_kb8(cam, xc)


def _unproject_pinhole(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    k1, k2, p1, p2 = cam.params[..., 4:8].unbind(-1)
    # Newton undistortion with the analytic 2x2 jacobian
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        fx_ = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fy_ = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - yd
        dr_dr2 = k1 + 2.0 * k2 * r2
        j00 = radial + 2.0 * x * x * dr_dr2 + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = 2.0 * x * y * dr_dr2 + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = 2.0 * x * y * dr_dr2 + 2.0 * p1 * x + 2.0 * p2 * y
        j11 = radial + 2.0 * y * y * dr_dr2 + 6.0 * p1 * y + 2.0 * p2 * x
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
        x = x - (j11 * fx_ - j01 * fy_) / det
        y = y - (-j10 * fx_ + j00 * fy_) / det
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _unproject_kb8(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.sqrt(torch.clamp(mx * mx + my * my, min=1e-18))
    k1, k2, k3, k4 = cam.params[..., 4:8].unbind(-1)
    # Newton solve of d(theta) = d
    theta = d
    for _ in range(10):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - d
        fp = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3
                                                           + 9.0 * k4 * t2)))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-8, 1e-8, fp)
    scale = torch.tan(theta) / d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels ``[..., 2]`` -> rays ``[..., 3]`` with z = 1."""
    if cam.kind == PINHOLE:
        return _unproject_pinhole(cam, uv)
    return _unproject_kb8(cam, uv)


def undistort_points(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels -> ideal-pinhole pixels (K applied to the ray)."""
    ray = unproject(cam, uv)
    return torch.stack([cam.fx * ray[..., 0] + cam.cx,
                        cam.fy * ray[..., 1] + cam.cy], dim=-1)


def _project_jac_pinhole_nodist(cam: Camera, xc: torch.Tensor):
    x, y = xc[..., 0], xc[..., 1]
    iz = 1.0 / _safe_z(xc[..., 2])
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(x)
    j = torch.stack([fx * iz, zero, -fx * x * iz2,
                     zero, fy * iz, -fy * y * iz2], dim=-1)
    return j.reshape(xc.shape[:-1] + (2, 3))


def _project_jac_kb8(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    x, y, z = xc.unbind(-1)
    r2 = torch.clamp(x * x + y * y, min=1e-18)
    r = torch.sqrt(r2)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    k1, k2, k3, k4 = cam.params[..., 4:8].unbind(-1)
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dd_dth = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3
                                                           + 9.0 * k4 * t2)))
    rho2 = r2 + z * z
    dth_dx = x * z / (rho2 * r)
    dth_dy = y * z / (rho2 * r)
    dth_dz = -r / rho2
    s = d / r
    ds_dx = (dd_dth * dth_dx * r - d * (x / r)) / r2
    ds_dy = (dd_dth * dth_dy * r - d * (y / r)) / r2
    ds_dz = dd_dth * dth_dz / r
    fx, fy = cam.fx, cam.fy
    j = torch.stack([fx * (s + x * ds_dx), fx * x * ds_dy, fx * x * ds_dz,
                     fy * y * ds_dx, fy * (s + y * ds_dy), fy * y * ds_dz],
                    dim=-1)
    return j.reshape(xc.shape[:-1] + (2, 3))


def project_jac(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(camera-frame point) ``[..., 2, 3]``; PINHOLE ignores the
    distortion terms (the pipeline optimises undistorted keypoints)."""
    if cam.kind == PINHOLE:
        return _project_jac_pinhole_nodist(cam, xc)
    return _project_jac_kb8(cam, xc)


def project_ideal(cam: Camera, xc: torch.Tensor) -> torch.Tensor:
    """Project without distortion for PINHOLE (pairs with undistorted
    keypoints); KB8 matches in the full model."""
    if cam.kind == PINHOLE:
        z = _safe_z(xc[..., 2])
        return torch.stack([cam.fx * xc[..., 0] / z + cam.cx,
                            cam.fy * xc[..., 1] / z + cam.cy], dim=-1)
    return _project_kb8(cam, xc)
