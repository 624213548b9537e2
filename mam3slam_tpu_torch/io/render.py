"""Raycast renderer of a textured room, on torch tensors, and an ASL
sequence writer.

Port of ``mam3slam_tpu.io.render``: the same scene (interior of a box,
each face a band-limited two-octave noise texture drawn from the same
seeded generator, so the textures are identical), the same orbit
trajectories, pinhole and KannalaBrandt8 (KB8) fisheye cameras, the
photometric degradations, the EuRoC ASL writer and the float16 render
cache.  Rendering runs on the textures' device.  PNGs are written with
zlib, with no image library.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from mam3slam_tpu_torch.io import images

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


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


def reference_kb8_cam(scale: float = 1.0) -> RenderCam:
    """The reference fixture's camera (settingsForTest_00.yaml: 960x960
    KB8 at 20 fps, fx = fy = 470.2, k1..k4 below), optionally scaled in
    resolution."""
    s = float(scale)
    return RenderCam(width=int(960 * s), height=int(960 * s),
                     fx=470.2 * s, fy=470.2 * s,
                     cx=479.9 * s, cy=479.9 * s, fps=20.0, model="kb8",
                     k=(0.0034823894022493434, 0.0007150348452162257,
                        -0.0020532361418706202, 0.00020293673591811182))


@dataclass(frozen=True)
class Photometric:
    """Per-frame photometric perturbations (deterministic in the frame
    index), on the host in numpy and scipy: multiplicative gain and
    additive bias drift, Gaussian blur, radial vignetting and pixel
    noise."""

    gain_amp: float = 0.15     # gain in [1-a, 1+a], smooth over frames
    bias_amp: float = 12.0     # additive offset in [-b, b]
    blur_sigma: float = 0.8    # Gaussian blur sigma (px); 0 = off
    vignette: float = 0.35     # corner darkening fraction; 0 = off
    noise_sigma: float = 2.0   # zero-mean Gaussian pixel noise; 0 = off
    seed: int = 7

    def apply(self, img: np.ndarray, frame_idx: int) -> np.ndarray:
        from scipy.ndimage import gaussian_filter

        h, w = img.shape
        out = img.astype(np.float32)
        if self.blur_sigma > 0:
            out = gaussian_filter(out, self.blur_sigma)
        if self.vignette > 0:
            ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
            r2 = (((xs - w / 2) / (w / 2)) ** 2
                  + ((ys - h / 2) / (h / 2)) ** 2)
            out = out * (1.0 - self.vignette * 0.5 * r2)
        # smooth exposure drift (deterministic, band-limited)
        ph = 2 * np.pi * (frame_idx * 0.013 + 0.1 * self.seed)
        gain = 1.0 + self.gain_amp * np.sin(ph)
        bias = self.bias_amp * np.sin(0.7 * ph + 1.3)
        out = out * gain + bias
        if self.noise_sigma > 0:
            rng = np.random.default_rng(self.seed * 100003 + frame_idx)
            out = out + rng.normal(0, self.noise_sigma, out.shape)
        return np.clip(out, 0, 255)


def _kb8_unproject_grid(cam: RenderCam) -> np.ndarray:
    """Per-pixel unit ray directions [H, W, 3] f32 (camera frame) of a KB8
    fisheye, in float64: theta_d = theta + k1 th^3 + k2 th^5 + k3 th^7 +
    k4 th^9 inverted by 10 Newton steps."""
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
    return (rays / np.linalg.norm(rays, axis=-1, keepdims=True)
            ).astype(np.float32)


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
        self.seed = int(seed)  # part of the render-cache key
        self.device = device
        self._kb8_rays = {}    # camera -> [H * W, 3] unit rays on device
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


def _rot_to_quat_wxyz(Rm: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(Rm).as_quat()  # xyzw
    return np.array([q[3], q[0], q[1], q[2]])


def write_asl_sequence(seq_dir: str, scene: RoomScene, traj: Sequence,
                       cam: RenderCam, t0: float = 0.0) -> None:
    """Render ``traj`` ((R, t, C) per frame) and write a EuRoC ASL
    sequence: mav0/cam0/{data.csv,sensor.yaml,data/*.png} and
    mav0/state_groundtruth_estimate0/data.csv (camera centre and the
    world-from-camera quaternion, wxyz)."""
    cam_dir = os.path.join(seq_dir, "mav0", "cam0")
    img_dir = os.path.join(cam_dir, "data")
    gt_dir = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    if cam.model == "kb8":
        model, dist_model = "kb8", "equidistant"
        k = cam.k
    else:
        model, dist_model = "pinhole", "radial-tangential"
        k = (0.0, 0.0, 0.0, 0.0)
    with open(os.path.join(cam_dir, "sensor.yaml"), "w") as f:
        f.write(
            "%YAML:1.0\n"
            "sensor_type: camera\n"
            f"rate_hz: {cam.fps}\n"
            f"resolution: [{cam.width}, {cam.height}]\n"
            f"camera_model: {model}\n"
            f"intrinsics: [{cam.fx}, {cam.fy}, {cam.cx}, {cam.cy}]\n"
            f"distortion_model: {dist_model}\n"
            f"distortion_coefficients: [{k[0]}, {k[1]}, {k[2]}, {k[3]}]\n")

    rows_cam = ["#timestamp [ns],filename"]
    rows_gt = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
               "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"]
    dt = 1.0 / cam.fps
    for i, (R, t, C) in enumerate(p[:3] for p in traj):
        ts_ns = int(round((t0 + i * dt) * 1e9))
        name = f"{ts_ns}.png"
        img = scene.render(R, t, cam).cpu().numpy().astype(np.uint8)
        images.write_png(os.path.join(img_dir, name), img)
        q = _rot_to_quat_wxyz(np.asarray(R).T)
        rows_cam.append(f"{ts_ns},{name}")
        rows_gt.append(f"{ts_ns},{C[0]:.6f},{C[1]:.6f},{C[2]:.6f},"
                       f"{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},{q[3]:.6f}")
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows_cam) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows_gt) + "\n")


def render_sequence_cached(scene: RoomScene, traj, cam: RenderCam,
                           cache_dir: str = None) -> np.ndarray:
    """Rendered frame stack [N, H, W] float16 with a disk cache keyed by
    the scene (seed, geometry), the camera and the trajectory's poses,
    under a ``torch`` tag: the reference's cache files are never read
    (its frames agree with these only to f32 rounding, which float16 can
    round apart).  The cache lives in ``$MAM3_RENDER_CACHE``, else in
    ``build/render_cache`` of the repository.  Frames are stored float16:
    uint8 would move FAST and BoW margins.  Trajectory entries are
    (R, t, ...) tuples."""
    Rs = np.stack([np.asarray(p[0], np.float32) for p in traj])
    ts = np.stack([np.asarray(p[1], np.float32) for p in traj])
    h = hashlib.sha1(b"mam3slam_tpu_torch")
    h.update(np.asarray(
        [scene.seed, scene.S, scene.Hh, scene.px_per_m,
         cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy],
        np.float64).tobytes())
    h.update(str(cam.k).encode())
    h.update(cam.model.encode())
    h.update(Rs.tobytes())
    h.update(ts.tobytes())
    cache_dir = cache_dir or os.environ.get(
        "MAM3_RENDER_CACHE", os.path.join(_REPO, "build", "render_cache"))
    path = os.path.join(cache_dir, "torch_" + h.hexdigest()[:24] + ".npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return z["frames"]
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass  # corrupt or partial file: render again
    frames = np.stack([scene.render(R, t, cam).to(torch.float16).cpu().numpy()
                       for R, t in zip(Rs, ts)])
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"  # savez keeps the .npz
        np.savez_compressed(tmp, frames=frames)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is best-effort (read-only or full disk, races)
    return frames
