"""Describe kernel: per-keypoint IC orientation + 256-bit rBRIEF.

Wrapper of ``csrc/orb_desc.cu`` (replaces the Pallas kernel
``mam3slam_tpu/ops/pallas_orb_desc.py:ic_brief_fused``) and its plain
PyTorch version, which is the CPU path of ``mam3slam_tpu.ops.orb``
(``_extract_patches_pair`` + ``_ic_angles_patch`` +
``_brief_descriptors_patch``) written as direct gathers.

Semantics, per keypoint at integer level coordinates (x, y):
  * m10 / m01 = sum of I * dx / I * dy over the r=15 circle
    |dx| <= umax[|dy|] of the RAW level; angle = atan2(m01, m10);
  * 256 comparisons of the BLURRED, rounded level at the pattern pairs
    rotated by that angle: offsets rounded half-to-even, taps clamped to
    the level's own (h, w) extent;
  * bits packed in OpenCV order (bit k of byte j is pair 8j + k).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from mam3slam_tpu_torch import _build

HALF_PATCH = 15
# bit_pattern_31 pairs (x1, y1, x2, y2), OpenCV's rBRIEF pattern
PATTERN_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                            "orb_pattern.npy")


@functools.lru_cache(maxsize=1)
def load_pattern() -> np.ndarray:
    """[256, 4] int32 rBRIEF pattern (read-only)."""
    pat = np.load(os.path.abspath(PATTERN_PATH)).astype(np.int32)
    pat.flags.writeable = False
    return pat


@functools.lru_cache(maxsize=None)
def device_pattern(device: torch.device) -> torch.Tensor:
    """The rBRIEF pattern on ``device``, copied there once (the kernel
    reads it on every launch)."""
    return torch.tensor(load_pattern(), device=device)


def circular_umax() -> np.ndarray:
    """u_max per |dy| of the r=15 circular patch (reference umax table)."""
    r = HALF_PATCH
    umax = np.zeros(r + 1, dtype=np.int64)
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(r * r - v * v)))
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _ic_offsets():
    """Offsets (dy, dx) of the r=15 circle, row-major."""
    r = HALF_PATCH
    umax = circular_umax()
    dys, dxs = np.mgrid[-r:r + 1, -r:r + 1]
    inside = np.abs(dxs) <= umax[np.abs(dys)]
    return dys[inside].astype(np.int64), dxs[inside].astype(np.int64)


def pack_bits_256(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 32] uint8 (bit k of byte j = bit 8j + k)."""
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32,
                           device=bits.device)
    b = bits.reshape(bits.shape[0], 32, 8).to(torch.int32)
    return (b * weights).sum(-1).to(torch.uint8)


def ic_taps(xy: torch.Tensor, lvl: torch.Tensor, shape):
    """Flat indices [N, C] into a stack of ``shape`` [L, Hp, Wp] of each
    keypoint's r=15 circle (clamped to the stack), and the circle's
    offsets dy, dx [C]."""
    _, Hp, Wp = shape
    dy_np, dx_np = _ic_offsets()
    dy = torch.as_tensor(dy_np, device=xy.device)
    dx = torch.as_tensor(dx_np, device=xy.device)
    gy = torch.clamp(xy[:, 1:2].long() + dy[None, :], 0, Hp - 1)
    gx = torch.clamp(xy[:, 0:1].long() + dx[None, :], 0, Wp - 1)
    return lvl.long()[:, None] * (Hp * Wp) + gy * Wp + gx, dy, dx


def brief_taps(xy: torch.Tensor, lvl: torch.Tensor, hw: torch.Tensor,
               angle: torch.Tensor, shape) -> torch.Tensor:
    """Flat indices [N, 512] into a stack of ``shape`` [L, Hp, Wp] of the
    rBRIEF pairs' first then second points rotated by ``angle``, clamped
    to each keypoint's level extent."""
    _, Hp, Wp = shape
    pat = torch.tensor(load_pattern(), dtype=torch.float32, device=xy.device)
    px = torch.cat([pat[:, 0], pat[:, 2]])                    # [512]
    py = torch.cat([pat[:, 1], pat[:, 3]])
    ca, sa = torch.cos(angle), torch.sin(angle)
    rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    h = hw[:, 0:1].long()
    w = hw[:, 1:2].long()
    tx = torch.minimum(torch.clamp(xy[:, 0:1].long() + rx.long(), min=0),
                       w - 1)
    ty = torch.minimum(torch.clamp(xy[:, 1:2].long() + ry.long(), min=0),
                       h - 1)
    return lvl.long()[:, None] * (Hp * Wp) + ty * Wp + tx


def ic_brief_plain(raw: torch.Tensor, blur: torch.Tensor, xy: torch.Tensor,
                   lvl: torch.Tensor, hw: torch.Tensor):
    """Plain PyTorch describe: raw/blur [L, Hp, Wp] f32 stacks, xy [N, 2]
    i32 (x, y) level coords, lvl [N] i32, hw [N, 2] i32 (h, w) level
    extents -> (angle [N] f32, desc [N, 32] u8)."""
    _build.count_plain("orb_desc")
    idx, dy, dx = ic_taps(xy, lvl, raw.shape)
    patch = raw.reshape(-1)[idx]                              # [N, C]
    m10 = torch.sum(patch * dx.to(raw.dtype), dim=1)
    m01 = torch.sum(patch * dy.to(raw.dtype), dim=1)
    angle = torch.atan2(m01, m10)
    v = blur.reshape(-1)[brief_taps(xy, lvl, hw, angle, raw.shape)]
    return angle, pack_bits_256(v[:, :256] < v[:, 256:])


def ic_brief(raw: torch.Tensor, blur: torch.Tensor, xy: torch.Tensor,
             lvl: torch.Tensor, hw: torch.Tensor):
    """IC angle + rBRIEF for N keypoints of a stacked pyramid.  CUDA
    tensors launch ``csrc/orb_desc.cu``; CPU tensors take the plain
    version."""
    if not _build.is_cuda(raw, blur, xy, lvl, hw):
        return ic_brief_plain(raw, blur, xy, lvl, hw)
    L, Hp, Wp = raw.shape
    N = xy.shape[0]
    _build.check(raw, "raw", torch.float32, (L, Hp, Wp))
    _build.check(blur, "blur", torch.float32, (L, Hp, Wp))
    _build.check(xy, "xy", torch.int32, (N, 2))
    _build.check(lvl, "lvl", torch.int32, (N,))
    _build.check(hw, "hw", torch.int32, (N, 2))
    pattern = device_pattern(raw.device)
    angle = torch.empty(N, dtype=torch.float32, device=raw.device)
    desc = torch.empty((N, 32), dtype=torch.uint8, device=raw.device)
    if N:
        _build.launch("mam3_orb_desc", raw.data_ptr(), blur.data_ptr(), L,
                      Hp, Wp, xy.data_ptr(), lvl.data_ptr(), hw.data_ptr(),
                      pattern.data_ptr(), N, angle.data_ptr(),
                      desc.data_ptr())
    return angle, desc
