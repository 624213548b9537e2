"""Frozen plain ORB extractor: FAST-9/16, grid top-K, IC orientation and
256-bit rBRIEF, in plain PyTorch.

Copied from ``mam3slam_tpu_torch/ops/orb.py`` (``OrbConfig``, the
pyramid, blur, FAST score map, NMS and the grid-bucket selection) and
``mam3slam_tpu_torch/ops/cuda_orb_desc.py`` (the plain describe:
``circular_umax``, ``ic_taps``, ``brief_taps``, ``ic_brief_plain``) at
commit 5e65ee5, with the kernel dispatch and the launch counters left
out; ``orb_pattern.npy`` beside this file is a copy of that commit's
``mam3slam_tpu_torch/data/orb_pattern.npy`` (OpenCV's bit_pattern_31).
It imports nothing of the program.

``extract(img, cfg, dtype)`` computes the pyramid, the FAST scores, the
blur and the moments in ``dtype``: float32 is the reference, and
bfloat16 is the control that the comparison must reject.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3),
)
EDGE_THRESHOLD = 19
HALF_PATCH = 15
PATTERN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "orb_pattern.npy")


@dataclass(frozen=True)
class OrbConfig:
    height: int
    width: int
    n_features: int = 700
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 16
    per_cell: int = 4
    level_sizes: Tuple[Tuple[int, int], ...] = field(default=None)
    level_budgets: Tuple[int, ...] = field(default=None)

    def __post_init__(self):
        sizes = []
        for lv in range(self.n_levels):
            s = self.scale_factor ** lv
            sizes.append((int(round(self.height / s)),
                          int(round(self.width / s))))
        object.__setattr__(self, "level_sizes", tuple(sizes))
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = []
        acc = 0
        for lv in range(self.n_levels - 1):
            b = int(round(n0 * f ** lv))
            budgets.append(b)
            acc += b
        budgets.append(max(self.n_features - acc, 0))
        object.__setattr__(self, "level_budgets", tuple(budgets))

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** lv for lv in range(self.n_levels))


@functools.lru_cache(maxsize=None)
def _resize_weights(m: int, n: int) -> np.ndarray:
    """[m, n] f32 weights of an anti-aliased linear resize from m to n
    samples (a tent of radius max(m/n, 1), renormalised per output)."""
    inv = np.float32(1.0 / (n / m))
    kernel_scale = np.float32(max(1.0 / (n / m), 1.0))
    sample = ((np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(m, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    out = np.where(inside[None, :], w, 0).astype(np.float32)
    out.flags.writeable = False
    return out


def compute_pyramid(img: torch.Tensor, cfg: OrbConfig):
    levels = [img]
    for lv in range(1, cfg.n_levels):
        prev = levels[-1]
        h, w = cfg.level_sizes[lv]
        wh = torch.tensor(_resize_weights(prev.shape[0], h), dtype=img.dtype,
                          device=img.device)
        ww = torch.tensor(_resize_weights(prev.shape[1], w), dtype=img.dtype,
                          device=img.device)
        levels.append((wh.T @ prev) @ ww)
    return tuple(levels)


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad2d(x: torch.Tensor, pad, mode: str, value: float = 0.0):
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    if mode == "constant":
        y = F.pad(y, pad, mode="constant", value=value)
    else:
        y = F.pad(y, pad, mode=mode)
    return y.reshape(lead + y.shape[-2:])


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0):
    k = _gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    x = _pad2d(img, (0, 0, r, r), "reflect")
    out = None
    for i in range(ksize):
        term = float(k[i]) * x[..., i:i + h, :]
        out = term if out is None else out + term
    x = _pad2d(out, (r, r, 0, 0), "reflect")
    out = None
    for i in range(ksize):
        term = float(k[i]) * x[..., :, i:i + w]
        out = term if out is None else out + term
    return out


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    pad = _pad2d(img, (3, 3, 3, 3), "replicate")
    diffs = [pad[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
             for dx, dy in _FAST_OFFSETS]

    def arc_min_max(d):
        m3 = [torch.minimum(torch.minimum(d[i], d[(i + 1) % 16]),
                            d[(i + 2) % 16]) for i in range(16)]
        m9 = [torch.minimum(torch.minimum(m3[i], m3[(i + 3) % 16]),
                            m3[(i + 6) % 16]) for i in range(16)]
        out = m9[0]
        for i in range(1, 16):
            out = torch.maximum(out, m9[i])
        return out

    return torch.maximum(arc_min_max(diffs), arc_min_max([-d for d in diffs]))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape[-2], score.shape[-1]
    p = _pad2d(score, (1, 1, 1, 1), "constant", -float("inf"))
    m = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            m = n if m is None else torch.maximum(m, n)
    return score >= m


def stack_constants(cfg: OrbConfig, device):
    """Detection eligibility [L, Hp, Wp] and per-slot level ids, scales
    and level extents, as tensors on ``device``."""
    L = cfg.n_levels
    Hp, Wp = cfg.level_sizes[0]
    border = EDGE_THRESHOLD - 3
    elig = np.zeros((L, Hp, Wp), bool)
    for lv in range(L):
        h, w = cfg.level_sizes[lv]
        elig[lv, border:h - border, border:w - border] = True
    lvl = np.concatenate([np.full(cfg.level_budgets[lv], lv, np.int32)
                          for lv in range(L)])
    scales = np.asarray(cfg.scales, np.float32)[lvl]
    hws = np.array(cfg.level_sizes, np.int32)[lvl]
    return tuple(torch.tensor(a, device=device)
                 for a in (elig, lvl, scales, hws))


def select_keypoints(score: torch.Tensor, cfg: OrbConfig, elig):
    """Per-level grid-bucket top-K over [L, Hp, Wp]: (xy [N, 2] i32 level
    coords, response [N] f32, valid [N]), ordered by level."""
    L, Hp, Wp = score.shape
    dev = score.device
    eligible = elig & _nms3(score) & (score > cfg.min_th)
    ninf = -float("inf")
    s = torch.where(eligible, score, ninf)
    cell = cfg.cell
    hc, wc = -(-Hp // cell), -(-Wp // cell)
    s_pad = F.pad(s, (0, wc * cell - Wp, 0, hc * cell - Hp), value=ninf)
    b = s_pad.reshape(L, hc, cell, wc, cell).permute(0, 1, 3, 2, 4)
    b = b.reshape(L, hc * wc, cell * cell)
    k = min(cfg.per_cell, cell * cell)
    lane = torch.arange(cell * cell, device=dev)
    vs, is_ = [], []
    for r in range(k):
        i = torch.argmax(b, dim=-1)
        vs.append(torch.amax(b, dim=-1))
        is_.append(i)
        if r + 1 < k:
            b = torch.where(lane == i[..., None], ninf, b)
    top_v = torch.stack(vs, dim=-1).to(torch.float32)
    top_i = torch.stack(is_, dim=-1)
    cidx = torch.arange(hc * wc, device=dev)
    gy = (cidx // wc)[None, :, None] * cell + top_i // cell
    gx = (cidx % wc)[None, :, None] * cell + top_i % cell
    rank = torch.arange(k, dtype=torch.float32, device=dev).expand(
        top_v.shape)
    strong = (top_v > cfg.ini_th).to(torch.float32)
    prio = torch.where(torch.isfinite(top_v),
                       -rank * 1e6 + strong * 1e3 + top_v, ninf)
    max_b = max(cfg.level_budgets)
    flat = prio.reshape(L, -1)
    nsel = min(max_b, flat.shape[1])
    sel_p, sel_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    sel_p, sel_idx = sel_p[:, :nsel], sel_idx[:, :nsel]
    sel_x = torch.gather(gx.reshape(L, -1), 1, sel_idx)
    sel_y = torch.gather(gy.reshape(L, -1), 1, sel_idx)
    sel_v = torch.gather(top_v.reshape(L, -1), 1, sel_idx)
    val = torch.isfinite(sel_p)
    xs, ys, rs, oks = [], [], [], []
    for lv in range(L):
        bud = cfg.level_budgets[lv]
        if bud == 0:
            continue
        n = min(bud, nsel)
        pad = bud - n
        xs.append(F.pad(sel_x[lv, :n], (0, pad)))
        ys.append(F.pad(sel_y[lv, :n], (0, pad)))
        rs.append(F.pad(sel_v[lv, :n], (0, pad)))
        oks.append(F.pad(val[lv, :n], (0, pad)))
    xy = torch.stack([torch.cat(xs), torch.cat(ys)], dim=-1).to(torch.int32)
    valid = torch.cat(oks)
    return xy, torch.where(valid, torch.cat(rs), 0.0), valid


def build_stack(img: torch.Tensor, cfg: OrbConfig) -> torch.Tensor:
    Hp, Wp = cfg.level_sizes[0]
    out = []
    for lv, x in enumerate(compute_pyramid(img, cfg)):
        h, w = cfg.level_sizes[lv]
        ry, rx = min(3, Hp - h), min(3, Wp - w)
        x = _pad2d(x, (0, rx, 0, ry), "reflect")
        out.append(F.pad(x, (0, Wp - w - rx, 0, Hp - h - ry)))
    return torch.stack(out)


# -- describe ---------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def load_pattern() -> np.ndarray:
    """[256, 4] int32 rBRIEF pattern (read-only)."""
    pat = np.load(PATTERN_PATH).astype(np.int32)
    pat.flags.writeable = False
    return pat


def circular_umax() -> np.ndarray:
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
    r = HALF_PATCH
    umax = circular_umax()
    dys, dxs = np.mgrid[-r:r + 1, -r:r + 1]
    inside = np.abs(dxs) <= umax[np.abs(dys)]
    return dys[inside].astype(np.int64), dxs[inside].astype(np.int64)


def pack_bits_256(bits: torch.Tensor) -> torch.Tensor:
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32,
                           device=bits.device)
    b = bits.reshape(bits.shape[0], 32, 8).to(torch.int32)
    return (b * weights).sum(-1).to(torch.uint8)


def ic_taps(xy: torch.Tensor, lvl: torch.Tensor, shape):
    """Flat indices [N, C] into a stack of ``shape`` of each keypoint's
    r=15 circle (clamped), and the offsets dy, dx [C]."""
    _, Hp, Wp = shape
    dy_np, dx_np = _ic_offsets()
    dy = torch.as_tensor(dy_np, device=xy.device)
    dx = torch.as_tensor(dx_np, device=xy.device)
    gy = torch.clamp(xy[:, 1:2].long() + dy[None, :], 0, Hp - 1)
    gx = torch.clamp(xy[:, 0:1].long() + dx[None, :], 0, Wp - 1)
    return lvl.long()[:, None] * (Hp * Wp) + gy * Wp + gx, dy, dx


def brief_taps(xy: torch.Tensor, lvl: torch.Tensor, hw: torch.Tensor,
               angle: torch.Tensor, shape) -> torch.Tensor:
    """Flat indices [N, 512] of the rBRIEF pairs rotated by ``angle``,
    clamped to each keypoint's level extent."""
    _, Hp, Wp = shape
    pat = torch.tensor(load_pattern(), dtype=torch.float32, device=xy.device)
    px = torch.cat([pat[:, 0], pat[:, 2]])
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


def describe(raw, blur, xy, lvl, hw):
    """IC angle (f32) and packed rBRIEF [N, 32] u8; the moments are
    summed in the stacks' dtype."""
    idx, dy, dx = ic_taps(xy, lvl, raw.shape)
    patch = raw.reshape(-1)[idx]
    m10 = torch.sum(patch * dx.to(raw.dtype), dim=1)
    m01 = torch.sum(patch * dy.to(raw.dtype), dim=1)
    angle = torch.atan2(m01.to(torch.float32), m10.to(torch.float32))
    v = blur.reshape(-1)[brief_taps(xy, lvl, hw, angle, raw.shape)]
    return angle, pack_bits_256(v[:, :256] < v[:, 256:])


def extract(img: torch.Tensor, cfg: OrbConfig, dtype=torch.float32) -> dict:
    """ORB of one grayscale image [H, W] (0..255) on its device, computed
    in ``dtype``: level coordinates ``xy`` [N, 2] i32, ``level`` [N],
    ``angle`` [N], ``desc`` [N, 32] u8 and ``valid`` [N], in slot order
    (N = the sum of the level budgets)."""
    elig, lvl, _, hws = stack_constants(cfg, img.device)
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        stack = build_stack(img.to(dtype), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_cudnn
    xy, _, valid = select_keypoints(fast_score_map(stack), cfg, elig)
    blur = torch.round(gaussian_blur(stack))
    angle, desc = describe(stack, blur, xy, lvl, hws)
    return dict(xy=xy, level=lvl, angle=angle, desc=desc, valid=valid)
