"""ORB feature extraction (FAST + oriented rBRIEF) on torch tensors.

Port of the CPU branch of ``mam3slam_tpu.ops.orb.extract_orb``: an
8-level pyramid cascade at scale 1.2, levels stacked and zero-padded to
the level-0 extent (each with a 3-pixel reflect-101 border), a dense
FAST-9/16 score map, 3x3 non-max suppression, grid-bucket top-K selection
with a per-level budget, a 7x7 sigma=2 blur rounded to integers, and the
describe step (IC angle + rBRIEF) of ``ops/cuda_orb_desc.py``.  Outputs
are fixed-capacity tensors with a validity mask.

Numerics follow the reference's CPU path: the same tap order in the blur,
the same f32 priorities, ties in the top-K broken toward the lower index
(stable sorts), and full-f32 resize products (TF32 off).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.ops import cuda_orb_desc
from mam3slam_tpu_torch.utils.timing import TRACER

# FAST circle of radius 3 — 16 (dx, dy) offsets in OpenCV order.
_FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3),
)

EDGE_THRESHOLD = 19
pack_bits_256 = cuda_orb_desc.pack_bits_256


class Features(NamedTuple):
    """Fixed-capacity ORB features of one frame."""

    xy: torch.Tensor        # [N, 2] f32 raw level-0 pixel coords
    uv: torch.Tensor        # [N, 2] f32 match-space coords
    level: torch.Tensor     # [N] i32
    angle: torch.Tensor     # [N] f32 radians
    response: torch.Tensor  # [N] f32
    desc: torch.Tensor      # [N, 32] u8
    valid: torch.Tensor     # [N] bool


@dataclass(frozen=True)
class OrbConfig:
    """Static extraction config (shapes and budgets resolved in Python)."""

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
        # geometric per-level budget (reference ORBextractor ctor)
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

    @property
    def capacity(self) -> int:
        n = sum(self.level_budgets)
        return ((n + 127) // 128) * 128


# ---------------------------------------------------------------------------
# pyramid + blur
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resize_weights(m: int, n: int, device: torch.device) -> torch.Tensor:
    """[m, n] f32 weights of an anti-aliased linear resize from m to n
    samples (``jax.image.resize(..., "bilinear")``: a tent of radius
    max(m/n, 1), renormalised per output sample), computed in f32 as the
    reference computes them."""
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
    return torch.tensor(np.where(inside[None, :], w, 0).astype(np.float32),
                        device=device)


def compute_pyramid(img: torch.Tensor, cfg: OrbConfig):
    """f32 [H, W] -> tuple of level images, each resized from the previous
    one (the reference's ComputePyramid cascade)."""
    levels = [img]
    for lv in range(1, cfg.n_levels):
        prev = levels[-1]
        h, w = cfg.level_sizes[lv]
        wh = _resize_weights(prev.shape[0], h, img.device)
        ww = _resize_weights(prev.shape[1], w, img.device)
        levels.append((wh.T @ prev) @ ww)
    return tuple(levels)


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad2d(x: torch.Tensor, pad, mode: str, value: float = 0.0):
    """F.pad over the last two dims of a [..., H, W] tensor of any rank
    (pad = (left, right, top, bottom))."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    if mode == "constant":
        y = F.pad(y, pad, mode="constant", value=value)
    else:
        y = F.pad(y, pad, mode=mode)
    return y.reshape(lead + y.shape[-2:])


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflect-101 border over [..., H, W];
    the 7+7 taps are summed in the reference's order."""
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


# ---------------------------------------------------------------------------
# FAST score map + NMS
# ---------------------------------------------------------------------------

def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 score (max passing threshold) over [..., H, W]."""
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
    """3x3 non-max suppression mask (>= every 8-neighbour)."""
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


# ---------------------------------------------------------------------------
# grid-bucket top-K over the stacked pyramid
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stack_constants(cfg: OrbConfig):
    """Per-level eligibility mask (detection border inside each level's
    extent) and per-keypoint-slot level ids / scales / level extents."""
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
    for a in (elig, lvl, scales, hws):
        a.flags.writeable = False
    return elig, lvl, scales, hws


def _select_keypoints_stacked(score: torch.Tensor, cfg: OrbConfig):
    """Per-level grid-bucket top-K over a stacked score map [L, Hp, Wp].

    Returns (xy [N, 2] i32 level coords, response [N] f32, valid [N])
    with N = sum of level budgets, ordered by level."""
    L, Hp, Wp = score.shape
    dev = score.device
    elig = _device_constants(cfg, dev)[0]
    eligible = elig & _nms3(score) & (score > cfg.min_th)
    ninf = -float("inf")
    s = torch.where(eligible, score, ninf)

    cell = cfg.cell
    hc, wc = -(-Hp // cell), -(-Wp // cell)
    s_pad = F.pad(s, (0, wc * cell - Wp, 0, hc * cell - Hp), value=ninf)
    b = s_pad.reshape(L, hc, cell, wc, cell).permute(0, 1, 3, 2, 4)
    b = b.reshape(L, hc * wc, cell * cell)
    k = min(cfg.per_cell, cell * cell)
    # per-cell top-k by k (argmax, mask) rounds: argmax takes the first
    # maximum, as the reference does
    lane = torch.arange(cell * cell, device=dev)
    vs, is_ = [], []
    for r in range(k):
        i = torch.argmax(b, dim=-1)
        vs.append(torch.amax(b, dim=-1))
        is_.append(i)
        if r + 1 < k:
            b = torch.where(lane == i[..., None], ninf, b)
    top_v = torch.stack(vs, dim=-1)            # [L, ncells, k]
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
    # stable descending sort = lax.top_k's lower-index-first tie order
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
    resp = torch.where(valid, torch.cat(rs), 0.0)
    return xy, resp, valid


# ---------------------------------------------------------------------------
# full extraction
# ---------------------------------------------------------------------------

def build_stack(img: torch.Tensor, cfg: OrbConfig) -> torch.Tensor:
    """[L, Hp, Wp] pyramid stack: each level reflect-101 padded by 3 rows
    and columns past its extent, then zero-padded to the level-0 extent,
    so one blur over the stack is exact inside every level."""
    Hp, Wp = cfg.level_sizes[0]
    out = []
    for lv, x in enumerate(compute_pyramid(img, cfg)):
        h, w = cfg.level_sizes[lv]
        ry, rx = min(3, Hp - h), min(3, Wp - w)
        x = _pad2d(x, (0, rx, 0, ry), "reflect")
        out.append(F.pad(x, (0, Wp - w - rx, 0, Hp - h - ry)))
    return torch.stack(out)


@functools.lru_cache(maxsize=None)
def _device_constants(cfg: OrbConfig, device: torch.device):
    """_stack_constants as tensors on ``device`` (read-only)."""
    return tuple(torch.tensor(a, device=device)
                 for a in _stack_constants(cfg))


def extract_orb(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """ORB extraction for one grayscale f32 [H, W] image (0..255) on the
    image's device."""
    _, lvl, scales, hws = _device_constants(cfg, img.device)
    # TF32 would move FAST decisions: the resize products stay full f32
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        stack = build_stack(img.to(torch.float32), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_cudnn

    xy_i, resp, valid = _select_keypoints_stacked(fast_score_map(stack), cfg)
    # integer-rounded blur: camera images are uint8, so rounding keeps the
    # pattern comparisons' ties as OpenCV resolves them
    blur_stack = torch.round(gaussian_blur(stack))
    ang, desc = cuda_orb_desc.ic_brief(stack, blur_stack, xy_i, lvl, hws)
    xy = xy_i.to(torch.float32) * scales[:, None]

    padn = cfg.capacity - xy.shape[0]
    if padn > 0:
        xy = F.pad(xy, (0, 0, 0, padn))
        lvl = F.pad(lvl, (0, padn))
        ang = F.pad(ang, (0, padn))
        resp = F.pad(resp, (0, padn))
        desc = F.pad(desc, (0, 0, 0, padn))
        valid = F.pad(valid, (0, padn))
    return Features(xy=xy, uv=xy, level=lvl, angle=ang, response=resp,
                    desc=desc, valid=valid)


def with_undistorted(feats: Features, cam: cam_mod.Camera) -> Features:
    """Fill uv (match space): undistorted for pinhole (span
    ``extract.undistort``), raw for KB8."""
    if cam.kind == cam_mod.PINHOLE:
        with TRACER.span("extract.undistort"):
            return feats._replace(uv=cam_mod.undistort_points(cam, feats.xy))
    return feats._replace(uv=feats.xy)
