"""Headless map / trajectory views, with no image library.

Port of ``mam3slam_tpu.io.viewer`` (the reference's Pangolin viewers
``MapDrawer`` / ``FrameDrawer`` / ``AgentViewer``, SURVEY.md §2.7):

* ``map_snapshot``: the JSON snapshot behind the interactive ``/map3d``
  page: points, KF frusta, covisibility edges and trajectories.
* ``draw_tracking_tensor`` / ``draw_tracking_frame`` /
  ``render_tracking_frame``: the annotated tracking image (FrameDrawer):
  tracked keypoints as a green 7x7 square and dot, unmatched ones as a
  blue dot, and the state banner, drawn in tensor ops on the system's
  device with the pixel sets of cv2's ``rectangle`` and filled
  ``circle`` and a 5x7 bitmap font of the port's own.
* ``draw_map_image`` / ``render_map``: a top view (x, z) of the
  snapshot's points and segments, rasterised in numpy with axes, ticks,
  a title and a legend.

A reader in another thread (the daemon's map view) holds one reference
to the map state (updates replace it, never write into it) and takes the
system's ``_ms_lock`` when a mapping worker runs.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import lie
from mam3slam_tpu_torch.io import images

# 5x7 glyphs: seven rows of five bits, the leftmost pixel the highest bit
_GLYPHS = {
    "A": "0E11111F111111", "B": "1E11111E11111E", "C": "0E11101010110E",
    "D": "1E11111111111E", "E": "1F10101E10101F", "F": "1F10101E101010",
    "G": "0E11101711110F", "H": "1111111F111111", "I": "0E04040404040E",
    "J": "0702020202120C", "K": "11121418141211", "L": "1010101010101F",
    "M": "111B1515111111", "N": "11111915131111", "O": "0E11111111110E",
    "P": "1E11111E101010", "Q": "0E11111115120D", "R": "1E11111E141211",
    "S": "0F10100E01011E", "T": "1F040404040404", "U": "1111111111110E",
    "V": "11111111110A04", "W": "1111111515150A", "X": "11110A040A1111",
    "Y": "11110A04040404", "Z": "1F01020408101F",
    "0": "0E11131519110E", "1": "040C040404040E", "2": "0E11010204081F",
    "3": "1F02040201110E", "4": "02060A121F0202", "5": "1F101E0101110E",
    "6": "0608101E11110E", "7": "1F010204080808", "8": "0E11110E11110E",
    "9": "0E11110F01020C",
    "a": "00000E010F110F", "b": "1010161911111E", "c": "00000E1010110E",
    "d": "01010D1311110F", "e": "00000E111F100E", "f": "0609081C080808",
    "g": "000F11110F010E", "h": "10101619111111", "i": "04000C0404040E",
    "j": "0200060202120C", "k": "10101214181412", "l": "0C04040404040E",
    "m": "00001A15151111", "n": "00001619111111", "o": "00000E1111110E",
    "p": "00001E111E1010", "q": "00000D130F0101", "r": "00001619101010",
    "s": "00000E100E011E", "t": "08081C08080906", "u": "0000111111130D",
    "v": "00001111110A04", "w": "0000111115150A", "x": "0000110A040A11",
    "y": "000011110F010E", "z": "00001F0204081F",
    " ": "00000000000000", "|": "04040404040404", ":": "000C0C000C0C00",
    "?": "0E110102040004", "-": "0000001F000000", ".": "00000000000C0C",
    ",": "000000000C0408", "(": "02040808080402", ")": "08040202020408",
    "[": "0E08080808080E", "]": "0E02020202020E", "/": "00010204081000",
    "=": "00001F001F0000", "_": "0000000000001F", "+": "0004041F040400",
    "%": "18190204081303",
}
_FONT = {ch: np.array([[(int(hexrows[2 * r:2 * r + 2], 16)
                         >> (4 - c)) & 1 for c in range(5)]
                       for r in range(7)], bool)
         for ch, hexrows in _GLYPHS.items()}
GLYPH_W, GLYPH_H = 6, 7   # advance (5 columns + 1 of spacing) and height
_CELLS = {ch: np.pad(g, ((0, 0), (0, 1))) for ch, g in _FONT.items()}

_STATE_TEXT = {0: "WAITING FOR IMAGES", 1: "TRYING TO INITIALIZE",
               2: "SLAM", 3: "RECENTLY LOST", 4: "LOST"}
# matplotlib's tab10, as BGR
_TAB10 = np.array([(180, 119, 31), (14, 127, 255), (44, 160, 44),
                   (40, 39, 214), (189, 103, 148), (75, 86, 140),
                   (194, 119, 227), (127, 127, 127), (34, 189, 188),
                   (207, 190, 23)], np.uint8)


def text_mask(text: str, scale: int = 1) -> np.ndarray:
    """[7 s, 6 s len(text)] bool pixels of ``text`` in the 5x7 font at
    integer ``scale`` (a character outside the font draws as '?')."""
    if not text:
        return np.zeros((GLYPH_H * scale, 0), bool)
    m = np.concatenate([_CELLS.get(ch, _CELLS["?"]) for ch in text], axis=1)
    return np.repeat(np.repeat(m, scale, axis=0), scale, axis=1)


def put_text(img: np.ndarray, text: str, x: int, baseline: int,
             color, scale: int = 1) -> None:
    """Draw ``text`` into ``img`` [H, W, 3] with its left edge at ``x``
    and its last pixel row at ``baseline`` (clipped to the image)."""
    m = text_mask(text, scale)
    y0 = baseline - m.shape[0] + 1
    ys, xs = np.nonzero(m)
    ys, xs = ys + y0, xs + x
    ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[ok], xs[ok]] = color


def _snapshot(system):
    """One consistent view of the system for a reader in any thread: the
    map state it holds and each agent's world trajectory against it."""
    lock = (system._ms_lock if getattr(system, "async_mapping", False)
            else contextlib.nullcontext())
    with lock:
        ms = system.ms
        trajs = [system.trajectory_world(a.agent_id, ms=ms)
                 for a in system.agents]
    return ms, trajs


def map_snapshot(system, server=None, max_points: int = 4000,
                 max_covis: int = 400) -> dict:
    """JSON-serializable 3D snapshot of the atlas for the interactive
    browser viewer (``MjpegServer`` ``/map3d``): ``points`` [N, 3] with a
    map id each (``pmap``), ``segs`` [M, 6] line segments (KF frusta,
    covisibility edges of weight >= 30, trajectories) with a class each
    (``scls``: 0 covisibility, 1 KF frustum, 2 + a agent a's trajectory),
    the map's ``span`` and its ``stats``.  The same numpy operations on
    the same f32 values as the reference, so the lists agree at rounding
    edges too."""
    ms, trajs = _snapshot(system)
    T_wc = lie.se3_inverse(lie.SE3(ms.kf_q, ms.kf_t))
    mp_valid = ms.mp_valid.cpu().numpy()
    pos = ms.mp_pos.cpu().numpy()[mp_valid]
    pmap = ms.mp_map.cpu().numpy()[mp_valid]
    if len(pos) > max_points:
        idx = np.linspace(0, len(pos) - 1, max_points).astype(int)
        pos, pmap = pos[idx], pmap[idx]
    C = T_wc.t.cpu().numpy()
    Rwc = lie.quat_to_matrix(T_wc.q).cpu().numpy()
    kf_valid = ms.kf_valid.cpu().numpy()

    span = 1.0
    if len(pos) > 3:
        span = float(np.median(np.linalg.norm(
            pos - np.median(pos, axis=0), axis=1))) * 2.0 + 1e-6

    segs, scls = [np.zeros((0, 6), np.float32)], []
    # KF frusta: camera centre to the 4 image-plane corners + the rectangle
    # (the reference MapDrawer::DrawKeyFrames draws the same 8 lines):
    # (centre, corner i), (corner i, corner i + 1) for i = 0..3
    w = 0.06 * span
    h, z = 0.045 * span, 0.075 * span
    corners_c = np.array([[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
                         np.float32)
    for k in np.flatnonzero(kf_valid):
        cw = (Rwc[k] @ corners_c.T).T + C[k]
        rays = np.concatenate([np.broadcast_to(C[k], (4, 3)), cw], 1)
        rim = np.concatenate([cw, np.roll(cw, -1, axis=0)], 1)
        segs.append(np.stack([rays, rim], 1).reshape(8, 6))
        scls += [1] * 8

    covis = ms.covis.cpu().numpy()
    ii, jj = np.where(np.triu(covis, 1) >= 30)
    ii, jj = ii[:max_covis], jj[:max_covis]
    both = kf_valid[ii] & kf_valid[jj]
    segs.append(np.concatenate([C[ii[both]], C[jj[both]]], 1))
    scls += [0] * int(both.sum())

    for a, traj in zip(system.agents, trajs):
        pts = np.array([t for _, _, t, st in traj if st == 2],
                       np.float32).reshape(-1, 3)
        segs.append(np.concatenate([pts[:-1], pts[1:]], 1))
        scls += [2 + a.agent_id] * max(len(pts) - 1, 0)

    def rnd(arr, nd=4):
        return np.round(np.asarray(arr, np.float64), nd)

    return {
        "points": rnd(pos).tolist(),
        "pmap": np.asarray(pmap, int).tolist(),
        "segs": rnd(np.concatenate(segs)).tolist(),
        "scls": [int(c) for c in scls],
        "span": round(span, 4),
        "stats": {"kfs": int(kf_valid.sum()), "mps": int(mp_valid.sum()),
                  "agents": len(system.agents)},
    }


# ---------------------------------------------------------------------------
# the tracking frame (FrameDrawer)
# ---------------------------------------------------------------------------

# offsets (dy, dx) of cv2.rectangle((x-3, y-3), (x+3, y+3), thickness=1)
# and of the filled cv2.circle of radius 1
_RECT = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4)
         if abs(dy) == 3 or abs(dx) == 3]
_DOT = [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]
_GREEN, _BLUE = (0, 200, 0), (200, 120, 0)


@functools.lru_cache(maxsize=None)
def _marks(device: torch.device):
    """The marks' pixel offsets [31, 2] and their colours (green, blue)
    on ``device``."""
    return (torch.tensor(_RECT + _DOT, device=device),
            torch.tensor([_GREEN, _BLUE], dtype=torch.uint8, device=device))


def banner_text(system, agent_id: int, n_kf: int, n_mp: int,
                n_tracked: int) -> str:
    a = system.agents[agent_id]
    state = _STATE_TEXT.get(a.state, "?")
    return (f"{state} | agent {agent_id} map {a.map_id} | "
            f"KFs: {n_kf}  MPs: {n_mp}  matches: {n_tracked}")


def draw_tracking_tensor(system, agent_id: int, image) -> torch.Tensor:
    """Annotated tracking image of ``image`` (gray [H, W], u8 or f32
    0..255; numpy or a tensor) with the agent's last frame, as a BGR u8
    tensor [H + 22, W, 3] on the system's device: features tracking a map
    point as a green 7x7 square and dot, the others as a blue dot
    (centres off the image skipped; where marks overlap, the later
    keypoint's wins, and a keypoint's dot over its square, as cv2 draws
    them one after another), and a 22-row banner with the state and the
    map's counts.  The raster is tensor ops where the keypoints lie; the
    banner's three counts are the one read back."""
    a = system.agents[agent_id]
    ms = system.ms
    dev = ms.kf_valid.device
    img = torch.as_tensor(image).to(dev)
    gray = (img if img.dtype == torch.uint8 else
            torch.clamp(img.to(torch.float32), 0, 255).to(torch.uint8))
    H, W = gray.shape
    bgr = gray[..., None].expand(H, W, 3).contiguous()
    n_tracked = torch.zeros((), dtype=torch.int64, device=dev)
    if a.last_frame is not None:
        uv, valid = a.last_frame.uv, a.last_frame.valid
        fmp = (a.last_feat_mp if a.last_feat_mp is not None
               else torch.full(valid.shape, -1, device=dev))
        xy = torch.round(uv).to(torch.int64)
        inside = valid & (xy[:, 0] >= 0) & (xy[:, 0] < W) & (
            xy[:, 1] >= 0) & (xy[:, 1] < H)
        tracked = inside & (fmp >= 0)
        n_tracked = tracked.sum()
        # every keypoint's candidate pixels in drawing order (square, then
        # dot), keypoint after keypoint; each pixel keeps its last write
        offs, colours = _marks(dev)
        use = torch.cat([tracked[:, None].expand(-1, len(_RECT)),
                         inside[:, None].expand(-1, len(_DOT))], 1)
        py = xy[:, 1, None] + offs[None, :, 0]
        px = xy[:, 0, None] + offs[None, :, 1]
        keep = (use & (py >= 0) & (py < H) & (px >= 0) & (px < W)).reshape(-1)
        flat = (py * W + px).reshape(-1)
        order = torch.arange(len(flat), device=dev)
        last = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, flat[keep], order[keep], reduce="amax")
        win = keep & (last[flat.clamp(0, H * W - 1)] == order)
        col = colours[(~tracked).to(torch.int64)]
        owner = torch.arange(len(xy), device=dev).repeat_interleave(
            len(offs))
        bgr.view(-1, 3)[flat[win]] = col[owner[win]]
    counts = torch.stack([ms.kf_valid.sum(), ms.mp_valid.sum(),
                          n_tracked]).tolist()
    bar = np.zeros((22, W, 3), np.uint8)
    put_text(bar, banner_text(system, agent_id, *counts), 6, 15,
             (255, 255, 255))
    return torch.cat([bgr, torch.from_numpy(bar).to(dev)], 0)


def draw_tracking_frame(system, agent_id: int,
                        image: np.ndarray) -> np.ndarray:
    """``draw_tracking_tensor`` as a BGR u8 numpy image [H + 22, W, 3]
    (the reference FrameDrawer, src/FrameDrawer.cc:1-489)."""
    return draw_tracking_tensor(system, agent_id, image).cpu().numpy()


def render_tracking_frame(system, agent_id: int, image: np.ndarray,
                          path: str):
    """``draw_tracking_frame`` written to ``path`` as PNG."""
    images.write_png(path, draw_tracking_frame(system, agent_id, image))


# ---------------------------------------------------------------------------
# the map view (MapDrawer)
# ---------------------------------------------------------------------------

def _nice_step(extent: float, n: int = 6) -> float:
    raw = max(extent, 1e-9) / n
    p = 10.0 ** math.floor(math.log10(raw))
    return next(m * p for m in (1, 2, 5, 10) if m * p >= raw)


def _segments(img: np.ndarray, a: np.ndarray, b: np.ndarray,
              cols: np.ndarray) -> None:
    """Draw pixel segments a[i] -> b[i] ((col, row) each) in ``cols[i]``,
    one sample per pixel step along the longer axis."""
    if not len(a):
        return
    n = np.ceil(np.abs(b - a).max(axis=1)).astype(np.int64) + 1
    owner = np.repeat(np.arange(len(a)), n)
    t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.maximum(
        n[owner] - 1, 1)
    p = np.rint(a[owner] + (b - a)[owner] * t[:, None]).astype(np.int64)
    ok = ((p[:, 0] >= 0) & (p[:, 0] < img.shape[1]) & (p[:, 1] >= 0)
          & (p[:, 1] < img.shape[0]))
    img[p[ok, 1], p[ok, 0]] = cols[owner[ok]]


def draw_map_image(system, server=None, max_points: int = 20000,
                   figsize=(7, 5.6), dpi: int = 80,
                   snapshot=None) -> np.ndarray:
    """The map seen from above (x right, z up, equal scales) as a BGR u8
    image of ``figsize`` x ``dpi`` pixels: ``map_snapshot``'s points
    coloured by map, covisibility edges, KF frusta and each agent's
    trajectory, with a frame, ticks in metres, a title with the counts and
    a legend (the live MapDrawer window's headless twin; ``MjpegServer``
    streams it on ``/map``).  ``snapshot``: a ``map_snapshot`` already
    taken, drawn instead of a new one."""
    snap = snapshot or map_snapshot(system, server=server,
                                    max_points=max_points)
    W, H = int(figsize[0] * dpi), int(figsize[1] * dpi)
    s = max(1, int(round(dpi / 80)))
    img = np.full((H, W, 3), 255, np.uint8)
    left, right, top, bottom = 8 * GLYPH_W * s, 10 * s, 14 * s, 22 * s
    pw, ph = W - left - right, H - top - bottom
    pts = np.asarray(snap["points"], np.float64).reshape(-1, 3)[:, [0, 2]]
    segs = np.asarray(snap["segs"], np.float64).reshape(-1, 6)
    ends = np.concatenate([segs[:, [0, 2]], segs[:, [3, 5]]])
    allp = np.concatenate([pts, ends])
    lo, hi = ((allp.min(0), allp.max(0)) if len(allp)
              else (np.array([-1.0, -1.0]), np.array([1.0, 1.0])))
    ext = np.maximum(hi - lo, 1e-3) * 1.05
    scale = min(pw / ext[0], ph / ext[1])
    mid = (lo + hi) / 2

    def to_px(xz):
        return np.stack([left + pw / 2 + (xz[:, 0] - mid[0]) * scale,
                         top + ph / 2 - (xz[:, 1] - mid[1]) * scale], 1)

    # grid and ticks every "nice" metre step
    grey = np.array((225, 225, 225), np.uint8)
    for axis in (0, 1):
        span_m = (pw if axis == 0 else ph) / scale
        step = _nice_step(span_m)
        first = math.ceil((mid[axis] - span_m / 2) / step)
        last = math.floor((mid[axis] + span_m / 2) / step)
        for v in (np.arange(first, last + 1) * step):
            xz = np.array([[v, mid[1]]]) if axis == 0 else np.array(
                [[mid[0], v]])
            c = int(round(to_px(xz)[0, axis]))
            label = f"{v:g}"
            if axis == 0:
                img[top:top + ph, c] = grey
                put_text(img, label, c - len(label) * GLYPH_W * s // 2,
                         top + ph + 10 * s, (0, 0, 0), s)
            else:
                img[c, left:left + pw] = grey
                put_text(img, label, left - (len(label) + 1) * GLYPH_W * s,
                         c + 3 * s, (0, 0, 0), s)
    # points (alpha 0.4 over white, as the reference's scatter), 2 x 2 s
    if len(pts):
        cols = (0.4 * _TAB10[np.asarray(snap["pmap"]) % 10] + 0.6 * 255
                ).astype(np.uint8)
        p = np.rint(to_px(pts)).astype(np.int64)
        for dy in range(2 * s):
            for dx in range(2 * s):
                q = p + (dx, dy)
                ok = ((q[:, 0] >= left) & (q[:, 0] < left + pw)
                      & (q[:, 1] >= top) & (q[:, 1] < top + ph))
                img[q[ok, 1], q[ok, 0]] = cols[ok]
    # segments: covisibility, then frusta, then trajectories on top
    scls = np.asarray(snap["scls"], np.int64)
    seg_cols = np.where((scls == 0)[:, None], (0, 160, 0),
                        np.where((scls == 1)[:, None], (60, 60, 60),
                                 _TAB10[np.maximum(scls - 2, 0) % 10]))
    for cls in (0, 1, 2):
        sel = scls == cls if cls < 2 else scls >= 2
        _segments(img, to_px(segs[sel][:, [0, 2]]), to_px(segs[sel][:, [3, 5]]),
                  seg_cols[sel].astype(np.uint8))
    # frame, title, axis names and the legend
    black = (0, 0, 0)
    img[top, left:left + pw] = img[top + ph - 1, left:left + pw] = black
    img[top:top + ph, left] = img[top:top + ph, left + pw - 1] = black
    st = snap["stats"]
    put_text(img, f"{st['kfs']} KFs, {st['mps']} MPs", left, top - 4 * s,
             black, s)
    put_text(img, "x [m]", left + pw // 2, H - 2 * s, black, s)
    put_text(img, "z [m]", 2 * s, top + 8 * s, black, s)
    for k, a in enumerate(system.agents):
        y = top + (6 + 10 * k) * s + GLYPH_H * s
        x = left + pw - 9 * GLYPH_W * s
        img[y - 4 * s:y - s, x:x + 4 * s] = _TAB10[a.agent_id % 10]
        put_text(img, f"agent {a.agent_id}", x + 6 * s, y, black, s)
    return img


def render_map(system, path: str, server=None, max_points: int = 20000):
    """``draw_map_image`` at 10 x 8 inches and 120 dpi (the reference's
    map.png) written to ``path`` as PNG."""
    images.write_png(path, draw_map_image(system, server=server,
                                          max_points=max_points,
                                          figsize=(10, 8), dpi=120))
