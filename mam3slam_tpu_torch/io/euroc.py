"""EuRoC MAV dataset driver (ASL format).

Port of ``mam3slam_tpu.io.euroc`` (host code): iterates
``mav0/cam0/data.csv`` timestamps + PNGs and ground truth from
``state_groundtruth_estimate0`` for ATE evaluation.  Frames decode
through the repository's native loader (``images.native_loader``:
``native/loader.cc`` built for the host on first use and called through
ctypes, zlib PNG decode on a prefetch thread), or cv2 when asked for.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from mam3slam_tpu_torch.io import images


def load_image_index(seq_dir: str, cam: str = "cam0") -> List[Tuple[float, str]]:
    """[(timestamp_s, image_path)] from mav0/<cam>/data.csv."""
    cam_dir = os.path.join(seq_dir, "mav0", cam)
    csv_path = os.path.join(cam_dir, "data.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(
            f"not an EuRoC ASL sequence dir (no {csv_path}); expected "
            f"layout <seq>/mav0/{cam}/data.csv")
    out = []
    with open(csv_path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts_ns, fname = row[0], row[1].strip()
            out.append((int(ts_ns) * 1e-9,
                        os.path.join(cam_dir, "data", fname)))
    out.sort()
    return out


def load_groundtruth(seq_dir: str) -> np.ndarray:
    """[(t, x, y, z)] from the ground-truth CSV (for ATE)."""
    path = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0",
                        "data.csv")
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append([int(row[0]) * 1e-9] + [float(v) for v in row[1:4]])
    return np.array(rows)


def frames(seq_dir: str, cam: str = "cam0",
           max_frames: Optional[int] = None, backend: str = "native",
           max_hw: Tuple[int, int] = (1536, 2048)
           ) -> Iterator[Tuple[float, np.ndarray]]:
    """Yield (timestamp_s, grayscale f32 [H, W]) frames.

    ``backend`` "native": the native loader (``images.native_loader``;
    a failed build raises); "cv2": ``cv2.imread``.
    """
    import ctypes

    index = load_image_index(seq_dir, cam)
    if max_frames:
        index = index[:max_frames]

    if backend == "native":
        lib = images.native_loader()
        paths = (ctypes.c_char_p * len(index))(
            *[p.encode() for _, p in index])
        handle = lib.loader_open(paths, len(index), 8)
        buf = np.empty(max_hw, np.uint8)
        w = ctypes.c_int()
        h = ctypes.c_int()
        try:
            for ts, _ in index:
                rc = lib.loader_next(handle, buf.ctypes.data, buf.nbytes,
                                     ctypes.byref(w), ctypes.byref(h))
                if rc < 0:
                    break
                if rc == 0:
                    continue
                img = buf.flat[: w.value * h.value].reshape(
                    h.value, w.value).astype(np.float32)
                yield ts, img
        finally:
            lib.loader_close(handle)
        return
    if backend != "cv2":
        raise ValueError(f"unknown backend {backend!r}")
    import cv2

    for ts, path in index:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        yield ts, img.astype(np.float32)


EUROC_CAM0 = dict(  # factory calibration of EuRoC cam0 (public)
    fx=458.654, fy=457.296, cx=367.215, cy=248.375,
    dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    width=752, height=480, fps=20.0,
)


def load_sensor_yaml(seq_dir: str, cam: str = "cam0") -> Optional[dict]:
    """Per-sequence calibration from ``mav0/<cam>/sensor.yaml`` (ASL
    format, present in real EuRoC sequences and in rendered datasets from
    io/render.py).  Returns the EUROC_CAM0-shaped dict, or None."""
    path = os.path.join(seq_dir, "mav0", cam, "sensor.yaml")
    if not os.path.exists(path):
        return None

    def _floats(line: str) -> List[float]:
        body = line.split("[", 1)[1].split("]", 1)[0]
        return [float(v) for v in body.split(",") if v.strip()]

    vals = {}
    with open(path) as f:
        for line in f:
            key = line.split(":", 1)[0].strip()
            if key in ("intrinsics", "resolution",
                       "distortion_coefficients"):
                vals[key] = _floats(line)
            elif key == "rate_hz":
                vals[key] = float(line.split(":", 1)[1])
            elif key in ("camera_model", "distortion_model"):
                vals[key] = line.split(":", 1)[1].strip()
    if "intrinsics" not in vals or "resolution" not in vals:
        return None
    fu, fv, cu, cv = vals["intrinsics"][:4]
    w, h = vals["resolution"][:2]
    dist = tuple(vals.get("distortion_coefficients",
                          [0.0, 0.0, 0.0, 0.0])[:4])
    model = ("kb8" if vals.get("camera_model") == "kb8"
             or vals.get("distortion_model") == "equidistant"
             else "pinhole")
    return dict(fx=fu, fy=fv, cx=cu, cy=cv, dist=dist,
                width=int(w), height=int(h),
                fps=float(vals.get("rate_hz", 20.0)), model=model)
