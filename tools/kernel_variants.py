#!/usr/bin/env python3
"""Device time of variants of the port's kernels, each made by a text
substitution of this tree's ``csrc/`` and built as a library of its own,
to see what part of a kernel costs what and which block shape is fastest.

    python3 tools/kernel_variants.py     (needs a CUDA device)

Describe, at N = 100 and 1000 keypoints of an EuRoC-size stack:
``full`` (as committed); ``no_angle_math`` (no atan2f / cosf / sinf);
``no_moment_loads`` (the 31 rows of the circle not loaded);
``no_gathers`` (the 16 rBRIEF taps not loaded); ``empty`` (each warp
writes zeros: the launch).  The variants compute wrong results on
purpose; only their times are read.  Best-two (``min_hamming2``), at
Q = M = 1024 and 4096 with ~60% valid on each side: the committed 16
warps x chunks of 8 tiles against 8 x 16 and 32 x 4 (same results; each
is checked against the plain version).  Two rounds, variants in turn;
device times from chip_smoke.device_ms (torch.profiler), with the card's
nvidia-smi name and power limit first.  Sources go under build/variants/.
"""

import os
import shutil
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import ab_frames as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402
from mam3slam_tpu_torch import _build  # noqa: E402

_TAP1 = ("va[r] = bl[(size_t)clampi(y + ry1, 0, h - 1) * Wp +\n"
         "               clampi(x + rx1, 0, w - 1)];")
_TAP2 = ("vb[r] = bl[(size_t)clampi(y + ry2, 0, h - 1) * Wp +\n"
         "               clampi(x + rx2, 0, w - 1)];")
DESCRIBE = {
    "full": [],
    "no_angle_math": [
        ("const float ang = atan2f(m01, m10);",
         "const float ang = 1e-30f * (m01 + m10);"),
        ("const float ca = cosf(ang), sa = sinf(ang);",
         "const float ca = 1.f + ang, sa = ang;")],
    "no_moment_loads": [
        ("v[i] = col[(size_t)clampi(y + i - kR, 0, Hp - 1) * Wp];",
         "v[i] = (float)(x + i);")],
    "no_gathers": [(_TAP1, "va[r] = (float)(rx1 + ry1);"),
                   (_TAP2, "vb[r] = (float)(rx2 - ry2);")],
    "empty": [("  // the pattern pairs of the 8 rounds",
               "  if (lane == 0) angle[n] = 0.f;\n"
               "  if (lane < 8) desc[8 * n + lane] = 0u;\n"
               "  return;\n"
               "  // the pattern pairs of the 8 rounds")],
}
BEST2 = {"16x8": (16, 8), "8x16": (8, 16), "32x4": (32, 4)}


def variant(name: str, file: str, subs) -> str:
    """A csrc/ copy under build/variants/NAME with SUBS applied to FILE."""
    out = os.path.join(REPO, "build", "variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    path = os.path.join(out, file)
    with open(path) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {file} no longer holds {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch.ops import cuda_match as CM
    from mam3slam_tpu_torch.ops import cuda_orb_desc as CO
    from mam3slam_tpu_torch.ops import orb as O

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    rng = np.random.default_rng(0)

    def T(x):
        return torch.tensor(x, device=dev)

    cfg = O.OrbConfig(cs.H, cs.W, n_features=cs.N_FEATURES)
    stack = O.build_stack(T(rng.uniform(0, 255, (cs.H, cs.W)).astype(
        np.float32)), cfg)
    blur = torch.round(O.gaussian_blur(stack))
    kps = {}
    for n in (100, 1000):
        lvl = rng.integers(0, cfg.n_levels, n)
        hw = np.asarray(cfg.level_sizes)[lvl]
        xy = np.stack([rng.random(n) * hw[:, 1], rng.random(n) * hw[:, 0]],
                      1).astype(np.int32)
        kps[n] = (stack, blur, T(xy), T(lvl.astype(np.int32)),
                  T(hw.astype(np.int32)))
    pairs = {n: (T(rng.integers(0, 256, (n, 32), dtype=np.uint8)),
                 T(rng.random(n) < 0.6),
                 T(rng.integers(0, 256, (n, 32), dtype=np.uint8)),
                 T(rng.random(n) < 0.6)) for n in (1024, 4096)}

    libs = {("orb_desc", k): ab.build_library(variant(
        "desc_" + k, "orb_desc.cu", subs))[0] for k, subs in DESCRIBE.items()}
    for k, (warps, chunk) in BEST2.items():
        subs = [("constexpr int kB2Warps = 16;",
                 f"constexpr int kB2Warps = {warps};"),
                ("constexpr int kChunk = 8;",
                 f"constexpr int kChunk = {chunk};")]
        libs[("min_hamming2", k)] = ab.build_library(variant(
            "best2_" + k, "match.cu", subs))[0]
    for (kernel, k), lib in libs.items():
        if kernel == "min_hamming2":
            _build._lib = lib
            plain = CM.min_hamming2_plain(*pairs[1024])
            if not all(torch.equal(a, b) for a, b in zip(
                    CM.min_hamming2(*pairs[1024]), plain)):
                raise AssertionError(f"min_hamming2 {k} disagrees")
    for rnd in range(2):
        for (kernel, k), lib in libs.items():
            _build._lib = lib
            cases = kps if kernel == "orb_desc" else pairs
            for n, args in cases.items():
                fn = ((lambda: CO.ic_brief(*args)) if kernel == "orb_desc"
                      else (lambda: CM.min_hamming2(*args)))
                ms, timer, _ = cs.device_ms(fn, reps=50)
                cs.log(kernel, variant=k, round=rnd, n=n,
                       device_us=ms * 1e3, timer=timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
