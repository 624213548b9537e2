#!/usr/bin/env python3
"""Run chip_smoke.py's phase 10b (the yaw burst with IMU) under several
orders of the solvers' segment sums, in one process on the card, to see
how far the order alone moves its figures.

    python3 tools/phase10b_orders.py [--shuffles N] [--atomic N] [--check]
                                     [--lba-iters LM POLISH]

First the port's own order (``ops/segsum.py``); then N orders in which
every plan takes each segment's rows in a seeded random order (the same
kernel, another rounding of the same sums); then N runs with the sums
done by ``index_add_`` on the card (atomics: an order that changes from
run to run, as before the fixed-order sums).  With ``--check`` the
port's order runs once more with every segment sum held to its plain
version bit for bit and to a float64 sum.  ``--lba-iters`` sets the
local BA's iteration budget (to see whether a converged local BA
removes the spread).  Per run it prints the
IMU_INIT frame, the estimated scale (map units) and gravity, the scale
error against the Umeyama scale, the gravity error against the room's
(carried into the map frame by the Umeyama rotation of the whole
trajectory) and ATE / span.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mam3slam_tpu_torch import _build  # noqa: E402
from mam3slam_tpu_torch.geometry import cameras  # noqa: E402
from mam3slam_tpu_torch.io import render  # noqa: E402
from mam3slam_tpu_torch.ops import orb as O  # noqa: E402
from mam3slam_tpu_torch.ops import segsum  # noqa: E402
from mam3slam_tpu_torch.slam import system  # noqa: E402

PLAN, SUM = segsum.segment_plan, segsum.segment_sum


def shuffled_plans(seed: int):
    """Plans whose segments hold their rows in a seeded random order."""
    gen = torch.Generator().manual_seed(seed)

    def plan(index, n_out):
        idx = index.reshape(-1)
        p = torch.randperm(idx.shape[0], generator=gen).to(idx.device)
        pl = PLAN(idx[p], n_out)
        return pl._replace(perm=p[pl.perm.long()].to(torch.int32))
    return plan


def atomic_sum(plan, vals):
    """The plan's sum by ``index_add_`` (atomics on the card)."""
    length = (plan.end - plan.start).long()
    sorted_idx = torch.repeat_interleave(plan.key.long(), length)
    idx = torch.full(plan.perm.shape, plan.n_out, dtype=torch.long,
                     device=vals.device)
    idx[plan.perm[:sorted_idx.shape[0]].long()] = sorted_idx
    flat = vals.reshape(vals.shape[0], -1)
    out = torch.zeros(plan.n_out + 1, flat.shape[1], dtype=vals.dtype,
                      device=vals.device).index_add_(0, idx, flat)
    return out[:plan.n_out].reshape((plan.n_out,) + vals.shape[1:])


def checked_sum(stats: dict):
    """The port's segment sum, each call also held to its plain version
    (bit for bit) and to a float64 sum of the same rows."""
    def seg(plan, vals):
        got = SUM(plan, vals)
        plain = segsum.segment_sum_plain(plan, vals)
        exact = atomic_sum(plan, vals.double())
        stats["calls"] += 1
        stats["apart_from_plain"] += int(not torch.equal(got, plain))
        scale = exact.abs().max().item() if exact.numel() else 0.0
        err = (got.double() - exact).abs().max().item() if got.numel() \
            else 0.0
        stats["max_rel_err"] = max(stats["max_rel_err"],
                                   err / max(scale, 1e-30))
        return got
    return seg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shuffles", type=int, default=8)
    ap.add_argument("--atomic", type=int, default=4)
    ap.add_argument("--lba-iters", type=int, nargs=2, metavar=("LM", "POLISH"),
                    help="the local BA's LM and polish iterations "
                    "(SlamConfig.lba_iters / lba_polish_iters; default "
                    "theirs)")
    ap.add_argument("--check", action="store_true",
                    help="first rerun the port's order with every segment "
                    "sum held to its plain version and to float64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase10b_orders: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    _build.library()
    cam_r = render.RenderCam(cs.W, cs.H, cs.FX, cs.FY, cs.CX, cs.CY)
    orb_cfg = O.OrbConfig(height=cs.H, width=cs.W, n_features=cs.N_FEATURES)
    cfg = system.SlamConfig(width=cs.W, height=cs.H, n_feat=orb_cfg.capacity,
                            **({} if args.lba_iters is None else dict(
                                lba_iters=args.lba_iters[0],
                                lba_polish_iters=args.lba_iters[1])))
    cs.log("burst_config", lba_iters=cfg.lba_iters,
           lba_polish_iters=cfg.lba_polish_iters)
    cam = cameras.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY, device=dev)
    scene = render.RoomScene(seed=cs.SERVER_SCENE_SEED, device=dev)
    motion = cs.OrbitMotion(cs.BURST_FRAMES, 0.0,
                            0.8 * (cs.BURST_FRAMES - 1), bob=cs.LOOP_ARC[2],
                            burst=(cs.BURST_AT, cs.BURST_LEN, cs.BURST_DEG),
                            shake=cs.BURST_SHAKE)
    traj, imus = motion.frames(), motion.imu(11)
    stats = dict(calls=0, apart_from_plain=0, max_rel_err=0.0)
    runs = ([("fixed", PLAN, SUM)]
            + ([("fixed_checked", PLAN, checked_sum(stats))] if args.check
               else [])
            + [(f"shuffle{k}", shuffled_plans(k), SUM)
               for k in range(1, args.shuffles + 1)]
            + [(f"atomic{k}", PLAN, atomic_sum) for k in range(args.atomic)])
    for name, plan_fn, sum_fn in runs:
        segsum.segment_plan, segsum.segment_sum = plan_fn, sum_fn
        t = time.time()
        try:
            r = cs.run_inertial(dev, scene, cam_r, cam, orb_cfg, cfg, traj,
                                imus)
        finally:
            segsum.segment_plan, segsum.segment_sum = PLAN, SUM
        res = cs.inertial_results(r, traj)
        a = r["sys"].agents[r["aid"]]
        cs.log("burst_order", run=name, init_frame=res["init_frame"],
               imu_scale=res.get("imu_scale"),
               gravity_w=np.round(np.asarray(a.gravity_w, np.float64),
                                  5).tolist() if a.gravity_w is not None
               else None, scale_err=res.get("scale_err"),
               gravity_deg=res.get("gravity_deg"),
               ate_frac=res.get("ate_frac"), ok_frac=res.get("ok_frac"),
               n_fallback=a.n_fallback,
               bounds=(cs.BURST_MAX_SCALE_ERR, cs.BURST_MAX_GRAVITY_DEG),
               s=round(time.time() - t, 1), card=repr(smi),
               **(stats if name == "fixed_checked" else {}))
        del r
    return 0


if __name__ == "__main__":
    sys.exit(main())
