#!/usr/bin/env python3
"""Half-size CPU rehearsal of chip_smoke.py phase 6 against the reference.

    python3 tools/chip_rehearsal.py [--loop] [--threads N]

Renders phase 6's frames at half size (376x240, half the EuRoC cam0
intrinsics, 500 features; arena caps 128 KF / 12288 MP, the other
``SlamConfig`` and ``ServerConfig`` fields at their defaults) and feeds
each frame to two systems in lockstep: the JAX package's ``SlamSystem`` +
``LoopServer`` (JAX ``extract_orb`` + ``with_undistorted``) and the port's
(``chip_smoke.frame_of``).  Default: 6a, the two-agent merge arcs;
``--loop``: 6b, the one-agent loop arc.  Prints, per package, the server
and system events and per agent the share of frames OK after init and the
ATE after Sim3 alignment as a fraction of the arc's span: the figures
from which chip_smoke.py's ATE bounds are derived.  Imports JAX, so it is
not part of the port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mam3slam_tpu.geometry import cameras as jcam  # noqa: E402
from mam3slam_tpu.ops import orb as jorb  # noqa: E402
from mam3slam_tpu.slam import server as jserver  # noqa: E402
from mam3slam_tpu.slam import steps as jsteps  # noqa: E402
from mam3slam_tpu.slam import system as jsystem  # noqa: E402
from mam3slam_tpu_torch.geometry import cameras  # noqa: E402
from mam3slam_tpu_torch.io import render  # noqa: E402
from mam3slam_tpu_torch.ops import orb as O  # noqa: E402
from mam3slam_tpu_torch.slam import server as tserver  # noqa: E402
from mam3slam_tpu_torch.slam import system as tsystem  # noqa: E402

W, H = cs.W // 2, cs.H // 2
FX, FY, CX, CY = cs.FX / 2, cs.FY / 2, cs.CX / 2, cs.CY / 2
N_FEATURES = 500
MAX_KF, MAX_MP = 128, 12288


def summary(name, sys_, aids, arcs, states, ok_code):
    """Events, and per agent the OK share after init and ATE / span."""
    print(f"[{name}] server_events={sys_.server.events}", flush=True)
    print(f"[{name}] system_events={sys_.events}", flush=True)
    for a, (aid, arc) in enumerate(zip(aids, arcs)):
        est, gt = [], []
        for ts, _, t_wc, st in sys_.trajectory_world(aid):
            if st == ok_code:
                est.append(np.asarray(t_wc))
                gt.append(arc[int(round(ts / cs.DT))][2])
        est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
        span = float(np.ptp(gt, axis=0).max())
        ate = cs.ate_rmse(est, gt)
        st = states[a][states[a].index(ok_code):]
        ok_frac = float(np.mean(np.equal(st, ok_code)))
        print(f"[{name}] agent={a} ok_frac={ok_frac:.4f} "
              f"ate_frac={ate / span:.5f} map={sys_.agents[aid].map_id}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loop", action="store_true",
                    help="phase 6b (the loop arc) instead of 6a")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    if args.loop:
        specs = [(cs.LOOP_FRAMES, cs.LOOP_ARC)]
    else:
        specs = [(cs.MERGE_FRAMES, arc) for arc in cs.MERGE_ARCS]
    arcs = [render.orbit_trajectory(n, a0, a1, radius=2.5, bob=b)
            for n, (a0, a1, b) in specs]
    cam_r = render.RenderCam(W, H, FX, FY, CX, CY)
    scene = render.RoomScene(seed=cs.SERVER_SCENE_SEED, device="cpu")
    orb_cfg = O.OrbConfig(height=H, width=W, n_features=N_FEATURES)

    tcam = cameras.make_pinhole(FX, FY, CX, CY, device="cpu")
    tsys_ = tsystem.SlamSystem(
        tsystem.SlamConfig(width=W, height=H, n_feat=orb_cfg.capacity,
                           max_kf=MAX_KF, max_mp=MAX_MP), tcam, seed=0)
    tsys_.server = tserver.LoopServer(tsys_, tserver.ServerConfig())

    jcam_ = jcam.make_pinhole(FX, FY, CX, CY)
    jorb_cfg = jorb.OrbConfig(height=H, width=W, n_features=N_FEATURES)
    jsys_ = jsystem.SlamSystem(
        jsystem.SlamConfig(width=W, height=H, n_feat=jorb_cfg.capacity,
                           max_kf=MAX_KF, max_mp=MAX_MP), jcam_, seed=0)
    jsys_.server = jserver.LoopServer(jsys_, jserver.ServerConfig())

    @jax.jit
    def jextract(img):
        return jorb.with_undistorted(jorb.extract_orb(img, jorb_cfg), jcam_)

    taids = [tsys_.add_agent() for _ in arcs]
    jaids = [jsys_.add_agent() for _ in arcs]
    tstates, jstates = [[] for _ in arcs], [[] for _ in arcs]
    t0 = time.perf_counter()
    for i in range(len(arcs[0])):
        for k, arc in enumerate(arcs):
            R, t, _ = arc[i]
            img = scene.render(R, t, cam_r)
            tstates[k].append(tsys_.track(
                taids[k], cs.frame_of(img, orb_cfg, tcam), i * cs.DT)[0])
            f = jextract(jnp.asarray(img.numpy()))
            jstates[k].append(jsys_.track(
                jaids[k], jsteps.FrameObs(f.uv, f.level, f.angle, f.desc,
                                          f.valid), i * cs.DT)[0])
        if i % 50 == 0:
            print(f"[progress] frame={i} s={time.perf_counter() - t0:.1f}",
                  flush=True)
    print(f"[setup] phase={'6b' if args.loop else '6a'} size={W}x{H} "
          f"features={N_FEATURES} caps={MAX_KF}/{MAX_MP} "
          f"frames={len(arcs[0])}x{len(arcs)} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    summary("reference", jsys_, jaids, arcs, jstates, jsystem.OK)
    summary("port", tsys_, taids, arcs, tstates, tsystem.OK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
