#!/usr/bin/env python3
"""How far apart the global BA's solutions land on phase 11a's map (GPU).

    python3 tools/gba_spread.py [--runs N]

Builds chip_smoke.py phase 11a's state on the card (four agents at the
EuRoC point, the server's global BA on a one-rank NCCL mesh), then on
the merged map solves the server's global BA several ways and prints,
for each pair, the largest keyframe-translation and point differences,
raw and after the similarity that aligns the camera centres
(``chip_smoke.gauge_diff``; points that >= 3 keyframes observe), and
each solution's robust cost:

* the single-card ``global_ba`` twice (equal bit for bit since the
  solvers' sums take a fixed order);
* the single-card epoch and ``dist_global_ba``'s dense branch on one
  rank;
* the psum-CG branch against the single-device CG (``run_window_ba``)
  and against the dense epoch, at each ``--cg-iters`` count (the server
  runs 30).

One JSON line per comparison, each with the card's nvidia-smi line (a
solution with non-finite keyframes or points is reported as such).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1,
                    help="phase-11a states to build and compare")
    ap.add_argument("--cg-iters", type=int, nargs="+", default=[30],
                    help="CG steps an LM iteration of the CG solvers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gba_spread: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch import _build
    from mam3slam_tpu_torch.geometry import cameras
    from mam3slam_tpu_torch.io import render
    from mam3slam_tpu_torch.ops import orb as O
    from mam3slam_tpu_torch.parallel import dist_window_ba as dwb
    from mam3slam_tpu_torch.parallel import mesh as pmesh
    from mam3slam_tpu_torch.slam import steps, system
    from mam3slam_tpu_torch.slam.server import ServerConfig
    from mam3slam_tpu_torch.solvers import ba_window as bw

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    _build.library()
    cam_r = render.RenderCam(cs.W, cs.H, cs.FX, cs.FY, cs.CX, cs.CY)
    orb_cfg = O.OrbConfig(height=cs.H, width=cs.W, n_features=cs.N_FEATURES)
    cfg = system.SlamConfig(width=cs.W, height=cs.H, n_feat=orb_cfg.capacity)
    cam = cameras.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY, device=dev)
    scene = render.RoomScene(seed=cs.SERVER_SCENE_SEED, device=dev)
    arcs = [render.orbit_trajectory(cs.PHASE11_FRAMES, a0, a1, radius=2.5,
                                    bob=b) for a0, a1, b in cs.PHASE11_ARCS]
    kind = cfg.cam_kind
    glob = system.programs(cfg, kind)["global_ba"]
    is2 = torch.tensor(cfg.inv_sigma2, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = pmesh.init_mesh((1,), ("shard",), "nccl",
                               f"file://{tmp}/store", device=dev)
        try:
            for run in range(args.runs):
                sys_, _ = cs.run_slam(dev, scene, cam_r, cam, orb_cfg, cfg,
                                      arcs, ServerConfig(gba_mesh=mesh))
                ms, map_id = sys_.ms, sys_.agents[0].map_id
                mask = cs.gba_mask(ms, map_id)
                sol = dict(single_a=glob(ms, map_id),
                           single_b=glob(ms, map_id),
                           dense=dwb.dist_global_ba(
                               ms, cfg, mesh, map_id, kind,
                               dense_free_cap=1 << 30))
                window = steps.build_window_problem(
                    ms, mask, is2, cfg.max_kf, cfg.max_mp, with_cm=True)
                for k in args.cg_iters:
                    sol[f"psum_cg{k}"] = dwb.dist_global_ba(
                        ms, cfg, mesh, map_id, kind, dense_free_cap=0,
                        cg_iters=k)
                    sol[f"cg_cg{k}"] = steps.apply_window_result(
                        ms, window, bw.run_window_ba(window, kind,
                                                     cg_iters=k))
                kf = ms.kf_valid.cpu().numpy()
                held = (ms.mp_valid & (ms.mp_nobs >= cs.PHASE11_MIN_OBS)
                        ).cpu().numpy()
                cost = {name: float(bw.run_window_ba_dense(
                    steps.build_window_problem(st, mask, is2, cfg.max_kf,
                                               cfg.max_mp),
                    kind, iters=0).cost) for name, st in sol.items()}
                pairs = [("single_a", "single_b"), ("dense", "single_a")]
                for k in args.cg_iters:
                    pairs += [(f"psum_cg{k}", f"cg_cg{k}"),
                              (f"psum_cg{k}", "single_a"),
                              (f"cg_cg{k}", "single_a")]
                for a, b in pairs:
                    if not all(bool(torch.isfinite(st.kf_t[ms.kf_valid]).all()
                                    and torch.isfinite(st.mp_pos[ms.mp_valid])
                                    .all()) for st in (sol[a], sol[b])):
                        # a PCG run long enough breaks down in f32
                        print(json.dumps(dict(run=run, pair=f"{a} vs {b}",
                                              card=smi, non_finite=True)),
                              flush=True)
                        continue
                    d = cs.gauge_diff(
                        tuple(x.cpu() for x in (sol[a].kf_q, sol[a].kf_t,
                                                sol[a].mp_pos)),
                        tuple(x.cpu() for x in (sol[b].kf_q, sol[b].kf_t,
                                                sol[b].mp_pos)),
                        kf, held)
                    print(json.dumps(dict(
                        run=run, pair=f"{a} vs {b}", card=smi,
                        free_keyframes=int(mask.sum()),
                        cost=(cost[a], cost[b]), **d)), flush=True)
                del sys_
        finally:
            pmesh.close_mesh()
    return 0


if __name__ == "__main__":
    sys.exit(main())
