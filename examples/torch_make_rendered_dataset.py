#!/usr/bin/env python
"""Generate rendered sequences in EuRoC ASL layout with the port's
renderer (PyTorch, on the card unless --cpu is given).

The port's twin of examples/make_rendered_dataset.py: the same textured
room, orbits and layout, written with the port's PNG writer:

    loop/        one agent, full 360-deg orbit  -> intra-map LOOP closure
    merge_a/     agent 0, arc   0..190 deg  \\   -> inter-agent MERGE in the
    merge_b/     agent 1, arc 170..360 deg  /      overlap regions

Drive them with the port's EuRoC script:
    python examples/torch_run_euroc.py --seq <out>/loop --out output_loop
    python examples/torch_run_euroc.py --seq <out>/merge_a --seq <out>/merge_b \\
        --out output_merge
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def jobs(n: int):
    """(name, orbit (R, t, C) per frame) of the three sequences for a
    loop of ``n`` frames (the merge arcs have 0.55 n each)."""
    from mam3slam_tpu_torch.io import render

    return [
        ("loop", render.orbit_trajectory(n, 0.0, 378.0, radius=2.5,
                                         bob=0.05)),
        ("merge_a", render.orbit_trajectory(int(n * 0.55), 0.0, 190.0,
                                            radius=2.5, bob=0.05)),
        ("merge_b", render.orbit_trajectory(int(n * 0.55), 170.0, 360.0,
                                            radius=2.5, bob=0.05)),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=240,
                    help="frames for the loop orbit (merge arcs scale)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--kb8-scale", type=float, default=None, metavar="S",
                    help="render through the reference fixture's "
                         "KannalaBrandt8 fisheye at resolution scale S "
                         "(S=1.0 -> the full 960x960 operating point, "
                         "test/settingsForTest_00.yaml) instead of the "
                         "pinhole camera")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU instead of the card")
    args = ap.parse_args()

    from mam3slam_tpu_torch.io import render

    if args.kb8_scale is not None:
        cam = render.reference_kb8_cam(scale=args.kb8_scale)
    else:
        cam = render.RenderCam(width=args.width, height=args.height,
                               fx=args.width / 2.0, fy=args.width / 2.0,
                               cx=args.width / 2.0, cy=args.height / 2.0)
    scene = render.RoomScene(seed=args.seed,
                             device="cpu" if args.cpu else "cuda")
    for name, traj in jobs(args.frames):
        seq_dir = os.path.join(args.out, name)
        print(f"rendering {name}: {len(traj)} frames -> {seq_dir}")
        render.write_asl_sequence(seq_dir, scene, traj, cam)
    print("done")


if __name__ == "__main__":
    main()
