"""Readings of the comparison on the card at a cell's own size, for the
limits: for each seed, the cell's frames rendered from the seed and one
whole mission flown on a fresh system (no warm-up, no window), then
every number the check compares.  With ``--fault`` a fault of
``faults.py`` is planted in the program for the mission; without it the
line also holds the control: the plain reference computed in bfloat16
(``ref/orb.py``) put in the program's place, on the same sampled
keyframes' frames, which the comparison must reject.  The benchmark's
own runs never run this.

    python3 slambench/control.py --workload <cell> --seeds 11 12 13 \\
        [--fault ba_unchanged] > out.jsonl
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MISSION_LIMIT_S = 240.0


def readings(cell, seed: int, device, fault=None) -> dict:
    """The program's numbers for one seed's mission, under ``fault``, and
    without one the bfloat16 control's."""
    import torch

    from slambench import check, faults, harness, traffic

    agents = traffic.make_agents(cell.traffic, cell.config, seed, device)
    with tempfile.TemporaryDirectory(prefix="slambench_") as tmp:
        yaml_path = os.path.join(tmp, "settings.yaml")
        with open(yaml_path, "w") as f:
            f.write(harness.settings_yaml(cell.config["settings"]))
        t = time.perf_counter()
        with faults.planted(fault):
            mas, states, complete = harness.fly(
                cell, agents, yaml_path, device,
                time.perf_counter() + MISSION_LIMIT_S, None, [], 0)
            rec = harness.close(mas, states, complete)
        del mas
        mission_s = time.perf_counter() - t
    settings = cell.config["settings"]
    scales = harness.ref_orb.OrbConfig(
        8, 8, n_levels=int(settings["ORBextractor.nLevels"]),
        scale_factor=float(settings["ORBextractor.scaleFactor"])).scales
    orb_cfg = harness.orb_config(settings)
    verdict = check.run_check([rec], agents, cell.config, cell.traffic, seed,
                              orb_cfg, scales)
    out = dict(workload=cell.name, seed=seed, fault=fault,
               correct=verdict["correct"], complete=complete,
               mission_s=mission_s, events=rec.events,
               program={n: v for n, v, _ in verdict["rows"]},
               faults=verdict["faults"], agents=verdict["detail"])
    if fault is None:
        out["control"] = check.control_readings(
            [rec], agents, orb_cfg, scales, seed,
            int(cell.config["orb_samples_per_mission"]), torch.bfloat16)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from slambench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from mam3slam_tpu_torch import _build

    dev = torch.device("cuda", 0)
    _build.library()
    harness.warm_libraries(dev)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, dev, args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
