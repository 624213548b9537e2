#!/usr/bin/env python3
"""Witness for one seed of the benchmark's ``euroc_mono.explore4`` mix:
one agent flown in company and alone, and where its scale drifts.

    python3 tools/explore4_witness.py --seed 3300000201 --agent 2 \\
        [--modes company alone] [--cpu] [--jax] [--max-kf N --max-mp N]

Renders the seed's rooms at the deployment's size
(``slambench/traffic.py``: ``configs/euroc_mono.json`` under
``traffic/explore4.json``), then flies one whole mission per mode
through the port's ``MultiAgentSystem`` as the benchmark builds it
(``slambench/harness.py``): ``company``, every agent of the mix
round-robin; ``alone``, the chosen agent's frames in a system of its
own (agent 0 there).  ``--max-kf`` / ``--max-mp`` cut the arena (a CPU
run).  With ``--jax`` (CPU only) the JAX package's ``MultiAgentSystem``
flies the same frames, from the same settings file, in the same modes:
this tool then imports JAX and is not part of the port.

Prints one JSON line a run: the package, the mode, the chosen agent's
``ate_frac``, ``map_dist_frac``, ``ate_frac_halves`` and
``scale_ratio`` (``slambench/check.py``), its first OK frame, its
keyframes, the events, a hash of every agent's trajectory (two trees
that fly a mission alike give the same), and ``scales``: the Sim3 scale of windows of 40
consecutive OK poses every 20, keyed by the window's first frame, which
shows where along the arc the scale moves.  Run it from a copy of
another tree to fly that tree's program on the same frames.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from slambench import check, harness, traffic  # noqa: E402
from slambench.ref import geometry  # noqa: E402

WINDOW, STEP = 40, 20


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scales_along(est: np.ndarray, gt: np.ndarray, frames) -> dict:
    """Sim3 scale of each window of ``WINDOW`` consecutive OK poses."""
    out = {}
    for i in range(0, len(est) - WINDOW + 1, STEP):
        _, (s, _, _), _ = geometry.ate(est[i:i + WINDOW], gt[i:i + WINDOW])
        out[int(frames[i])] = round(float(s), 5)
    return out


def lost_share(states, ok) -> float:
    if ok not in states:
        return 1.0
    after = states[states.index(ok):]
    return sum(s != ok for s in after) / len(after)


def readings(sys_, server_events, states, agents, k, ok) -> dict:
    """The check's tracking readings of one whole mission (either
    package's system): agent ``k``'s in full, the others' ``ate_frac``."""
    ms = sys_.ms
    mv = host(ms.mp_valid).astype(bool)
    rows = [[(float(ts), np.asarray(q), np.asarray(t), int(st))
             for ts, q, t, st in sys_.trajectory_world(j)]
            for j in range(len(agents))]
    # the check's OK code, whichever package's states the rows carry
    rec = check.MissionRecord(
        complete=True,
        states=[[check.OK if s == ok else -1 for s in st] for st in states],
        trajectories=[[(ts, q, t, check.OK if st == ok else -1)
                       for ts, q, t, st in r] for r in rows],
        map_ids=[a.map_id for a in sys_.agents], loops=0, merges=0,
        events=[], mp_pos=host(ms.mp_pos)[mv].astype(np.float64),
        mp_map=host(ms.mp_map)[mv], kf_ts=None, kf_agent=None, kf_uv=None,
        kf_level=None, kf_desc=None, kf_valid_feat=None)
    _, _, _, faults, detail = check.tracking_readings([rec], agents,
                                                      init_frames=10**9)
    by_agent = {d["agent"]: d for d in detail}
    ag = agents[k]
    okrows = [r for r in rows[k] if r[3] == ok]
    est = np.asarray([r[2] for r in okrows], np.float64)
    frames = [traffic.frame_of(r[0], ag.fps) for r in okrows]
    kf_valid = host(ms.kf_valid).astype(bool)
    mine = {n: v for n, v in by_agent.get(k, {}).items()
            if n not in ("mission", "agent")}
    out = dict(mine, faults=faults,
               first_ok=(states[k].index(ok) if ok in states[k] else None),
               ok_share=(float(np.mean(np.equal(states[k], ok)))
                         if states[k] else 0.0),
               keyframes=int((kf_valid & (host(ms.kf_agent) == k)).sum()),
               map_ids=rec.map_ids,
               lost_share=lost_share(states[k], ok),
               others={j: [round(d["ate_frac"], 5),
                           round(d["map_dist_frac"], 5),
                           round(lost_share(states[j], ok), 4)]
                       for j, d in by_agent.items() if j != k},
               events=list(server_events) + list(sys_.events),
               trajectory_sha=hashlib.sha256(b"".join(
                   np.asarray([ts, *q, *t, st], np.float64).tobytes()
                   for r in rows for ts, q, t, st in r)).hexdigest()[:16])
    if len(est) >= WINDOW:
        out["scales"] = scales_along(est, ag.centres[frames], frames)
    if len(est) >= 3 and hasattr(ms, "kf_agent"):
        _, (s, _, _), _ = geometry.ate(est, ag.centres[frames])
        out["kf_steps"] = keyframe_steps(sys_, ag, k, float(s))
    return out


def fly_port(config, agents, yaml_path, device):
    from mam3slam_tpu_torch.slam.system import OK

    cell = harness.Cell("witness", {}, config, {}, [], [])
    mas, states, complete = harness.fly(cell, agents, yaml_path, device,
                                        float("inf"), None, [], 0)
    assert complete
    return mas, states, OK


def keyframe_steps(sys_, ag, k, sim3_scale) -> list:
    """Agent ``k``'s live keyframes in frame order: [frame, the step from
    the previous keyframe's centre over the true step, after the whole
    trajectory's Sim3 scale]: where along the arc the map's scale moves."""
    from mam3slam_tpu_torch.slam.system import _se3_inverse_np

    ms = sys_.ms
    idx = np.nonzero(host(ms.kf_valid & (ms.kf_agent == k)))[0]
    rows = sorted((traffic.frame_of(float(host(ms.kf_ts)[j]), ag.fps),
                   _se3_inverse_np(host(ms.kf_q)[j], host(ms.kf_t)[j])[1])
                  for j in idx)
    out = []
    for (f0, c0), (f1, c1) in zip(rows[:-1], rows[1:]):
        true = np.linalg.norm(ag.centres[f1] - ag.centres[f0])
        est = np.linalg.norm(np.asarray(c1) - np.asarray(c0)) * sim3_scale
        out.append([f1, round(float(est / max(true, 1e-12)), 4)])
    return out


def fly_jax(config, agents, yaml_path):
    from mam3slam_tpu import api as japi
    from mam3slam_tpu.slam import server as jserver
    from mam3slam_tpu.slam.system import OK

    f = config["facade"]
    mas = japi.MultiAgentSystem(
        active_loop_closing=f["active_loop_closing"],
        server_config=jserver.ServerConfig(**config["server"]),
        slam_overrides=dict(config["slam"]),
        async_mapping=f["async_mapping"], pipeline=f["pipeline"])
    for _ in agents:
        mas.add_agent(yaml_path)
    frames = [a.frames.cpu().numpy() for a in agents]
    states = [[] for _ in agents]
    for k, i in traffic.schedule(agents):
        st, _ = mas.track_monocular(k, frames[k][i], i / agents[k].fps)
        states[k].append(int(st))
    mas.shutdown()
    return mas, states, OK


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--agent", type=int, required=True)
    ap.add_argument("--modes", nargs="+", default=["company", "alone"],
                    choices=["company", "alone"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--jax", action="store_true",
                    help="also fly the JAX package (CPU only)")
    ap.add_argument("--max-kf", type=int, default=None)
    ap.add_argument("--max-mp", type=int, default=None)
    args = ap.parse_args()
    if args.jax and not args.cpu:
        ap.error("--jax runs on the CPU only")
    device = torch.device("cpu" if args.cpu else "cuda")
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
    # the files, not BENCHMARK.json: an older tree's benchmark lacks the cell
    config = harness.load_json(os.path.join(ROOT, "slambench", "configs",
                                            "euroc_mono.json"))
    traf = harness.load_json(os.path.join(ROOT, "slambench", "traffic",
                                          "explore4.json"))
    config = dict(config, slam=dict(config["slam"]))
    if args.max_kf:
        config["slam"]["max_kf"] = args.max_kf
    if args.max_mp:
        config["slam"]["max_mp"] = args.max_mp
    if device.type == "cuda":
        from mam3slam_tpu_torch import _build

        _build.library()
        harness.warm_libraries(device)
    for seed in args.seed:
        fly_seed(args, config, traf, seed, device)
    return 0


def fly_seed(args, config, traf, seed, device) -> None:
    t = time.perf_counter()
    agents = traffic.make_agents(traf, config, seed, device)
    harness.sync(device)
    print(f"[render] {len(agents)} agents, {time.perf_counter() - t:.1f} s",
          file=sys.stderr, flush=True)
    k = args.agent
    packages = ["port"] + (["jax"] if args.jax else [])
    with tempfile.TemporaryDirectory(prefix="witness_") as tmp:
        yaml_path = os.path.join(tmp, "settings.yaml")
        with open(yaml_path, "w") as f:
            f.write(harness.settings_yaml(config["settings"]))
        for mode in args.modes:
            group = agents if mode == "company" else [agents[k]]
            kk = k if mode == "company" else 0
            for pkg in packages:
                t = time.perf_counter()
                if pkg == "port":
                    mas, states, ok = fly_port(config, group, yaml_path,
                                               device)
                else:
                    mas, states, ok = fly_jax(config, group, yaml_path)
                events = mas.server.events if mas.server is not None else []
                out = dict(package=pkg, tree=ROOT, mode=mode, seed=seed,
                           agent=k, device=str(device),
                           arena=[config["slam"]["max_kf"],
                                  config["slam"]["max_mp"]],
                           seconds=round(time.perf_counter() - t, 1),
                           **readings(mas.sys, events, states, group, kk, ok))
                if pkg == "port":
                    mas.shutdown()
                print(json.dumps(out), flush=True)
                del mas


if __name__ == "__main__":
    sys.exit(main())
