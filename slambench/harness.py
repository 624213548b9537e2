"""One run of one cell: set-up, the measured window, the check, the
metrics.

``run_cell`` does everything on the device it is given; ``run.py`` looks
for the card first and prints the result.  Everything that belongs to
one deployment, mix or metric is in a file found by its name:
``configs/<config>.json`` (through ``BENCHMARK.json``),
``traffic/<traffic>.json``, ``end_to_end/<metric>.py`` and
``layers/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from slambench import check as check_mod
from slambench import trace as trace_mod
from slambench import traffic as traffic_mod
from slambench.ref import orb as ref_orb

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mam3slam_tpu")


class SetupError(RuntimeError):
    pass


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files and the metrics
    it reports."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "slambench", "traffic",
                                     f"{w['traffic']}.json"))

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def metric_module(kind: str, name: str):
    """``end_to_end/<name>.py`` or ``layers/<name>.py``."""
    return importlib.import_module(f"slambench.{kind}.{name}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the reference
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def settings_yaml(settings: dict) -> str:
    """An OpenCV-FileStorage settings file of the deployment's values."""
    lines = ["%YAML:1.0", 'File.version: "1.0"']
    for k, v in settings.items():
        lines.append(f'{k}: "{v}"' if isinstance(v, str) else f"{k}: {v}")
    return "\n".join(lines) + "\n"


def orb_config(settings: dict) -> ref_orb.OrbConfig:
    return ref_orb.OrbConfig(
        height=int(settings["Camera.height"]),
        width=int(settings["Camera.width"]),
        n_features=int(settings["ORBextractor.nFeatures"]),
        n_levels=int(settings["ORBextractor.nLevels"]),
        scale_factor=float(settings["ORBextractor.scaleFactor"]),
        ini_th=float(settings["ORBextractor.iniThFAST"]),
        min_th=float(settings["ORBextractor.minThFAST"]))


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux), else None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - start / os.sysconf("SC_CLK_TCK")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_system(config: dict, yaml_path: str, n_agents: int, device):
    from mam3slam_tpu_torch import api
    from mam3slam_tpu_torch.slam.server import ServerConfig

    f = config["facade"]
    mas = api.MultiAgentSystem(
        active_loop_closing=f["active_loop_closing"],
        server_config=ServerConfig(**config["server"]),
        slam_overrides=dict(config["slam"]),
        async_mapping=f["async_mapping"], pipeline=f["pipeline"],
        device=device)
    for _ in range(n_agents):
        mas.add_agent(yaml_path)
    return mas


def warm_libraries(device) -> None:
    """Create the solver libraries' handles (cuBLAS, cuSOLVER) that the
    program's loop and merge corrections use, in both float types."""
    for dt in (torch.float32, torch.float64):
        a = torch.eye(6, dtype=dt, device=device) * 2 + 0.1
        torch.linalg.eigh(a)
        c = torch.linalg.cholesky(a)
        torch.cholesky_solve(a, c)
        torch.linalg.solve(a, a)
        torch.linalg.svd(a)
        torch.linalg.inv(a)
    sync(device)


def server_events(mas) -> List[str]:
    return list(mas.server.events) if mas.server is not None else []


def warm_up(cell: Cell, yaml_path: str, agents, device) -> int:
    """The first ``warmup_frames`` of each agent's frames on a throwaway
    system, stopping once a server event starting ``warmup_until`` has
    come: so every path the window's missions take (init, mapping
    epochs, the server's place recognition and, where the mix closes a
    loop, its correction and global BA; the allocator's blocks) has run
    once.  Returns the frames fed."""
    until = cell.traffic.get("warmup_until")
    mas = build_system(cell.config, yaml_path, len(agents), device)
    fed = 0
    for k, i in traffic_mod.schedule(agents,
                                     cell.traffic["warmup_frames"]):
        mas.track_monocular(k, agents[k].frames[i], i / agents[k].fps)
        fed += 1
        if until and any(e.startswith(until) for e in server_events(mas)):
            break
    mas.shutdown()
    sync(device)
    del mas
    gc.collect()
    return fed


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    frames: int = 0
    window_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = field(default_factory=dict)
    missions: int = 0
    missions_complete: int = 0
    mission_walls: List[tuple] = field(default_factory=list)  # (s, calls)


def fly(cell: Cell, agents, yaml_path: str, device, deadline: float,
        rec: Optional[trace_mod.Recorder], latencies: List[float],
        frame0: int):
    """One mission on a fresh system, one call at a time until its frames
    or the time run out.  Returns (system, states per agent, complete)."""
    mas = build_system(cell.config, yaml_path, len(agents), device)
    states = [[] for _ in agents]
    for k, i in traffic_mod.schedule(agents):
        if time.perf_counter() >= deadline:
            return mas, states, False
        ag = agents[k]
        if rec is not None:
            rec.frame = frame0 + len(latencies)
        f0 = time.perf_counter()
        st, _ = mas.track_monocular(k, ag.frames[i], i / ag.fps)
        latencies.append(time.perf_counter() - f0)
        states[k].append(int(st))
    mas.sys.flush()
    return mas, states, True


def close(mas, states, complete: bool) -> check_mod.MissionRecord:
    """Copy what the check reads of a mission to the host and free its
    system, so that one system holds the card at a time."""
    rec = check_mod.record_mission(mas, states, complete)
    mas.shutdown()
    return rec


def run_window(cell: Cell, agents, yaml_path: str, seconds: float, device,
               rec: Optional[trace_mod.Recorder], run: Run):
    """Back-to-back missions on fresh systems until ``seconds`` of their
    calls have run.  Copying a finished mission's record to the host and
    freeing its system are not the program's work: the window's clock
    stops for them.  Returns the missions' records."""
    records = []
    sync(device)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    paused = 0.0
    while time.perf_counter() < deadline:
        m0, c0 = time.perf_counter(), len(run.latencies_s)
        mas, states, complete = fly(cell, agents, yaml_path, device,
                                    deadline, rec, run.latencies_s, 0)
        sync(device)
        p0 = time.perf_counter()
        run.mission_walls.append((p0 - m0, len(run.latencies_s) - c0))
        records.append(close(mas, states, complete))
        del mas
        gc.collect()
        sync(device)
        pause = time.perf_counter() - p0
        paused += pause
        deadline += pause
    run.window_s = time.perf_counter() - t_start - paused
    run.frames = len(run.latencies_s)
    run.missions = len(records)
    run.missions_complete = sum(r.complete for r in records)
    return records


def profiled_mission(cell: Cell, agents, yaml_path: str, device,
                     rec: trace_mod.Recorder):
    """In a traced run, after the window: one whole mission under
    ``torch.profiler``, whose kernels, copies and memsets give the
    device metrics over the mix's every phase (init, epochs, the
    server's corrections).  The profiler slows every launch, so the span
    metrics leave its spans out.  Returns (record, profiler, (wall start
    ns, wall end ns, calls, wall minus perf ns))."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA
                               if device.type == "cuda"
                               else ProfilerActivity.CPU])
    latencies: List[float] = []
    prof.start()
    sync(device)
    rec.profiling = True
    w0 = time.time_ns()
    offset = time.time_ns() - time.perf_counter_ns()
    mas, states, complete = fly(cell, agents, yaml_path, device,
                                float("inf"), rec, latencies, 10**9)
    sync(device)
    w1 = time.time_ns()
    rec.profiling = False
    prof.stop()
    return close(mas, states, complete), prof, (w0, w1, len(latencies),
                                                offset)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """One run on ``device``: set-up, window, check and metrics.  Returns
    the record from which ``run.py`` prints the result."""
    device = torch.device(device)
    run = Run()
    parts = run.setup_parts
    t = time.perf_counter()
    from mam3slam_tpu_torch import _build
    from mam3slam_tpu_torch import api  # noqa: F401  (the entry's imports)

    parts["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        _build.library()
        warm_libraries(device)
    parts["library_s"] = time.perf_counter() - t
    t = time.perf_counter()
    agents = traffic_mod.make_agents(cell.traffic, cell.config, seed, device)
    sync(device)
    parts["render_s"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="slambench_")
    yaml_path = os.path.join(tmp, "settings.yaml")
    prof = None
    try:
        with open(yaml_path, "w") as f:
            f.write(settings_yaml(cell.config["settings"]))
        t = time.perf_counter()
        parts["warmup_frames"] = warm_up(cell, yaml_path, agents, device)
        parts["warmup_s"] = time.perf_counter() - t
        rec = None
        if trace:
            rec = trace_mod.Recorder(device)
            for m in cell.per_layer:
                mod = metric_module("layers", m["name"])
                for name, target in getattr(mod, "SPANS", {}).items():
                    rec.span(name, target)
                for name, (target, keep) in getattr(mod, "CALLS", {}).items():
                    rec.call(name, target, keep)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        age = process_age_s()
        run.setup_s = age if age is not None else time.perf_counter() - t_process
        records = run_window(cell, agents, yaml_path, seconds, device, rec,
                             run)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        if rec is not None:
            r, prof, sliced = profiled_mission(cell, agents, yaml_path,
                                               device, rec)
            records.append(r)
            rec.remove()
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    forbidden = forbidden_modules()
    trace_obj = None
    if prof is not None:
        w0, w1, n_calls, offset = sliced
        trace_obj = trace_mod.Trace(
            spans=rec.spans, calls=rec.calls,
            intervals=(trace_mod.device_intervals(prof)
                       if device.type == "cuda" else []),
            window_ns=(w0, w1), frames_profiled=n_calls,
            wall_minus_perf_ns=offset)
        del prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    scales = ref_orb.OrbConfig(8, 8, n_levels=int(
        cell.config["settings"]["ORBextractor.nLevels"]),
        scale_factor=float(cell.config["settings"][
            "ORBextractor.scaleFactor"])).scales
    verdict = check_mod.run_check(records, agents, cell.config,
                                  cell.traffic, seed,
                                  orb_config(cell.config["settings"]), scales)
    check_s = time.perf_counter() - t
    return dict(run=run, verdict=verdict, memory_peak=memory_peak,
                forbidden=forbidden, trace=trace_obj, records=records,
                check_s=check_s)


def metrics_of(cell: Cell, out: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (on), each read by its own file; a reader that finds nothing returns
    None and the metric is left out."""
    res = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = metric_module("layers" if trace else "end_to_end", m["name"])
        v = (mod.read(out["trace"], out["run"]) if trace
             else mod.read(out["run"]))
        if v is not None:
            res[m["name"]] = dict(value=float(v), unit=m["unit"])
    return res
