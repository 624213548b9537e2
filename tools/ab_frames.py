#!/usr/bin/env python3
"""Paired A/B of two sets of kernel sources in ONE process: every frame
or epoch runs with each set on the same state, so that the host's load,
which sets a launch-bound frame's time, and the work itself fall on both
alike.

    python3 tools/ab_frames.py PARENT_CSRC [--profile | --kernels |
                                            --solvers]
    (needs a CUDA device)

PARENT_CSRC is a ``csrc/`` directory of another version of the kernels
(for example ``git archive <commit> mam3slam_tpu_torch/csrc | tar -x -C
build/ab``).  Both sets are built into their own libraries, and the
launchers switch library between the runs.

Without ``--profile``, which set runs first alternates frame by frame:
  * phase 4 of chip_smoke.py: a seeded 32-keyframe map, two agents
    tracking 160 frames each (extract + ``track_frame_step``); the first
    run of a frame works on a copy of the map, the second carries on;
  * phase 5: one SlamSystem, two agents from no images over 200 frames
    each; the first run of a frame works on a deep copy of the system,
    the second carries on.  OK frames without a keyframe; and each mapping
    epoch alone: its program runs four more times on copies of the
    arguments the system gave it, parent / change / change / parent, with
    the host read of its packed result.
It prints, per series, the median and p90 ms of each set and the median
of the paired differences (change - parent).

With ``--profile``: phase 5's system with agent 0's arc alone, PROFILE_AT
frames tracked; then the next frame without a keyframe (``track`` on a
fresh deep copy of the system, extraction included) PROFILE_REPS times
and the next keyframe's ``mapping_epoch`` on its captured arguments
EPOCH_REPS times, parent / change / change / parent each.  Every run
goes twice: bare for the host wall (the profiler adds host time to every
launch), then in a torch.profiler window for the device's kernels.  It
prints, per part and set, the medians of host wall, device busy time,
kernel launches, busy share and the device time of the port's kernels.

With ``--kernels``: phase 3 of chip_smoke.py (every kernel against its
plain version at every caller's shape, with device, wrapper and plain
times and the bound) four times, parent / change / change / parent,
then per kernel and caller the device and wrapper times of each set
(mean of its two runs) and ptxas's report of each set's kernels.

With ``--solvers``: the other version's solver modules
(``solvers/ba_window.py`` and ``solvers/pgo.py`` of the package that
holds PARENT_CSRC, loaded beside this tree's) against this tree's, on
one state, parent / change / change / parent, EPOCH_REPS times: the
next keyframe's ``mapping_epoch`` after PROFILE_AT frames of phase 5's
first arc, ``global_ba`` at the arena caps on that map, and the 7DoF
and 4DoF essential-graph PGO over its essential graph with a loop
correction of its newest keyframe; every part as ``--profile`` reports
it.  The kernels are this tree's in both sets.

Every line carries the card's nvidia-smi name and power limit.
"""

import contextlib
import copy
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mam3slam_tpu_torch import _build  # noqa: E402

NAMES = ("parent", "change")
PROFILE_AT = 80
PROFILE_REPS = 10
EPOCH_REPS = 3
# the port's kernels by symbol, first match wins (the masked match was
# the best2_kernel<true> instance before it had a kernel of its own)
OWN = {"orb_desc_kernel": "orb_desc", "masked_match_kernel": "masked_match",
       "best2_kernel<true>": "masked_match", "best2_kernel": "min_hamming2",
       "best2_mma_kernel": "min_hamming2", "pose_kernel": "pose_opt",
       "segsum_kernel": "segsum"}


def build_library(csrc: str):
    """The kernels of ``csrc`` as a library of their own, and ptxas's
    report of them."""
    saved = (_build.CSRC_DIR, _build.BUILD_DIR, _build._lib,
             _build.build_log)
    _build.CSRC_DIR = csrc
    _build.BUILD_DIR = os.path.join(saved[1], "ab_" + str(abs(hash(csrc))))
    _build._lib = None
    _build.build_log = ""
    try:
        return _build.library(), _build.build_log
    finally:
        (_build.CSRC_DIR, _build.BUILD_DIR, _build._lib,
         _build.build_log) = saved


def kernel_runs(libs, smi, dev, scene, cam_r, orb_cfg, cfg, cam) -> None:
    """chip_smoke's phase 3 with each set, parent / change / change /
    parent; per kernel and caller the mean device and wrapper times of
    each set's two runs."""
    from mam3slam_tpu_torch.ops import cuda_orb_desc as CO

    rows = {n: [] for n in NAMES}
    for n in ("parent", "change", "change", "parent"):
        _build._lib = libs[n]
        rows[n].append(cs.check_kernels(dev, scene, cam_r, orb_cfg,
                                        cfg.max_mp))
    for k, row in enumerate(rows["change"][0]):
        mean = {n: {key: float(np.mean([r[k][key] for r in rows[n]]))
                    for key in ("device_ms", "wrapper_ms", "plain_ms")}
                for n in NAMES}
        cs.log("ab_kernel", kernel=row["kernel"], caller=repr(row["caller"]),
               parent_device_us=mean["parent"]["device_ms"] * 1e3,
               change_device_us=mean["change"]["device_ms"] * 1e3,
               parent_wrapper_us=mean["parent"]["wrapper_ms"] * 1e3,
               change_wrapper_us=mean["change"]["wrapper_ms"] * 1e3,
               plain_ms=(mean["parent"]["plain_ms"]
                         + mean["change"]["plain_ms"]) / 2,
               bound_us=row["bound_us"], bound_by=row["bound_by"],
               change_share=row["bound_us"] / 1e3
               / mean["change"]["device_ms"], card=repr(smi))
    # what the describe wrapper no longer does on every call
    cs.log("pattern_upload", card=repr(smi), us=1e3 * cs.median_ms(
        lambda: torch.tensor(CO.load_pattern(), device=dev)))


def summary(series: dict) -> dict:
    out = {k: dict(n=len(v), median_ms=float(np.median(v)),
                   p90_ms=float(np.percentile(v, 90)))
           for k, v in series.items()}
    diff = np.asarray(series["change"]) - np.asarray(series["parent"])
    out["paired_diff_median_ms"] = float(np.median(diff))
    out["change_slower_share"] = float(np.mean(diff > 0))
    return out


def timed(lib, fn):
    """(ms, result) of ``fn`` launching its kernels from ``lib``,
    synchronised."""
    _build._lib = lib
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def paired(libs: dict, first: str, run_first, run_second):
    """Run ``run_first`` with library ``first`` and ``run_second`` with
    the other; returns ({name: ms}, run_second's result)."""
    second = "change" if first == "parent" else "parent"
    ms = {}
    ms[first], _ = timed(libs[first], run_first)
    ms[second], out = timed(libs[second], run_second)
    return ms, out


def copied(args):
    """The mapping epoch's arguments with every tuple of tensors cloned."""
    return [type(a)(*(x.clone() for x in a)) if hasattr(a, "_fields") else a
            for a in args]


def ab_runs(libs, smi, dev, scene, cam_r, orb_cfg, cfg, cam) -> None:
    from mam3slam_tpu_torch.slam import system

    # phase 4: seeded map, two agents
    arcs = [render_arc(cs.N_ARC, 0, cs.N_ARC, b) for b in (0.05, -0.05)]
    ms = cs.seed_map(dev, scene, cam_r, cam, orb_cfg, cfg, arcs[0])
    n_kf = int(ms.kf_valid.sum())
    fns = system.programs(cfg, cam.kind)
    id_q = torch.tensor([1.0, 0, 0, 0], device=dev)
    z3 = torch.zeros(3, device=dev)
    chains = [(cs.quat_of(a[0][0]).to(dev), torch.tensor(a[0][1], device=dev),
               id_q, z3, False) for a in arcs]
    track = {n: [] for n in NAMES}
    for i in range(cs.N_ARC):
        for a, arc in enumerate(arcs):
            R, t, _ = arc[i]
            img = scene.render(R, t, cam_r)
            q_last, t_last, vq, vt, has_vel = chains[a]

            def step(state):
                frame = cs.frame_of(img, orb_cfg, cam)
                out = fns["track_frame_step"](
                    state, frame, min(i // cs.KF_EVERY, n_kf - 1), vq, vt,
                    has_vel, q_last, t_last, id_q, z3, False, cam.params)
                out[4].cpu()
                return out

            copy_ms = type(ms)(*(x.clone() for x in ms))
            times, out = paired(libs, NAMES[(i + a) % 2],
                                lambda: step(copy_ms), lambda: step(ms))
            ms, chains[a] = out[0], out[5]
            for n in NAMES:
                track[n].append(times[n])
    cs.log("ab_track", card=repr(smi), **summary(track))

    # phase 5: SlamSystem from no images
    arcs = [render_arc(cs.SLAM_FRAMES, a0, a1, b)
            for a0, a1, b in cs.SLAM_ARCS]
    sys_ = system.SlamSystem(cfg, cam, seed=0)
    aids = [sys_.add_agent() for _ in arcs]
    sys_.fns = dict(sys_.fns)
    epoch_fn = sys_.fns["mapping_epoch"]
    captured = []

    def capture(*args):
        captured.append(args)
        return epoch_fn(*args)

    sys_.fns["mapping_epoch"] = capture
    frames = {n: [] for n in NAMES}
    epochs = {n: [] for n in NAMES}
    for i in range(cs.SLAM_FRAMES):
        for aid, arc in zip(aids, arcs):
            R, t, _ = arc[i]
            img = scene.render(R, t, cam_r)
            before = sys_.agents[aid].state
            trial = copy.deepcopy(sys_)
            trial.fns = dict(trial.fns, mapping_epoch=epoch_fn)
            captured.clear()
            times, (state, _) = paired(
                libs, NAMES[(i + aid) % 2],
                lambda: trial.track(aid, cs.frame_of(img, orb_cfg, cam),
                                    i * cs.DT),
                lambda: sys_.track(aid, cs.frame_of(img, orb_cfg, cam),
                                   i * cs.DT))
            for args in captured:
                runs = {n: [] for n in NAMES}
                for n in ("parent", "change", "change", "parent"):
                    c = copied(args)
                    runs[n].append(timed(
                        libs[n], lambda: epoch_fn(*c)[1].cpu())[0])
                for n in NAMES:
                    epochs[n].append(float(np.mean(runs[n])))
            if not captured and before == system.OK and state == system.OK:
                for n in NAMES:
                    frames[n].append(times[n])
    cs.log("ab_slam_frame", card=repr(smi), **summary(frames))
    cs.log("ab_epoch", card=repr(smi), **summary(epochs))


class _Captured(Exception):
    pass


def profiled(make_fn):
    """Host ms of a bare run of ``make_fn()``'s function (synchronised),
    and the device kernels of a profiled run of another: (ms, count, busy
    us, {own kernel: (count, us)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms, _ = timed(_build._lib, make_fn())
    fn = make_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, us, own = 0, 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Memset"):
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
        n += e.count
        us += t
        for sym, name in OWN.items():
            if sym in e.key:
                c, u = own.get(name, (0, 0.0))
                own[name] = (c + e.count, u + t)
                break
    return ms, n, us, own


def report(part: str, runs, smi: str) -> None:
    med = [statistics.median(r[k] for r in runs) for k in range(3)]
    own = {}
    for name in sorted({k for r in runs for k in r[3]}):
        c = statistics.median(r[3].get(name, (0, 0.0))[0] for r in runs)
        u = statistics.median(r[3].get(name, (0, 0.0))[1] for r in runs)
        own[name] = f"{c:g}x/{u:.1f}us"
    cs.log("profile", part=part, reps=len(runs), host_ms_median=med[0],
           device_busy_ms=med[2] / 1e3, kernel_launches=med[1],
           busy_share=med[2] / 1e3 / med[0], own_kernels=own, card=repr(smi))


def profile_runs(libs, smi, dev, scene, cam_r, orb_cfg, cfg, cam) -> None:
    from mam3slam_tpu_torch.slam import system

    arc = render_arc(cs.SLAM_FRAMES, *cs.SLAM_ARCS[0])
    sys_ = system.SlamSystem(cfg, cam, seed=0)
    aid = sys_.add_agent()
    for i in range(PROFILE_AT):
        R, t, _ = arc[i]
        sys_.track(aid, cs.frame_of(scene.render(R, t, cam_r), orb_cfg, cam),
                   i * cs.DT)
    cs.log("state", frames=PROFILE_AT, keyframes=int(sys_.ms.kf_valid.sum()),
           map_points=int(sys_.ms.mp_valid.sum()))

    # the next frames until one inserts no keyframe and one does
    i = PROFILE_AT
    tracked = epoch_args = None
    while tracked is None or epoch_args is None:
        R, t, _ = arc[i]
        img = scene.render(R, t, cam_r)
        trial = copy.deepcopy(sys_)
        captured = {}

        def capture(*args):
            captured["args"] = args
            raise _Captured

        trial.fns = dict(trial.fns, mapping_epoch=capture)
        try:
            trial.track(aid, cs.frame_of(img, orb_cfg, cam), i * cs.DT)
        except _Captured:
            epoch_args = epoch_args or captured["args"]
        else:
            tracked = tracked or (i, img)
        i += 1
    i, img = tracked

    def tracked_frame():
        trial = copy.deepcopy(sys_)
        return lambda: trial.track(aid, cs.frame_of(img, orb_cfg, cam),
                                   i * cs.DT)

    def mapping_epoch():
        args = copied(epoch_args)
        return lambda: sys_.fns["mapping_epoch"](*args)[1].cpu()

    for part, make_fn, reps in (
            ("tracked frame", tracked_frame, PROFILE_REPS),
            ("mapping epoch", mapping_epoch, EPOCH_REPS)):
        runs = {n: [] for n in NAMES}
        for _ in range(reps):
            for n in ("parent", "change", "change", "parent"):
                _build._lib = libs[n]
                runs[n].append(profiled(make_fn))
        for n in NAMES:
            report(f"{part} ({n})", runs[n], smi)


def parent_solvers(pkg_dir: str) -> dict:
    """The other version's ``solvers/ba_window.py`` and
    ``solvers/pgo.py``, loaded as modules of their own (they import this
    tree's geometry, ops and ``solvers.ba`` helpers)."""
    mods = {}
    for name in ("ba_window", "pgo"):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", os.path.join(pkg_dir, "solvers", f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods


def solver_runs(parent_pkg, smi, dev, scene, cam_r, orb_cfg, cfg,
                cam) -> None:
    from mam3slam_tpu_torch.geometry import lie
    from mam3slam_tpu_torch.mapstate import state as S
    from mam3slam_tpu_torch.slam import system
    from mam3slam_tpu_torch.slam.server import LoopServer, ServerConfig
    from mam3slam_tpu_torch.solvers import ba_window, pgo

    mods = {"parent": parent_solvers(parent_pkg),
            "change": {"ba_window": ba_window, "pgo": pgo}}
    arc = render_arc(cs.SLAM_FRAMES, *cs.SLAM_ARCS[0])
    sys_ = system.SlamSystem(cfg, cam, seed=0)
    aid = sys_.add_agent()
    for i in range(PROFILE_AT):
        R, t, _ = arc[i]
        sys_.track(aid, cs.frame_of(scene.render(R, t, cam_r), orb_cfg, cam),
                   i * cs.DT)
    captured = {}

    def capture(*args):
        captured["args"] = args
        raise _Captured

    i = PROFILE_AT
    while "args" not in captured:
        R, t, _ = arc[i]
        trial = copy.deepcopy(sys_)
        trial.fns = dict(trial.fns, mapping_epoch=capture)
        try:
            trial.track(aid, cs.frame_of(scene.render(R, t, cam_r), orb_cfg,
                                         cam), i * cs.DT)
        except _Captured:
            pass
        i += 1
    ms, map_id = sys_.ms, sys_.agents[aid].map_id
    in_map = ms.kf_valid & (ms.kf_map == map_id)
    newest = int(torch.argmax(torch.where(in_map, ms.kf_seq, -1)))
    oldest = int(torch.argmin(torch.where(in_map, ms.kf_seq, S.BIG_SEQ)))
    srv = LoopServer(sys_, ServerConfig())
    S_corr = lie.sim3_compose(lie.sim3_exp(torch.tensor(
        cs.REPRO_LOOP_XI, device=dev)), srv._pose_sim3(newest))
    edges = srv._essential_edges(ms, newest, oldest, S_corr,
                                 in_map.cpu().numpy())
    fixed = ~in_map
    fixed[oldest] = True
    ones = torch.ones(in_map.shape[0], device=dev)
    cs.log("state", frames=i, keyframes=int(in_map.sum()),
           map_points=int(ms.mp_valid.sum()), pgo_edges=len(edges.i),
           arena=(cfg.max_kf, cfg.max_mp))
    state = {}

    @contextlib.contextmanager
    def using(name):
        saved = system.bw
        system.bw = mods[name]["ba_window"]
        state["pgo"] = mods[name]["pgo"]
        try:
            yield
        finally:
            system.bw = saved

    def epoch():
        args = copied(captured["args"])
        return lambda: sys_.fns["mapping_epoch"](*args)[1].cpu()

    parts = (
        ("mapping epoch", epoch),
        ("global_ba at the arena caps",
         lambda: lambda: sys_.fns["global_ba"](ms, map_id).kf_t.cpu()),
        ("PGO 7DoF", lambda: lambda: state["pgo"].optimize_essential_graph(
            ms.kf_q, ms.kf_t, ones, fixed, edges, iters=12)[1].cpu()),
        ("PGO 4DoF", lambda: lambda: state["pgo"]
         .optimize_essential_graph_4dof(ms.kf_q, ms.kf_t, fixed, edges,
                                        iters=12)[1].cpu()))
    for part, make_fn in parts:
        runs = {n: [] for n in NAMES}
        for _ in range(EPOCH_REPS):
            for n in ("parent", "change", "change", "parent"):
                with using(n):
                    runs[n].append(profiled(make_fn))
        for n in NAMES:
            report(f"{part} ({n})", runs[n], smi)


def render_arc(n: int, a0: float, a1: float, bob: float):
    from mam3slam_tpu_torch.io import render
    return render.orbit_trajectory(n, a0, a1, radius=2.5, bob=bob)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_frames: no CUDA device", file=sys.stderr)
        return 1
    from mam3slam_tpu_torch.geometry import cameras
    from mam3slam_tpu_torch.io import render
    from mam3slam_tpu_torch.ops import orb as O
    from mam3slam_tpu_torch.slam import system

    dev = torch.device("cuda", 0)
    parent_csrc = os.path.abspath(sys.argv[1])
    if "--solvers" in sys.argv[2:]:
        parent, parent_log = _build.library(), "(this tree's kernels)"
    else:
        parent, parent_log = build_library(parent_csrc)
    libs = {"parent": parent, "change": _build.library()}
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    for name, log in (("parent", parent_log), ("change", _build.build_log)):
        for line in log.splitlines():
            if "ptxas info" in line or "bytes stack frame" in line:
                cs.log("ptxas", set=name, line=repr(line.strip()))
    cam_r = render.RenderCam(cs.W, cs.H, cs.FX, cs.FY, cs.CX, cs.CY)
    scene = render.RoomScene(seed=5, device=dev)
    orb_cfg = O.OrbConfig(height=cs.H, width=cs.W, n_features=cs.N_FEATURES)
    cfg = system.SlamConfig(width=cs.W, height=cs.H, n_feat=orb_cfg.capacity)
    cam = cameras.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY, device=dev)
    if "--solvers" in sys.argv[2:]:
        solver_runs(os.path.dirname(parent_csrc), smi, dev, scene, cam_r,
                    orb_cfg, cfg, cam)
        return 0
    run = (profile_runs if "--profile" in sys.argv[2:] else
           kernel_runs if "--kernels" in sys.argv[2:] else ab_runs)
    run(libs, smi, dev, scene, cam_r, orb_cfg, cfg, cam)
    return 0


if __name__ == "__main__":
    sys.exit(main())
