#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py phases 6-10 against the reference.

    python3 tools/chip_rehearsal.py [--loop | --four | --facade
                                     [--pipeline D | --async] | --daemon |
                                     --inertial | --resize] [--threads N]

Phase 6 (default 6a, the two-agent merge arcs; ``--loop``: 6b, the
one-agent loop arc): renders the phase's frames at half size (376x240,
half the EuRoC cam0 intrinsics, 500 features; arena caps 128 KF / 12288
MP, the other ``SlamConfig`` and ``ServerConfig`` fields at their
defaults) and feeds each frame to two systems in lockstep: the JAX
package's ``SlamSystem`` + ``LoopServer`` (JAX ``extract_orb`` +
``with_undistorted``) and the port's (``chip_smoke.frame_of``).

Phase 11a (``--four``): phase 6's half-size setup with four agents on
``chip_smoke.PHASE11_ARCS`` (``PHASE11_FRAMES`` frames each, room seed
3, interleaved), each package's server running its global BA on a mesh
of one (``gba_mesh``: the reference's one-device ``jax.sharding.Mesh``,
the port's one-rank gloo mesh on the CPU): the figures phase 11a's ATE
bounds come from (its output: ``tools/chip_rehearsal_11a.log``).

Phase 7 (``--facade``): renders phase 7's 240 frames at 1/3 of the
fixture camera (320x320 KB8; 8 levels, 700 features, bench.py's
``SlamConfig``) and feeds each to both packages' ``MultiAgentSystem``,
built from one settings file (``chip_smoke.facade_yaml``).  Phase 8a
(``--facade --pipeline 4``): the same, both facades pipelined to depth D
with synchronous mapping (bench.py's configuration).  Phase 8b
(``--facade --async``): both facades with the mapping worker, depth-4
pipelining and ``ServerConfig(async_gba=True)``, fed as fast as they
take the frames and never drained (as chip_smoke.py's 8b-bare; its 8b
drains every 5 frames); the worker's timing makes the run differ
between repeats.  Both phase-8 modes flush and shut the
facades down before the summary and also print the refused keyframe
insertions and the background GBAs.

Phase 9b (``--daemon``): the daemon's system at 1/3 of the fixture
camera, both packages' ``MultiAgentSystem`` with two agents (each from
its own settings file) fed phase 9b's arcs (``chip_smoke.DAEMON_ARCS``
in ``DAEMON_FRAMES`` frames, room seed 3) as u8 frames, interleaved and
none dropped: whether and where the reference merges on these arcs (its
output: ``tools/chip_rehearsal_9b.log``).

Phase 10 (``--inertial``): phase 10's own frames and IMU
(``chip_smoke.OrbitMotion``) at the EuRoC camera (752x480, 1000
features, 8 levels) with the arena cut to 128 KF / 12288 MP, fed in
lockstep to both packages' ``SlamSystem.track(..., imu=)``: 10a phase
6b's loop arc with a ``LoopServer`` each, 10b the yaw-burst frames (with
the vertical shake) with IMU and without (no server).  Prints per
package the events, the OK share and ATE / span, the IMU_INIT frame, the
scale error against the Umeyama scale, the gravity error in the map
frame and ``n_fallback``: the figures phase 10's bounds come from (its
output: ``tools/chip_rehearsal_10.log``, 20 min here).

Phase 12b (``--resize``): phase 12b at half size, both packages'
``MultiAgentSystem`` built from one settings file
(``chip_smoke.resize_yaml``) whose Camera.newWidth / newHeight resize
the frames to 360x360 (the fixture camera at 0.375x, bench.py's
``SlamConfig``): the first ``chip_smoke.RESIZE_FRAMES`` frames of phase
7's orbit rendered at 300x300 (upscaled) and at 480x480 (downscaled),
fed to both as u8 host frames (``chip_smoke.u8_frame``); the reference
resizes them with cv2 on the host, the port with ``area_resize``: the
figures phase 12b's ATE bounds come from (its output:
``tools/chip_rehearsal_12b.log``).

Prints, per package, the server and system events, the keyframe and map
point counts and per agent the share of frames OK after init and the ATE
after Sim3 alignment as a fraction of the arc's span: the figures from
which chip_smoke.py's ATE bounds are derived.  Imports JAX, so it is not
part of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mam3slam_tpu import api as japi  # noqa: E402
from mam3slam_tpu.geometry import cameras as jcam  # noqa: E402
from mam3slam_tpu.ops import orb as jorb  # noqa: E402
from mam3slam_tpu.slam import server as jserver  # noqa: E402
from mam3slam_tpu.slam import steps as jsteps  # noqa: E402
from mam3slam_tpu.slam import system as jsystem  # noqa: E402
from mam3slam_tpu_torch import api as tapi  # noqa: E402
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
    print(f"[{name}] keyframes={int(np.asarray(sys_.ms.kf_valid).sum())} "
          f"map_points={int(np.asarray(sys_.ms.mp_valid).sum())}", flush=True)
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


def facade(pipeline: int = 0, async_: bool = False) -> None:
    """Phase 7 (or 8a with ``pipeline``, 8b with ``async_``) at 1/3 of
    the fixture camera, both facades on one settings file and the same
    frames."""
    cam = render.reference_kb8_cam(1 / 3)
    traj = render.orbit_trajectory(cs.FACADE_FRAMES, *cs.FACADE_ARC[:2],
                                   radius=2.5, bob=cs.FACADE_ARC[2])
    scene = render.RoomScene(seed=5, device="cpu")
    tcfg = cs.facade_config(cam)
    jcfg = jsystem.SlamConfig(**{f.name: getattr(tcfg, f.name)
                                 for f in dataclasses.fields(tcfg)})
    if async_:
        pipeline = cs.PIPELINE_DEPTH
    opts = dict(async_mapping=async_, pipeline=pipeline > 0)
    tmas = tapi.MultiAgentSystem(
        slam_config=tcfg, device="cpu", **opts,
        server_config=tserver.ServerConfig(async_gba=async_))
    jmas = japi.MultiAgentSystem(
        slam_config=jcfg, **opts,
        server_config=jserver.ServerConfig(async_gba=async_))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kb8_fixture.yaml")
        with open(path, "w") as f:
            f.write(cs.facade_yaml(cam))
        tmas.add_agent(path)
        jmas.add_agent(path)
    for mas in (tmas, jmas):
        mas.sys.pipeline_depth = max(pipeline, 1)
    tstates, jstates = [], []
    t0 = time.perf_counter()
    for i, (R, t, _) in enumerate(traj):
        img = scene.render(R, t, cam)
        tstates.append(tmas.track_monocular(0, img, i * cs.DT)[0])
        jstates.append(jmas.track_monocular(0, img.numpy(), i * cs.DT)[0])
        if i % 50 == 0:
            print(f"[progress] frame={i} s={time.perf_counter() - t0:.1f}",
                  flush=True)
    phase = "8b" if async_ else "8a" if pipeline else "7"
    for mas in (tmas, jmas):
        mas.shutdown()
    print(f"[setup] phase={phase} size={cam.width}x{cam.height} "
          f"features={cs.FIXTURE_FEATURES} frames={len(traj)} "
          f"depth={max(pipeline, 1) if pipeline else 0} async={async_} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    for name, mas, states, ok in (("reference", jmas, jstates, jsystem.OK),
                                  ("port", tmas, tstates, tsystem.OK)):
        summary(name, mas.sys, [0], [traj], [states], ok)
        if pipeline:
            print(f"[{name}] refused="
                  f"{mas.sys.agents[0].kf_insertions_refused} "
                  f"gba_runs={mas.server.gba_runs}", flush=True)


def resize() -> None:
    """Phase 12b at half size: for each direction, both facades from one
    resizing settings file on the same u8 frames."""
    work = render.reference_kb8_cam(cs.FIXTURE_SCALE / 2)
    traj = render.orbit_trajectory(cs.FACADE_FRAMES, *cs.FACADE_ARC[:2],
                                   radius=2.5,
                                   bob=cs.FACADE_ARC[2])[:cs.RESIZE_FRAMES]
    scene = render.RoomScene(seed=5, device="cpu")
    tcfg = cs.facade_config(work)
    jcfg = jsystem.SlamConfig(**{f.name: getattr(tcfg, f.name)
                                 for f in dataclasses.fields(tcfg)})
    for name, scale in cs.RESIZE_RUNS:
        src = render.reference_kb8_cam(scale / 2)
        frames = [cs.u8_frame(scene.render(R, t, src)) for R, t, _ in traj]
        tmas = tapi.MultiAgentSystem(slam_config=tcfg, device="cpu",
                                     server_config=tserver.ServerConfig())
        jmas = japi.MultiAgentSystem(slam_config=jcfg,
                                     server_config=jserver.ServerConfig())
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"kb8_{name}.yaml")
            with open(path, "w") as f:
                f.write(cs.resize_yaml(src, work))
            tmas.add_agent(path)
            jmas.add_agent(path)
        tstates, jstates = [], []
        t0 = time.perf_counter()
        for i, img in enumerate(frames):
            tstates.append(tmas.track_monocular(0, img, i * cs.DT)[0])
            jstates.append(jmas.track_monocular(0, img, i * cs.DT)[0])
            if i % 50 == 0:
                print(f"[progress] {name} frame={i} "
                      f"s={time.perf_counter() - t0:.1f}", flush=True)
        for mas in (tmas, jmas):
            mas.shutdown()
        print(f"[setup] phase=12b direction={name} "
              f"frames={src.width}x{src.height} "
              f"working={tmas.sys.cfg.width}x{tmas.sys.cfg.height} "
              f"features={cs.FIXTURE_FEATURES} n={len(frames)} "
              f"seconds={time.perf_counter() - t0:.1f}", flush=True)
        for pkg, mas, states, ok in (
                ("reference", jmas, jstates, jsystem.OK),
                ("port", tmas, tstates, tsystem.OK)):
            summary(f"{pkg} {name}", mas.sys, [0], [traj], [states], ok)


def daemon() -> None:
    """Phase 9b's system and frames at 1/3 of the fixture camera: both
    packages' facades with two agents, each added from its own settings
    file, fed phase 9b's arcs (``chip_smoke.DAEMON_ARCS``, room seed 3)
    interleaved, one frame of each agent per round and none dropped."""
    cam = render.reference_kb8_cam(1 / 3)
    arcs = [render.orbit_trajectory(cs.DAEMON_FRAMES, a0, a1, radius=2.5,
                                    bob=b) for a0, a1, b in cs.DAEMON_ARCS]
    scene = render.RoomScene(seed=cs.DAEMON_SCENE_SEED, device="cpu")
    tcfg = cs.facade_config(cam)
    jcfg = jsystem.SlamConfig(**{f.name: getattr(tcfg, f.name)
                                 for f in dataclasses.fields(tcfg)})
    tmas = tapi.MultiAgentSystem(slam_config=tcfg, device="cpu",
                                 server_config=tserver.ServerConfig())
    jmas = japi.MultiAgentSystem(slam_config=jcfg,
                                 server_config=jserver.ServerConfig())
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(len(arcs)):
            path = os.path.join(tmp, f"agent{k}.yaml")
            with open(path, "w") as f:
                f.write(cs.facade_yaml(cam))
            tmas.add_agent(path)
            jmas.add_agent(path)
    tstates, jstates = [[] for _ in arcs], [[] for _ in arcs]
    t0 = time.perf_counter()
    for i in range(cs.DAEMON_FRAMES):
        for k, arc in enumerate(arcs):
            R, t, _ = arc[i]
            # the daemon's clients send u8 frames
            img = scene.render(R, t, cam).to(torch.uint8)
            tstates[k].append(tmas.track_monocular(k, img, i * cs.DT)[0])
            jstates[k].append(jmas.track_monocular(k, img.numpy(),
                                                   i * cs.DT)[0])
        if i % 25 == 0:
            print(f"[progress] frame={i} s={time.perf_counter() - t0:.1f}",
                  flush=True)
    for mas in (tmas, jmas):
        mas.shutdown()
    print(f"[setup] phase=9b size={cam.width}x{cam.height} "
          f"features={cs.FIXTURE_FEATURES} frames={cs.DAEMON_FRAMES}x2 "
          f"arcs={cs.DAEMON_ARCS} seconds={time.perf_counter() - t0:.1f}",
          flush=True)
    for name, mas, states, ok in (("reference", jmas, jstates, jsystem.OK),
                                  ("port", tmas, tstates, tsystem.OK)):
        summary(name, mas.sys, [0, 1], arcs, states, ok)


def inertial() -> None:
    """Phase 10 at the EuRoC camera, arena 128 KF / 12288 MP, both
    packages on the same frames and IMU windows."""
    cam_r = render.RenderCam(cs.W, cs.H, cs.FX, cs.FY, cs.CX, cs.CY)
    scene = render.RoomScene(seed=cs.SERVER_SCENE_SEED, device="cpu")
    orb_cfg = O.OrbConfig(height=cs.H, width=cs.W, n_features=cs.N_FEATURES)
    jorb_cfg = jorb.OrbConfig(height=cs.H, width=cs.W,
                              n_features=cs.N_FEATURES)
    tcam = cameras.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY, device="cpu")
    jcam_ = jcam.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY)
    caps = dict(width=cs.W, height=cs.H, n_feat=orb_cfg.capacity,
                max_kf=MAX_KF, max_mp=MAX_MP)

    @jax.jit
    def jextract(img):
        return jorb.with_undistorted(jorb.extract_orb(img, jorb_cfg), jcam_)

    def systems(server: bool):
        tsys_ = tsystem.SlamSystem(tsystem.SlamConfig(**caps), tcam, seed=0)
        jsys_ = jsystem.SlamSystem(jsystem.SlamConfig(**caps), jcam_, seed=0)
        if server:
            tsys_.server = tserver.LoopServer(tsys_, tserver.ServerConfig())
            jsys_.server = jserver.LoopServer(jsys_, jserver.ServerConfig())
        return tsys_, jsys_

    def lockstep(name, traj, imus, server):
        pair = systems(server)
        rs = [dict(sys=s_, aid=s_.add_agent(), states=[], init_frame=None,
                   server_frames=[]) for s_ in pair]
        t0 = time.perf_counter()
        for i, (R, t, _) in enumerate(traj):
            img = scene.render(R, t, cam_r)
            f = jextract(jnp.asarray(img.numpy()))
            frames = (cs.frame_of(img, orb_cfg, tcam),
                      jsteps.FrameObs(f.uv, f.level, f.angle, f.desc,
                                      f.valid))
            for r, frame in zip(rs, frames):
                s_, a = r["sys"], r["sys"].agents[r["aid"]]
                n_srv = len(s_.server.events) if server else 0
                r["states"].append(int(s_.track(r["aid"], frame, i * cs.DT,
                                                imu=imus[i])[0]))
                if r["init_frame"] is None and a.imu_initialized:
                    r["init_frame"] = i
                if server and len(s_.server.events) > n_srv:
                    r["server_frames"].append((i, s_.server.events[n_srv:]))
            if i % 50 == 0:
                print(f"[progress] {name} frame={i} "
                      f"s={time.perf_counter() - t0:.1f}", flush=True)
        print(f"[setup] phase={name} size={cs.W}x{cs.H} "
              f"features={cs.N_FEATURES} caps={MAX_KF}/{MAX_MP} "
              f"frames={len(traj)} imu={imus[1] is not None} "
              f"seconds={time.perf_counter() - t0:.1f}", flush=True)
        for pkg, r in zip(("port", "reference"), rs):
            res = cs.inertial_results(r, traj)
            print(f"[{pkg}] {name} " + " ".join(
                f"{k}={v}" for k, v in res.items()), flush=True)

    loop = render.orbit_trajectory(cs.LOOP_FRAMES, *cs.LOOP_ARC[:2],
                                   radius=2.5, bob=cs.LOOP_ARC[2])
    lockstep("10a", loop, cs.OrbitMotion(cs.LOOP_FRAMES, *cs.LOOP_ARC[:2],
                                         bob=cs.LOOP_ARC[2]).imu(10), True)
    motion = cs.OrbitMotion(cs.BURST_FRAMES, 0.0, 0.8 * (cs.BURST_FRAMES - 1),
                            bob=cs.LOOP_ARC[2], burst=(
                                cs.BURST_AT, cs.BURST_LEN, cs.BURST_DEG),
                            shake=cs.BURST_SHAKE)
    btraj, bimus = motion.frames(), motion.imu(11)
    lockstep("10b-imu", btraj, bimus, False)
    lockstep("10b-cv", btraj, [None] * len(btraj), False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--loop", action="store_true",
                      help="phase 6b (the loop arc) instead of 6a")
    mode.add_argument("--four", action="store_true",
                      help="phase 11a (four agents, global BA on a mesh)")
    mode.add_argument("--facade", action="store_true",
                      help="phase 7 (the facade at 1/3 of the fixture)")
    mode.add_argument("--daemon", action="store_true",
                      help="phase 9b (two agents on the merge arcs at 1/3 "
                      "of the fixture)")
    mode.add_argument("--resize", action="store_true",
                      help="phase 12b (the facade through settings that "
                      "resize its frames, at half size)")
    mode.add_argument("--inertial", action="store_true",
                      help="phase 10 (the mono-inertial loop and burst at "
                      "the EuRoC camera)")
    sub = ap.add_mutually_exclusive_group()
    sub.add_argument("--pipeline", type=int, default=0, metavar="D",
                     help="with --facade: phase 8a, pipelined to depth D")
    sub.add_argument("--async", dest="async_", action="store_true",
                     help="with --facade: phase 8b, the mapping worker, "
                     "depth-4 pipelining and the background GBA")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    if (args.pipeline or args.async_) and not args.facade:
        ap.error("--pipeline and --async go with --facade")
    torch.set_num_threads(args.threads)
    if args.facade:
        facade(args.pipeline, args.async_)
        return 0
    if args.daemon:
        daemon()
        return 0
    if args.inertial:
        inertial()
        return 0
    if args.resize:
        resize()
        return 0

    if args.loop:
        specs = [(cs.LOOP_FRAMES, cs.LOOP_ARC)]
    elif args.four:
        specs = [(cs.PHASE11_FRAMES, arc) for arc in cs.PHASE11_ARCS]
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
    tmesh = jmesh = None
    if args.four:
        from jax.sharding import Mesh

        from mam3slam_tpu_torch.parallel import mesh as pmesh
        store = tempfile.mkdtemp()
        tmesh = pmesh.init_mesh((1,), ("shard",), "gloo",
                                f"file://{store}/store", device="cpu")
        jmesh = Mesh(np.array(jax.devices()[:1]), ("shard",))
    tsys_.server = tserver.LoopServer(tsys_, tserver.ServerConfig(
        gba_mesh=tmesh))

    jcam_ = jcam.make_pinhole(FX, FY, CX, CY)
    jorb_cfg = jorb.OrbConfig(height=H, width=W, n_features=N_FEATURES)
    jsys_ = jsystem.SlamSystem(
        jsystem.SlamConfig(width=W, height=H, n_feat=jorb_cfg.capacity,
                           max_kf=MAX_KF, max_mp=MAX_MP), jcam_, seed=0)
    jsys_.server = jserver.LoopServer(jsys_, jserver.ServerConfig(
        gba_mesh=jmesh))

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
    phase = "6b" if args.loop else "11a" if args.four else "6a"
    print(f"[setup] phase={phase} size={W}x{H} "
          f"features={N_FEATURES} caps={MAX_KF}/{MAX_MP} "
          f"frames={len(arcs[0])}x{len(arcs)} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    summary("reference", jsys_, jaids, arcs, jstates, jsystem.OK)
    summary("port", tsys_, taids, arcs, tstates, tsystem.OK)
    for name, s_ in (("reference", jsys_), ("port", tsys_)):
        print(f"[{name}] gba_runs={s_.server.gba_runs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
