#!/usr/bin/env python3
"""Find where two runs of chip_smoke.py's phase 10a or 10b split on the
card.

    python3 tools/phase10_split.py [--pairs N] [--out DIR] [--burst]
                                   [--order-b SEED] [--oplog-frames F ...]

Phase 10a (one agent with IMU on phase 6b's loop arc, ``SlamSystem`` +
``LoopServer``) runs twice in one process per pair.  After every frame
the tool takes a fingerprint of each field of ``sys.ms`` and of the
agent's tracking state (an integer sum of the raw bits, weighted by
position, so equal fingerprints mean equal bits), the agent's pose and
every live keyframe's pose.  Comparing the two runs of the first pair
gives:

* the first frame where a floating-point field differs (where a sum
  whose order changes from run to run first rounded otherwise);
* the first frame where each integer or boolean field differs (the
  first decision that came out otherwise: a match, an inlier gate, a
  culling, a keyframe), and the events of both runs;
* the growth of the split: the first frame where the agent's centre
  and the keyframes' centres are apart by more than 1e-6 .. 1e-2 of the
  orbit's span, with the events of that frame.

The later pairs log every ATen op of the first pair's first floating
frame, and of its first frame with a decision apart, in both runs
(``TorchDispatchMode``): the op's name, the port's source line that
called it and a fingerprint of its outputs.  The first op whose outputs
differ while every earlier op agreed is the op that split the runs.
Factory ops whose memory is uninitialised (``empty*``) are not
fingerprinted.  With ``--burst`` the runs are phase 10b's with IMU; with
``--order-b`` the second run of the first pair sums in another fixed
order, and both runs' per-frame tracking errors against the truth are
compared too, and each dense window BA's edges, inliers, cost and
largest camera and point steps and its LM loop's robust cost at each
linearisation, about the frame where the split passes 1e-3 of the span.  A summary goes to standard output and everything to
``<out>/phase10_split.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from mam3slam_tpu_torch import _build  # noqa: E402
from mam3slam_tpu_torch.geometry import cameras  # noqa: E402
from mam3slam_tpu_torch.io import render  # noqa: E402
from mam3slam_tpu_torch.ops import orb as O  # noqa: E402
from mam3slam_tpu_torch.ops import segsum  # noqa: E402
from mam3slam_tpu_torch.slam import system  # noqa: E402
from mam3slam_tpu_torch.slam.server import ServerConfig  # noqa: E402
from mam3slam_tpu_torch.solvers import ba_window as bw  # noqa: E402

_INT_OF = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
SKIP_OPS = ("aten.empty", "aten.new_empty", "aten._local_scalar_dense",
            "aten.set_", "aten.lift_fresh", "aten.detach", "aten.alias")
PKG = os.path.join(REPO, "mam3slam_tpu_torch") + os.sep
PLAN = segsum.segment_plan


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """An int64 scalar on ``t``'s device: the raw bits of ``t``, each
    element weighted by its position, summed (integer sums are exact in
    any order)."""
    x = t.detach().reshape(-1)
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=t.device)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous().view(_INT_OF[x.element_size()]).to(torch.int64)
    w = torch.arange(x.numel(), device=x.device) % 1000003 + 1
    return (x * w).sum()


def is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


class OpLog(TorchDispatchMode):
    """Every ATen op's name, calling port line and output fingerprints."""

    def __init__(self):
        super().__init__()
        self.rows = []     # (name, site, [(is_float, fingerprint)])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if not name.startswith(SKIP_OPS):
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            site = "?"
            for fr in reversed(traceback.extract_stack(limit=40)[:-1]):
                if fr.filename.startswith(PKG):
                    site = (f"{os.path.relpath(fr.filename, REPO)}"
                            f":{fr.lineno} {fr.name}")
                    break
            self.rows.append((name, site, [(is_float(t), fingerprint(t))
                                           for t in outs]))
        return out

    def read(self):
        """The rows with the fingerprints read to the host."""
        flat = [fp.cpu() for _, _, fps in self.rows for _, fp in fps]
        vals = torch.stack(flat).tolist() if flat else []
        out, k = [], 0
        for name, site, fps in self.rows:
            out.append((name, site, [(f, vals[k + i])
                                     for i, (f, _) in enumerate(fps)]))
            k += len(fps)
        return out


def state_prints(sys_, a) -> dict:
    """Fingerprint of every MapState field and of the agent's device
    tracking state, read in one host sync: {name: (is_float, int)}."""
    items = [(k, v) for k, v in sys_.ms._asdict().items()]
    if a.last_feat_mp is not None:
        items.append(("agent.last_feat_mp", a.last_feat_mp))
    for i, v in enumerate(a.dev_chain or ()):
        if isinstance(v, torch.Tensor):
            items.append((f"agent.dev_chain{i}", v))
    vals = torch.stack([fingerprint(v).cpu() for _, v in items]).tolist()
    return {k: (is_float(v), x) for (k, v), x in zip(items, vals)}


def run_phase10(dev, scene, cam_r, cam, orb_cfg, cfg, traj, imus,
                server: bool, oplog_frames=(), stop_after=None) -> dict:
    """Phase 10a (``server``) or 10b's run with IMU as
    chip_smoke.run_phase10 runs them (no profiled census frames), with a
    record after every frame and an op log of ``oplog_frames``; stops
    after frame ``stop_after`` when given."""
    rec = dict(prints=[], pose=[], kf=[], state=[], events=[], oplogs={},
               ba=[], lm=[])
    orig = system.SlamSystem.track
    count = [0]
    solve = bw.run_window_ba_dense

    loop = bw._lm_loop

    def logged_loop(step, *args):
        """The robust cost at each linearisation of the LM loop."""
        costs = []

        def logged_step(q, t, p, lam):
            out = step(q, t, p, lam)
            costs.append(out[3])
            return out
        out = loop(logged_step, *args)
        rec["lm"].append((count[0] - 1, torch.stack(costs).tolist()))
        return out

    def logged_solve(prob, kind, **kw):
        """Each dense window BA of the frame: edges, inliers, cost and
        the largest camera and point steps."""
        res = solve(prob, kind, **kw)
        cam, pt = prob.cam_valid[:, None], prob.pt_valid[:, None]
        vals = torch.stack([
            prob.pm_valid.sum().float(), res.pm_inlier.sum().float(),
            res.cost.float(), prob.cam_valid.sum().float(),
            torch.where(cam, (res.cam_t - prob.cam_t).abs(), 0.0).max(),
            torch.where(pt, (res.pts - prob.pts).abs(), 0.0).max()]).tolist()
        rec["ba"].append((count[0] - 1, kw.get("iters"),
                          kw.get("pm_edge_mask") is not None, *vals))
        return res

    def track(self, aid, frame, ts, imu=None):
        i = count[0]
        count[0] += 1
        if stop_after is not None and i > stop_after:
            return self.agents[aid].state, None
        n_sys = len(self.events)
        n_srv = len(self.server.events) if self.server else 0
        if i in oplog_frames:
            with OpLog() as ops:
                out = orig(self, aid, frame, ts, imu=imu)
            rec["oplogs"][i] = ops.read()
        else:
            out = orig(self, aid, frame, ts, imu=imu)
        a = self.agents[aid]
        rec["prints"].append(state_prints(self, a))
        rec["pose"].append(None if a.q is None else
                           np.concatenate([a.q, a.t]).astype(np.float64))
        ms = self.ms
        rec["kf"].append((ms.kf_valid.cpu().numpy(),
                          ms.kf_q.cpu().numpy().astype(np.float64),
                          ms.kf_t.cpu().numpy().astype(np.float64)))
        rec["state"].append(a.state)
        rec["events"].append(self.events[n_sys:] + (
            self.server.events[n_srv:] if self.server else []))
        return out

    system.SlamSystem.track = track
    bw.run_window_ba_dense = logged_solve
    bw._lm_loop = logged_loop
    try:
        r = cs.run_inertial(dev, scene, cam_r, cam, orb_cfg, cfg, traj, imus,
                            ServerConfig() if server else None)
    finally:
        system.SlamSystem.track = orig
        bw.run_window_ba_dense = solve
        bw._lm_loop = loop
    if stop_after is None:
        res = cs.inertial_results(r, traj)
        rec["ate_frac"] = res.get("ate_frac")
        rec["span"] = res.get("span")
        rec["init_frame"] = res.get("init_frame")
        rec["loop_frames"] = res.get("loop_frames")
        rec["gravity_deg"] = res.get("gravity_deg")
        rec["track_err"] = track_errors(rec, traj)
    del r
    return rec


def centre(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centre -R^T t of T_cw (q = w, x, y, z)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    return -np.einsum("...ji,...j->...i", R, t)


def track_errors(rec: dict, traj) -> list:
    """Each frame's camera-centre error against the truth after the
    similarity that aligns the run's tracked centres to it."""
    ok = [i for i, p in enumerate(rec["pose"]) if p is not None]
    est = np.stack([centre(rec["pose"][i][:4], rec["pose"][i][4:])
                    for i in ok])
    gt = np.stack([np.asarray(traj[i][2], np.float64) for i in ok])
    s, Rm, t = cs.umeyama(est, gt)
    err = np.linalg.norm(s * est @ Rm.T + t - gt, axis=1)
    out = [None] * len(rec["pose"])
    for i, e in zip(ok, err):
        out[i] = float(e)
    return out


def compare(A: dict, B: dict, span: float) -> dict:
    """Where the runs split, the first decision apart per integer field,
    and the growth of the split (fractions of ``span``)."""
    n = min(len(A["prints"]), len(B["prints"]))
    first_any, first_float, first_field = None, None, {}
    for i in range(n):
        pa, pb = A["prints"][i], B["prints"][i]
        for k in pa:
            if k in pb and pa[k] != pb[k]:
                if first_any is None:
                    first_any = i
                if pa[k][0] and first_float is None:
                    first_float = i
                first_field.setdefault(k, i)
    first_decision = min((i for k, i in first_field.items()
                          if not A["prints"][i][k][0]), default=None)
    growth, cross = [], {}
    for i in range(n):
        d_agent = None
        if A["pose"][i] is not None and B["pose"][i] is not None:
            ca = centre(A["pose"][i][:4], A["pose"][i][4:])
            cb = centre(B["pose"][i][:4], B["pose"][i][4:])
            d_agent = float(np.linalg.norm(ca - cb)) / span
        va, qa, ta = A["kf"][i]
        vb, qb, tb = B["kf"][i]
        both = va & vb
        d_kf = (float(np.linalg.norm(centre(qa[both], ta[both])
                                     - centre(qb[both], tb[both]),
                                     axis=-1).max()) / span
                if both.any() else 0.0)
        growth.append((i, d_agent, d_kf, int(va.sum()), int(vb.sum())))
        d = max(d_agent or 0.0, d_kf)
        for th in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2):
            if d > th and th not in cross:
                cross[th] = dict(frame=i, agent=d_agent, kf=d_kf,
                                 events_a=A["events"][i],
                                 events_b=B["events"][i])
    around = {}
    for i, evs in enumerate(A["events"]):
        if any(not e.startswith("KF") for e in evs):
            for f in (i - 1, i, i + 1, i + 5, i + 15):
                if 0 <= f < n:
                    around[f] = growth[f][1:3]
    around[n - 1] = growth[n - 1][1:3]
    states_apart = [i for i in range(n) if A["state"][i] != B["state"][i]]
    ev_a = [(i, e) for i, evs in enumerate(A["events"]) for e in evs]
    ev_b = [(i, e) for i, evs in enumerate(B["events"]) for e in evs]
    return dict(first_any=first_any, first_float=first_float,
                first_decision=first_decision,
                first_field=dict(sorted(first_field.items(),
                                        key=lambda kv: kv[1])),
                cross={f"{k:g}": v for k, v in sorted(cross.items())},
                around_events=around,
                states_apart=states_apart[:20],
                events_a=[(i, e) for i, e in ev_a if not e.startswith("KF")],
                events_b=[(i, e) for i, e in ev_b if not e.startswith("KF")],
                kf_counts_apart=[g[0] for g in growth if g[3] != g[4]][:20],
                growth=growth)


def ba_near_jump(A: dict, B: dict, cmp: dict, before: int = 8) -> dict:
    """Both runs' window BAs (frame, iters, masked, edges, inliers, cost,
    cameras, largest camera and point steps) from ``before`` frames
    ahead of the first frame where the split passes 1e-3 of the span to
    the frame after it."""
    jump = cmp["cross"].get("0.001", {}).get("frame")
    if jump is None:
        return {}
    return {name: [b for b in R["ba"] if jump - before <= b[0] <= jump + 1]
            + [("lm",) + c for c in R["lm"]
               if jump - before <= c[0] <= jump + 1]
            for name, R in (("a", A), ("b", B))}


def first_ops_apart(la: list, lb: list, keep: int = 12) -> dict:
    """The first ops of two op logs of one frame whose outputs differ,
    and the first of them with a floating-point output.  A write with
    duplicate indices into a scratch row that the caller drops differs
    without consequence, so the list is read with the next ops' sites."""
    n = min(len(la), len(lb))
    apart, first_float = [], None
    for k in range(n):
        (na, sa, fa), (nb, sb, fb) = la[k], lb[k]
        if na != nb or sa != sb:
            return dict(of=n, apart=apart, first_float=first_float,
                        sequence_apart=dict(index=k, a=(na, sa), b=(nb, sb)))
        if fa != fb:
            row = dict(index=k, op=na, site=sa,
                       float_out=[f for f, _ in fa],
                       next_ops=[x[1] for x in la[k + 1:k + 3]])
            if first_float is None and any(f for f, _ in fa):
                first_float = row
            if len(apart) < keep:
                apart.append(row)
            if first_float is not None and len(apart) >= keep:
                break
    return dict(of=n, apart=apart, first_float=first_float,
                count_apart=len(la) != len(lb))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=".",
                    help="directory of phase10_split.json")
    ap.add_argument("--burst", action="store_true",
                    help="phase 10b's run with IMU (no server) instead "
                    "of 10a")
    ap.add_argument("--order-b", type=int, default=None, metavar="SEED",
                    help="run B of the first pair takes each segment's "
                    "rows in a seeded random order (tools/"
                    "phase10b_orders.py), to compare two fixed orders")
    ap.add_argument("--oplog-frames", type=int, nargs="*",
                    help="frames to log op by op in the later pairs "
                    "(default: the first pair's first floating frame and "
                    "first frame with a decision apart)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase10_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    _build.library()
    cam_r = render.RenderCam(cs.W, cs.H, cs.FX, cs.FY, cs.CX, cs.CY)
    orb_cfg = O.OrbConfig(height=cs.H, width=cs.W, n_features=cs.N_FEATURES)
    cfg = system.SlamConfig(width=cs.W, height=cs.H, n_feat=orb_cfg.capacity)
    cam = cameras.make_pinhole(cs.FX, cs.FY, cs.CX, cs.CY, device=dev)
    scene = render.RoomScene(seed=cs.SERVER_SCENE_SEED, device=dev)
    if args.burst:
        motion = cs.OrbitMotion(cs.BURST_FRAMES, 0.0,
                                0.8 * (cs.BURST_FRAMES - 1),
                                bob=cs.LOOP_ARC[2], burst=(
                                    cs.BURST_AT, cs.BURST_LEN, cs.BURST_DEG),
                                shake=cs.BURST_SHAKE)
        traj, imus = motion.frames(), motion.imu(11)
    else:
        traj = render.orbit_trajectory(cs.LOOP_FRAMES, *cs.LOOP_ARC[:2],
                                       radius=2.5, bob=cs.LOOP_ARC[2])
        imus = cs.OrbitMotion(cs.LOOP_FRAMES, *cs.LOOP_ARC[:2],
                              bob=cs.LOOP_ARC[2]).imu(10)

    def run(**kw):
        return run_phase10(dev, scene, cam_r, cam, orb_cfg, cfg, traj, imus,
                           not args.burst, **kw)

    report = dict(card=smi, torch=torch.__version__, burst=args.burst,
                  order_b=args.order_b, pairs=[])
    t = time.time()
    A = run()
    if args.order_b is not None:
        from phase10b_orders import shuffled_plans

        segsum.segment_plan = shuffled_plans(args.order_b)
    try:
        B = run()
    finally:
        segsum.segment_plan = PLAN
    cmp = compare(A, B, A["span"])
    err_a, err_b = A["track_err"], B["track_err"]
    worse = [i for i in range(min(len(err_a), len(err_b)))
             if err_a[i] is not None and err_b[i] is not None
             and abs(err_a[i] - err_b[i]) > 1e-3 * A["span"]]
    pair = dict(ate_frac=(A["ate_frac"], B["ate_frac"]),
                gravity_deg=(A["gravity_deg"], B["gravity_deg"]),
                init_frame=(A["init_frame"], B["init_frame"]),
                loop_frames=(A["loop_frames"], B["loop_frames"]),
                track_err_apart_from=worse[0] if worse else None,
                window_ba_near_jump=ba_near_jump(A, B, cmp),
                track_err_every_10=[(i, err_a[i], err_b[i])
                                    for i in range(0, len(err_a), 10)],
                seconds=time.time() - t, **cmp)
    report["pairs"].append(pair)
    print("PAIR 0", json.dumps({k: v for k, v in pair.items()
                                if k != "growth"}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "phase10_split.json")
    with open(path, "w") as f:
        json.dump(report, f, default=str)
    frames = sorted(args.oplog_frames if args.oplog_frames is not None else {
        f for f in (cmp["first_float"], cmp["first_decision"])
        if f is not None})
    for p in range(1, args.pairs):
        if not frames or args.order_b is not None:
            break
        t = time.time()
        stop = max(frames)
        A2 = run(oplog_frames=frames, stop_after=stop)
        B2 = run(oplog_frames=frames, stop_after=stop)
        c2 = compare(A2, B2, A["span"])
        ops = {f: first_ops_apart(A2["oplogs"][f], B2["oplogs"][f])
               for f in frames}
        pair = dict(oplog_frames=frames, stop_after=stop,
                    first_float=c2["first_float"],
                    first_decision=c2["first_decision"],
                    first_field=c2["first_field"], ops=ops,
                    seconds=time.time() - t)
        report["pairs"].append(pair)
        print(f"PAIR {p}", json.dumps(pair, default=str), flush=True)
        with open(path, "w") as f:
            json.dump(report, f, default=str)
    print("wrote", path, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
