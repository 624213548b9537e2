"""The comparison that decides ``correct``.

What the window produced is held to the plain references under ``ref/``
once the window has closed:

* extraction: the features the program stored with a sample of each
  mission's keyframes (drawn from the seed) against the frozen plain ORB
  (``ref/orb.py``, float32) run on the same staged frame: the share of
  keypoints (level, x, y) that one side has and the other lacks
  (``kp_mismatch``), and the mean number of descriptor bits that differ
  on the keypoints both have (``desc_bits``);
* tracking: each agent's trajectory of a whole mission, OK frames only,
  after Sim3 alignment against the poses the frames were rendered from
  (``ate_frac``: RMSE over the span), and the share of frames not OK
  after the agent's first OK frame, in every mission (``lost_share``);
  every agent fed ``init_frames`` frames has an OK frame among them;
* mapping: the agent's map points after the same alignment, their
  median distance to the room's faces over the span (``map_dist_frac``);
* the server: the LOOP and MERGE events each whole mission must and must
  not have (the mix's ``expect``), and for a mix whose agents share no
  room, one map per agent.

The deployment states the limits of ``ate_frac`` and ``lost_share``
(its ``guarantees``, the reference's own gates for a mission that closes
its loop); the others (``limits``) lie between what sound runs of the
program read and what the bfloat16 control or a planted fault
(``faults.py``) reads, and a mix may set its own (its ``limits``, over
both; PERF.md gives the readings).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from slambench import traffic as traffic_mod
from slambench.ref import geometry
from slambench.ref import orb as ref_orb

OK = 2  # the program's tracking state OK (its slam.system.OK)


@dataclass
class MissionRecord:
    """What the check reads of one mission, copied to the host once the
    window has closed."""

    complete: bool
    states: List[List[int]]           # per agent, per frame fed
    trajectories: List[list]          # per agent: (ts, q_wc, t_wc, state)
    map_ids: List[int]
    loops: int
    merges: int
    events: List[str]
    mp_pos: np.ndarray
    mp_map: np.ndarray
    kf_ts: np.ndarray                 # valid keyframes only, as below
    kf_agent: np.ndarray
    kf_uv: np.ndarray
    kf_level: np.ndarray
    kf_desc: np.ndarray
    kf_valid_feat: np.ndarray


def record_mission(mas, states, complete: bool) -> MissionRecord:
    """Copy what the check needs from a mission's system to the host."""
    sys_ = mas.sys
    ms = sys_.ms
    kv = ms.kf_valid.cpu().numpy()
    mv = ms.mp_valid.cpu().numpy()
    events = list(mas.server.events) if mas.server is not None else []
    return MissionRecord(
        complete=complete,
        states=[list(s) for s in states],
        trajectories=[sys_.trajectory_world(a.agent_id) for a in sys_.agents],
        map_ids=[a.map_id for a in sys_.agents],
        loops=sum(e.startswith("LOOP") for e in events),
        merges=sum(e.startswith("MERGE") for e in events),
        events=events + list(sys_.events),
        mp_pos=ms.mp_pos.cpu().numpy()[mv].astype(np.float64),
        mp_map=ms.mp_map.cpu().numpy()[mv],
        kf_ts=ms.kf_ts.cpu().numpy()[kv],
        kf_agent=ms.kf_agent.cpu().numpy()[kv],
        kf_uv=ms.kf_feat_uv.cpu().numpy()[kv],
        kf_level=ms.kf_feat_level.cpu().numpy()[kv],
        kf_desc=ms.kf_feat_desc.cpu().numpy()[kv],
        kf_valid_feat=ms.kf_feat_valid.cpu().numpy()[kv])


def orb_gap(prog: dict, ref: dict):
    """(keypoints only one side has, keypoints of either side, differing
    bits summed over the shared keypoints, shared keypoints) of one frame.
    Each side: ``level`` [N], level coordinates ``x``, ``y`` [N] and
    ``desc`` [N, 32] u8, valid rows only."""
    kp = {k: i for i, k in enumerate(zip(prog["level"].tolist(),
                                         prog["x"].tolist(),
                                         prog["y"].tolist()))}
    kr = {k: i for i, k in enumerate(zip(ref["level"].tolist(),
                                         ref["x"].tolist(),
                                         ref["y"].tolist()))}
    both = [k for k in kp if k in kr]
    only = len(kp) + len(kr) - 2 * len(both)
    if both:
        ip = np.asarray([kp[k] for k in both])
        ir = np.asarray([kr[k] for k in both])
        bits = int(np.unpackbits(prog["desc"][ip] ^ ref["desc"][ir],
                                 axis=1).sum())
    else:
        bits = 0
    return only, len(kp) + len(kr) - len(both), bits, len(both)


def ref_features(img: torch.Tensor, cfg: ref_orb.OrbConfig,
                 dtype=torch.float32) -> dict:
    f = ref_orb.extract(img.to(torch.float32), cfg, dtype)
    v = f["valid"].cpu().numpy()
    xy = f["xy"].cpu().numpy()[v]
    return dict(level=f["level"].cpu().numpy()[v], x=xy[:, 0], y=xy[:, 1],
                desc=f["desc"].cpu().numpy()[v])


def stored_features(rec: MissionRecord, j: int, scales) -> dict:
    """Keyframe ``j``'s stored features as level coordinates: the stored
    match-space position over the level's scale, rounded (the extractor's
    positions are level pixels times the scale; a pinhole with no
    distortion maps them to themselves to rounding)."""
    v = rec.kf_valid_feat[j]
    lvl = rec.kf_level[j][v]
    uv = rec.kf_uv[j][v] / np.asarray(scales, np.float64)[lvl][:, None]
    xy = np.floor(uv + 0.5).astype(np.int64)
    return dict(level=lvl, x=xy[:, 0], y=xy[:, 1], desc=rec.kf_desc[j][v])


def sample_keyframes(rec: MissionRecord, rng, n: int) -> List[int]:
    k = len(rec.kf_ts)
    return sorted(rng.choice(k, size=min(n, k), replace=False).tolist())


def orb_readings(records, agents, orb_cfg, scales, rng, n_per_mission: int,
                 dtype=torch.float32, against_program: bool = True):
    """``kp_mismatch`` and ``desc_bits`` over a sample of each mission's
    keyframes.  With ``against_program`` the program's stored features
    are compared with the reference computed in ``dtype``; without it
    (the control) the reference in ``dtype`` is compared with the
    reference in float32 on the same frames."""
    only = union = bits = shared = 0
    for rec in records:
        for j in sample_keyframes(rec, rng, n_per_mission):
            ag = agents[int(rec.kf_agent[j])]
            img = ag.frames[traffic_mod.frame_of(float(rec.kf_ts[j]), ag.fps)]
            ref32 = ref_features(img, orb_cfg)
            other = (stored_features(rec, j, scales) if against_program
                     else ref_features(img, orb_cfg, dtype))
            o, u, b, s = orb_gap(other, ref32)
            only, union, bits, shared = (only + o, union + u, bits + b,
                                         shared + s)
    return dict(kp_mismatch=only / max(union, 1),
                desc_bits=bits / max(shared, 1)), union


def drift(est: np.ndarray, gt: np.ndarray, span: float) -> dict:
    """How an agent's error is made, printed beside ``ate_frac`` and not
    compared: each half of the trajectory aligned on its own
    (``ate_frac_halves``, the worse half), and the second half's Sim3
    scale over the first's (``scale_ratio``).  Halves that align well
    while the whole does not, and a ratio away from 1, are a drift that
    accumulates along the arc; a bad half is a jump within it."""
    h = len(est) // 2
    if h < 3:
        return {}
    (r1, s1, _), (r2, s2, _) = (geometry.ate(est[:h], gt[:h]),
                                geometry.ate(est[h:], gt[h:]))
    return dict(ate_frac_halves=max(r1, r2) / span,
                scale_ratio=float(s2[0] / s1[0]))


def tracking_readings(records, agents, init_frames: int):
    """``ate_frac`` and ``map_dist_frac`` (worst over the whole missions'
    agents) and ``lost_share`` (worst over every mission's agents), the
    frames fed and the frames not OK after their agent's first OK, and
    the faults found (an agent that never initialised)."""
    ate_frac, map_frac, lost = 0.0, 0.0, 0.0
    attempted = failed = 0
    faults = []
    detail = []
    for m, rec in enumerate(records):
        for k, states in enumerate(rec.states):
            attempted += len(states)
            if OK not in states:
                if len(states) >= init_frames:
                    faults.append(f"mission {m} agent {k}: no OK frame in "
                                  f"{len(states)}")
                continue
            first = states.index(OK)
            if first >= init_frames:
                faults.append(f"mission {m} agent {k}: first OK at {first}")
            bad = sum(s != OK for s in states[first:])
            failed += bad
            lost = max(lost, bad / len(states[first:]))
            if not rec.complete:
                continue
            ag = agents[k]
            rows = [r for r in rec.trajectories[k] if r[3] == OK]
            if len(rows) < 3:
                faults.append(f"mission {m} agent {k}: {len(rows)} OK poses")
                continue
            est = np.asarray([r[2] for r in rows], np.float64)
            gt = ag.centres[[traffic_mod.frame_of(r[0], ag.fps)
                             for r in rows]]
            rmse, sim3, span = geometry.ate(est, gt)
            ate_frac = max(ate_frac, rmse / span)
            pts = rec.mp_pos[rec.mp_map == rec.map_ids[k]]
            if len(pts) == 0:
                faults.append(f"mission {m} agent {k}: no map points")
                continue
            d = geometry.room_distance(geometry.apply_sim3(sim3, pts))
            map_frac = max(map_frac, float(np.median(d)) / span)
            detail.append(dict(mission=m, agent=k, ate_frac=rmse / span,
                               map_dist_frac=float(np.median(d)) / span,
                               points=len(pts), loops=rec.loops,
                               **drift(est, gt, span)))
    return (dict(ate_frac=ate_frac, lost_share=lost,
                 map_dist_frac=map_frac), attempted, failed, faults, detail)


def server_faults(records, expect: dict, n_agents: int, shared_rooms: bool):
    faults = []
    for m, rec in enumerate(records):
        lo = expect.get("loops_min", 0)
        if rec.complete and rec.loops < lo:
            faults.append(f"mission {m}: {rec.loops} LOOP (want >= {lo})")
        for kind, n in (("loops_max", rec.loops), ("merges_max", rec.merges)):
            if kind in expect and n > expect[kind]:
                faults.append(f"mission {m}: {n} {kind[:-4].upper()} "
                              f"(want <= {expect[kind]})")
        if not shared_rooms and len(set(rec.map_ids)) != n_agents:
            faults.append(f"mission {m}: maps {rec.map_ids} for agents in "
                          f"rooms of their own")
    return faults


def judge(values: Dict[str, float], limits: Dict[str, float],
          faults: List[str], n_complete: int) -> tuple:
    """(correct, [(name, value, limit)], faults): every number at or under
    its limit, no fault, and at least one whole mission."""
    rows = [(k, float(values[k]), float(limits[k])) for k in limits]
    faults = list(faults)
    if n_complete == 0:
        faults.append("no mission completed in the window")
    ok = not faults and all(v <= lim for _, v, lim in rows)
    return ok, rows, faults


def limits_of(config: dict, traffic: dict) -> Dict[str, float]:
    out = dict(config["limits"])
    out.update(config["guarantees"])
    out.update(traffic.get("limits", {}))
    return out


def shared_rooms(traffic: dict) -> bool:
    rooms = [a["room"] for a in traffic["agents"]]
    return len(set(rooms)) < len(rooms)


def run_check(records, agents, config: dict, traffic: dict, seed: int,
              orb_cfg, scales) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    orb_vals, _ = orb_readings(records, agents, orb_cfg, scales, rng,
                               int(config["orb_samples_per_mission"]))
    trk_vals, attempted, failed, faults, detail = tracking_readings(
        records, agents, int(config["init_frames"]))
    faults += server_faults(records, traffic.get("expect", {}),
                            len(traffic["agents"]), shared_rooms(traffic))
    correct, rows, faults = judge({**orb_vals, **trk_vals},
                                  limits_of(config, traffic), faults,
                                  sum(r.complete for r in records))
    return dict(correct=correct, rows=rows, faults=faults,
                attempted=attempted, failed=failed, detail=detail)


def control_readings(records, agents, orb_cfg, scales, seed: int,
                     n_per_mission: int, dtype) -> dict:
    """The control: the reference in ``dtype`` in the program's place, on
    the same keyframes' frames that the check samples."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    vals, _ = orb_readings(records, agents, orb_cfg, scales, rng,
                           n_per_mission, dtype=dtype, against_program=False)
    return vals
