"""Run-artifact writers in the reference's output schema.

Port of ``mam3slam_tpu.io.writers``: ``Trajectory_{i}.txt``,
``KF_traj.txt``, ``MapLogs.txt``, ``TrackingStatus_{i}.txt``,
``reloc.txt`` and the ``Times*.txt`` series, plus the legacy TUM / KITTI
formats and the Sim3-aligned ATE.  They read a ``SlamSystem``'s map
(``ms``), its agents' trajectories (rows ``(ts, ref_kf, q_rel, t_rel,
state)`` relative to a reference keyframe), ``resolve_ref``, ``events``
and ``timers``, and a ``LoopServer``'s ``events`` and ``timers``.  Poses
are composed in float32 on the CPU.

The writers keep the reference's behaviour, faults included: the KITTI
rows skip frames that were not tracked, so a row after a loss no longer
lines up with its frame; the TUM rows are not moved so that the first
keyframe sits at the origin; the KITTI origin is the earliest keyframe
over all maps, not over the exported agent's map; ``reloc.txt`` takes
tokens 3 and 5 of the RELOC event (``map`` and ``->``), not the map ids.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import lie

OK = 2   # slam.system.OK


def _fmt_pose_row(ts, t, q_wxyz, extra=""):
    qw, qx, qy, qz = q_wxyz
    return (f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}{extra}\n")


def _makedirs_for(path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _se3(q, t) -> lie.SE3:
    return lie.SE3(torch.as_tensor(np.asarray(q, np.float32)),
                   torch.as_tensor(np.asarray(t, np.float32)))


def _kf_poses_wc(ms):
    """World-from-camera (q [K, 4], t [K, 3]) of every keyframe slot."""
    T_wc = lie.se3_inverse(_se3(ms.kf_q.cpu(), ms.kf_t.cpu()))
    return T_wc.q.numpy(), T_wc.t.numpy()


def _frame_poses_wc(system, agent_id: int):
    """Each OK-tracked frame of one agent as a world-frame camera pose,
    its reference keyframe resolved through culled ancestors (reference
    Agent::SaveTrajectory's spanning-tree walk).  Returns (ts [n], ref
    [n], t_wc [n, 3], q_wc [n, 4], R_wc [n, 3, 3])."""
    rows = [(ts, *system.resolve_ref(ref, q_rel, t_rel))
            for ts, ref, q_rel, t_rel, st
            in system.agents[agent_id].trajectory if st == OK]
    if not rows:
        return (np.zeros(0), np.zeros(0, np.int64), np.zeros((0, 3)),
                np.zeros((0, 4)), np.zeros((0, 3, 3)))
    ts = np.asarray([r[0] for r in rows], np.float64)
    ref = np.asarray([r[1] for r in rows], np.int64)
    T_rel = _se3([r[2][0] for r in rows], [r[2][1] for r in rows])
    idx = torch.as_tensor(ref)
    T_ref = lie.SE3(system.ms.kf_q.cpu()[idx], system.ms.kf_t.cpu()[idx])
    T_wc = lie.se3_inverse(lie.se3_compose(T_rel, T_ref))
    return (ts, ref, T_wc.t.numpy(), T_wc.q.numpy(),
            lie.quat_to_matrix(T_wc.q).numpy())


def save_trajectory(system, agent_id: int, path: str):
    """Per-frame camera trajectory (reference Agent::SaveTrajectory):
    Twc rows ``ts tx ty tz qx qy qz qw agent ref_KF_ts``; frames not
    tracked OK are skipped."""
    _makedirs_for(path)
    kf_ts = system.ms.kf_ts.cpu().numpy()
    ts, ref, t, q, _ = _frame_poses_wc(system, agent_id)
    rows = ["ts tx ty tz qx qy qz qw agent ref_KF_ts\n"]
    for i in range(len(ts)):
        rows.append(_fmt_pose_row(
            ts[i], t[i], q[i], extra=f" {agent_id} {kf_ts[ref[i]]:.6f}"))
    with open(path, "w") as f:
        f.writelines(rows)


def save_kf_trajectory(system, path: str):
    """All keyframes of all maps (reference
    MultiAgentSystem::SaveKFTrajectory): ``ts tx ty tz qx qy qz qw agent
    map`` with Twc poses."""
    _makedirs_for(path)
    ms = system.ms
    q, t = _kf_poses_wc(ms)
    ts = ms.kf_ts.cpu().numpy()
    agent = ms.kf_agent.cpu().numpy()
    kmap = ms.kf_map.cpu().numpy()
    rows = ["ts tx ty tz qx qy qz qw agent map\n"]
    for k in np.where(ms.kf_valid.cpu().numpy())[0]:
        rows.append(_fmt_pose_row(
            ts[k], t[k], q[k], extra=f" {agent[k]} {kmap[k]}"))
    with open(path, "w") as f:
        f.writelines(rows)


def save_tracking_status(system, agent_id: int, path: str):
    """``ts state`` per frame (reference Tracking::SaveStates)."""
    _makedirs_for(path)
    with open(path, "w") as f:
        for ts, _, _, _, st in system.agents[agent_id].trajectory:
            f.write(f"{ts:.6f} {st}\n")


def _kv(parts):
    return dict(p.split("=") for p in parts if "=" in p)


def save_map_logs(system, server, path: str):
    """Map lifecycle events (reference ``MapLogs.txt``: creations in the
    Map constructor, merges in LoopClosing)."""
    _makedirs_for(path)
    lines = []
    for e in system.events:
        if e.startswith("INIT"):
            kv = _kv(e.split()[1:])
            lines.append(
                f"Creation of map {kv['map']} with first KF ts 0.000000 "
                f"from Agent {kv['agent']}\n")
        elif e.startswith("NEWMAP"):
            kv = _kv(e.split()[1:])
            lines.append(
                f"Creation of map {kv['map']} pending init "
                f"from Agent {kv['agent']}\n")
    if server is not None:
        for e in server.events:
            if e.startswith("MERGE"):
                parts = e.split()
                kv = _kv(parts[1:])
                ts = float(kv.get("ts", 0.0))
                lines.append(
                    f"Merge of map {parts[3]} into {parts[5]} at KF of ts "
                    f"{ts:.6f} from Agent {kv.get('agent', '?')}\n")
    with open(path, "w") as f:
        f.writelines(lines)


def save_reloc(system, path: str):
    """``ts map_before map_after`` (reference reloc.txt)."""
    _makedirs_for(path)
    with open(path, "w") as f:
        for e in system.events:
            if e.startswith("RELOC"):
                # RELOC agent=i kf=k map A -> B: tokens 3 and 5 are "map"
                # and "->", as the reference writes them
                parts = e.split()
                f.write(f"0.000000 {parts[3]} {parts[5]}\n")


def save_time_series(series, path: str):
    _makedirs_for(path)
    with open(path, "w") as f:
        for ms in series:
            f.write(f"{ms:.3f}\n")


def save_times(system, agent_id: int, path: str):
    """Per-frame tracking wall time series (reference ``TimesT_i.txt``)."""
    save_time_series(system.agents[agent_id].times_ms, path)


def save_all(system, server, out_dir: str):
    """The artifact set the reference writes on Shutdown: Trajectory,
    KF_traj, TrackingStatus, MapLogs, reloc, and the Times series
    (TimesT_i tracking, TimesLM_i local mapping, TimesPR / LC / MM server
    phases)."""
    os.makedirs(out_dir, exist_ok=True)
    for a in system.agents:
        i = a.agent_id
        save_trajectory(system, i, os.path.join(out_dir,
                                                f"Trajectory_{i}.txt"))
        save_tracking_status(system, i, os.path.join(
            out_dir, f"TrackingStatus_{i}.txt"))
        save_times(system, i, os.path.join(out_dir, f"TimesT_{i}.txt"))
        lm = getattr(system, "timers", None)
        if lm is not None:
            save_time_series(lm.series.get(f"LM_{i}", []),
                             os.path.join(out_dir, f"TimesLM_{i}.txt"))
    save_kf_trajectory(system, os.path.join(out_dir, "KF_traj.txt"))
    save_map_logs(system, server, os.path.join(out_dir, "MapLogs.txt"))
    save_reloc(system, os.path.join(out_dir, "reloc.txt"))
    if server is not None and getattr(server, "timers", None) is not None:
        for phase in ("PR", "LC", "MM"):
            save_time_series(server.timers.series.get(phase, []),
                             os.path.join(out_dir, f"Times{phase}.txt"))


# ---------------------------------------------------------------------------
# legacy single-agent formats (reference src/System.cc:593-1276), for
# standard evaluation tools (evo, TUM / KITTI scripts)
# ---------------------------------------------------------------------------

def save_trajectory_tum(system, agent_id: int, path: str):
    """Per-frame trajectory in TUM-RGBD format ``ts tx ty tz qx qy qz qw``
    (reference System::SaveTrajectoryTUM).  Monocular, so the scale is
    free: evaluation needs a Sim3 alignment (``ate_rmse``, evo's ``-as``).
    Like the reference it does not move the first keyframe to the
    origin."""
    _makedirs_for(path)
    ts, _, t, q, _ = _frame_poses_wc(system, agent_id)
    with open(path, "w") as f:
        for i in range(len(ts)):
            f.write(_fmt_pose_row(ts[i], t[i], q[i]))


def save_kf_trajectory_tum(system, path: str, map_id=None):
    """Keyframe trajectory in TUM format, timestamp-ordered (reference
    System::SaveKeyFrameTrajectoryTUM); ``map_id`` restricts it to one
    map."""
    _makedirs_for(path)
    ms = system.ms
    valid = ms.kf_valid.cpu().numpy()
    if map_id is not None:
        valid = valid & (ms.kf_map.cpu().numpy() == map_id)
    q, t = _kf_poses_wc(ms)
    ts = ms.kf_ts.cpu().numpy()
    idx = np.where(valid)[0]
    idx = idx[np.argsort(ts[idx], kind="stable")]
    with open(path, "w") as f:
        for k in idx:
            f.write(_fmt_pose_row(ts[k], t[k], q[k]))


def save_trajectory_kitti(system, agent_id: int, path: str):
    """Per-frame trajectory in KITTI odometry format: 12 floats a row, the
    top 3x4 of ``[R_0c | t_0c]`` with the earliest keyframe (over all
    maps, as the reference takes it) at the origin (reference
    System::SaveTrajectoryKITTI).  Frames not tracked OK have no row."""
    _makedirs_for(path)
    ms = system.ms
    valid = np.where(ms.kf_valid.cpu().numpy())[0]
    rows = []
    if len(valid):
        k0 = int(valid[np.argmin(ms.kf_ts.cpu().numpy()[valid])])
        T0_wc = lie.se3_inverse(lie.SE3(ms.kf_q[k0].cpu(), ms.kf_t[k0].cpu()))
        R0 = lie.quat_to_matrix(T0_wc.q).numpy()
        t0 = T0_wc.t.numpy()
        _, _, ts_t, _, ts_R = _frame_poses_wc(system, agent_id)
        for t, R in zip(ts_t, ts_R):
            R_0c = R0.T @ R                     # T_0c = T0_cw * T_wc
            t_0c = R0.T @ (t - t0)
            v = np.concatenate(
                [np.concatenate([R_0c[i], t_0c[i:i + 1]]) for i in range(3)])
            rows.append(" ".join(f"{x:.9f}" for x in v) + "\n")
    with open(path, "w") as f:
        f.writelines(rows)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray,
             align_scale: bool = True) -> float:
    """Absolute trajectory error after Sim3 (Umeyama) alignment, the
    standard monocular EuRoC metric."""
    mx, my = est_xyz.mean(0), gt_xyz.mean(0)
    Xc, Yc = est_xyz - mx, gt_xyz - my
    U, D, Vt = np.linalg.svd(Yc.T @ Xc / len(est_xyz))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / (Xc ** 2).sum() * len(est_xyz)
         if align_scale else 1.0)
    aligned = (s * (R @ Xc.T)).T + my
    return float(np.sqrt(((aligned - gt_xyz) ** 2).sum(axis=1).mean()))
