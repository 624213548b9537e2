"""Port twin of tests/test_hetero_cameras.py:49, held to the reference on
the same inputs: two agents with different intrinsics, added through both
packages' ``MultiAgentSystem`` from their settings files, track the same
synthetic frames (the port on CPU tensors, with the reference's RANSAC
draws), keep their own calibration per keyframe, and merge.  The port
must agree with the reference on every frame's tracking state, the
events, the keyframes' agents and calibrations and the map ids, with the
counts of map points within 1% of the reference's live points (as in
test_torch_capacity.py), and on each agent's ATE within 1e-3 of the
arc's span."""

import numpy as np

from mam3slam_tpu import api as japi
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu.slam import system as jsystem
from mam3slam_tpu_torch import api as tapi
from mam3slam_tpu_torch.slam.server import ServerConfig
from mam3slam_tpu_torch.slam.system import OK, SlamConfig
from test_hetero_cameras import CAM0, CAM1, render as render_hetero
from test_server_merge import arc_trajectory
from test_slam_e2e import H, N_FEAT, W, SyntheticWorld, umeyama_align
from test_torch_capacity import _port, assert_events_match, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


def _pinhole_yaml(k) -> str:
    return f"""%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {k["fx"]}
Camera1.fy: {k["fy"]}
Camera1.cx: {k["cx"]}
Camera1.cy: {k["cy"]}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 20
ORBextractor.nFeatures: {N_FEAT}
ORBextractor.nLevels: 4
"""


def test_two_agents_different_intrinsics_merge(tmp_path):
    """Two settings files with different intrinsics through both
    packages' ``MultiAgentSystem.add_agent``: each agent tracks with its
    own camera, every keyframe stores its agent's calibration, and the
    server merges the two maps as the reference's does (the same states,
    events, keyframes and map ids, point counts as the module states; ATE
    of agent 1 < 0.08 after alignment, and each agent's ATE within 1e-3
    of the arc's span of the reference's)."""
    world = SyntheticWorld(n_mp=1200, seed=13)
    rng = np.random.default_rng(3)
    traj0 = arc_trajectory(50, start_x=0.0)
    traj1 = arc_trajectory(50, start_x=1.1)
    frames = [(0, render_hetero(world, R, tt, CAM0, rng)) for R, tt in traj0]
    frames += [(1, render_hetero(world, R, tt, CAM1, rng))
               for R, tt in traj1]
    paths = []
    for i, k in enumerate((CAM0, CAM1)):
        paths.append(tmp_path / f"cam{i}.yaml")
        paths[-1].write_text(_pinhole_yaml(k))
    kw = dict(width=W, height=H, n_feat=N_FEAT, max_kf=96, max_mp=6144,
              n_levels=4, kf_max_interval=10, min_init_matches=60)
    scfg = dict(min_kfs_in_map=4, vocab_k=8, vocab_depth=3)
    runs = {}
    for pkg, mas in (
            ("port", tapi.MultiAgentSystem(
                slam_config=SlamConfig(**kw), device="cpu",
                server_config=ServerConfig(**scfg))),
            ("ref", japi.MultiAgentSystem(
                slam_config=jsystem.SlamConfig(**kw),
                server_config=jserver.ServerConfig(**scfg)))):
        ids = [mas.add_agent(str(p)) for p in paths]
        sys_, srv = mas.sys, mas.server
        assert ids == [0, 1] and sys_.server is srv
        if pkg == "port":
            reference_draws(sys_, 0)
            reference_draws(srv, 1234)
            frames_in = [(a, _port(f)) for a, f in frames]
        else:
            frames_in = frames
        states = [int(sys_.track(a, f, float(i))[0])
                  for i, (a, f) in enumerate(frames_in)]
        ms = sys_.ms
        kv = np.asarray(ms.kf_valid)
        ate = []
        for a, traj, t0 in ((0, traj0, 0), (1, traj1, 50)):
            est, gt = [], []
            for ts, _, tw, st in sys_.trajectory_world(a):
                if st != OK or ts < t0:
                    continue
                R, tt = traj[int(ts - t0)]
                est.append(np.asarray(tw))
                gt.append(-R.T @ tt)
            est, gt = np.array(est), np.array(gt)
            al = umeyama_align(est, gt)
            ate.append((len(est),
                        float(np.sqrt(((al - gt) ** 2).sum(axis=1).mean())),
                        float(np.ptp(gt, axis=0).max())))
        runs[pkg] = dict(
            states=states, events=list(srv.events),
            system_events=list(sys_.events),
            kf_agent=np.asarray(ms.kf_agent)[kv].tolist(),
            kf_cam=np.asarray(ms.kf_cam)[kv],
            map_ids=[a.map_id for a in sys_.agents],
            in_map=mas.get_agents_in_map(sys_.agents[0].map_id), ate=ate,
            n_mp=int(np.asarray(ms.mp_valid).sum()))
    port, ref = runs["port"], runs["ref"]
    for key in ("states", "kf_agent", "map_ids", "in_map"):
        assert port[key] == ref[key], key
    tol = 0.01 * ref["n_mp"]
    assert abs(port["n_mp"] - ref["n_mp"]) <= tol
    for key in ("events", "system_events"):
        assert_events_match(port[key], ref[key], tol)
    np.testing.assert_array_equal(port["kf_cam"], ref["kf_cam"])
    assert port["states"][-1] == port["states"][49] == OK
    assert any(e.startswith("MERGE") for e in port["events"])
    assert port["map_ids"][0] == port["map_ids"][1]
    assert port["in_map"] == [0, 1]
    agent = np.asarray(port["kf_agent"])
    assert np.allclose(port["kf_cam"][agent == 0][:, 0], CAM0["fx"])
    assert np.allclose(port["kf_cam"][agent == 1][:, 0], CAM1["fx"])
    for (n, a, span), (n_ref, a_ref, _) in zip(port["ate"], ref["ate"]):
        assert n == n_ref and abs(a - a_ref) <= 1e-3 * span
    assert port["ate"][1][0] > 25 and port["ate"][1][1] < 0.08
