"""The port's SlamSystem with a LoopServer on the ring world of
tests/test_server_loop.py (circular tour that revisits its start), held
to that test's bounds: a LOOP event, > 90% of frames OK and ATE < 0.4
after the correction."""

import numpy as np

from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.slam.server import LoopServer, ServerConfig
from test_server_loop import RingWorld, circle_tour
from test_slam_e2e import CX, CY, FX, FY, H, N_FEAT, W, umeyama_align
from test_torch_server_e2e import (port_frame,  # noqa: F401
                                    torch_threads_per_worker)


def _run(n_frames=230):
    world = RingWorld(seed=2)
    cfg = tsys.SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=128,
                          max_mp=8192, n_levels=4, kf_max_interval=8,
                          min_init_matches=60)
    sys_ = tsys.SlamSystem(cfg, cameras.make_pinhole(FX, FY, CX, CY,
                                                      device="cpu"))
    aid = sys_.add_agent()
    sys_.server = LoopServer(sys_, ServerConfig(min_kfs_in_map=10,
                                                vocab_k=8, vocab_depth=3))
    poses = circle_tour(n_frames)
    states = []
    for i, (R, t) in enumerate(poses):
        states.append(sys_.track(aid, port_frame(world, R, t), float(i))[0])
    return sys_, aid, poses, states


def test_loop_closure_detected_and_corrected():
    sys_, aid, poses, states = _run()
    assert tsys.OK in states
    ok_frac = np.mean([s == tsys.OK for s in states[states.index(tsys.OK):]])
    assert ok_frac > 0.9, ok_frac
    loops = [e for e in sys_.server.events if e.startswith("LOOP")]
    assert loops, sys_.server.events
    assert sys_.server.gba_runs                   # single map, < 200 KF
    est, gt = [], []
    for ts, _, t_wc, st in sys_.trajectory_world(aid):
        if st != tsys.OK:
            continue
        R, t = poses[int(ts)]
        est.append(t_wc)
        gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    ate = np.sqrt(((umeyama_align(est, gt) - gt) ** 2).sum(1).mean())
    assert ate < 0.4, ate
