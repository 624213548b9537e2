"""The port's SlamSystem with a LoopServer attached, on its own, in the
worlds and configurations of the reference's server tests and held to
their bounds: the two-agent merge of tests/test_server_merge.py and the
cross-agent relocalization of tests/test_cross_agent_reloc.py.  (The
ring-world loop of tests/test_server_loop.py is in
test_torch_server_loop.py.)"""

import os

import numpy as np
import pytest
import torch

from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.slam.server import LoopServer, ServerConfig
from test_server_merge import arc_trajectory
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           umeyama_align)


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    """Each parallel test worker takes its share of the host's cores for
    torch's OpenMP pool.  By default every worker's pool spans every
    core; oversubscribed, its barriers wait on descheduled threads, and
    the server files ran more than ten times slower under six workers.
    Modules that run the server import this fixture."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)


def port_frame(world, R, t):
    """A world's rendered FrameObs as the port's."""
    f, _ = world.render(R, t)
    return tsteps.FrameObs(*(torch.from_numpy(np.array(getattr(f, k)))
                             for k in tsteps.FrameObs._fields))


def empty_frame():
    return tsteps.FrameObs(
        uv=torch.zeros(N_FEAT, 2), level=torch.zeros(N_FEAT, dtype=torch.int32),
        angle=torch.zeros(N_FEAT), desc=torch.zeros(N_FEAT, 32,
                                                     dtype=torch.uint8),
        valid=torch.zeros(N_FEAT, dtype=torch.bool))


def port_system(**kw):
    """test_server_merge.py's system and server, on the port."""
    cfg = tsys.SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=96,
                          max_mp=6144, n_levels=4, kf_max_interval=10,
                          min_init_matches=60, **kw)
    sys_ = tsys.SlamSystem(cfg, cameras.make_pinhole(FX, FY, CX, CY,
                                                      device="cpu"))
    sys_.server = LoopServer(sys_, ServerConfig(min_kfs_in_map=4, vocab_k=8,
                                                vocab_depth=3))
    return sys_


def run_two_agent_merge():
    """test_server_merge.py's run: agent 0 maps x in [0, 2.2], then agent
    1 starts at x = 1.1 and continues to 3.3.  Returns (system, both
    agents' states, agent 1's trajectory)."""
    world = SyntheticWorld(n_mp=1200, seed=1)
    sys_ = port_system()
    a0, a1 = sys_.add_agent(), sys_.add_agent()
    traj0 = arc_trajectory(50, start_x=0.0)
    traj1 = arc_trajectory(50, start_x=1.1)
    states0 = [sys_.track(a0, port_frame(world, *traj0[i]), float(i))[0]
               for i in range(50)]
    states1 = [sys_.track(a1, port_frame(world, *traj1[i]),
                          float(100 + i))[0] for i in range(50)]
    return sys_, states0, states1, traj1


def test_two_agent_merge():
    sys_, states0, states1, traj1 = run_two_agent_merge()
    srv = sys_.server
    assert tsys.OK in states0 and tsys.OK in states1
    assert [e for e in srv.events if e.startswith("MERGE")], srv.events
    a0, a1 = sys_.agents
    assert a0.map_id == a1.map_id
    kf_map = sys_.ms.kf_map.numpy()[sys_.ms.kf_valid.numpy()]
    assert len(np.unique(kf_map)) == 1
    assert srv.gba_runs == [a0.map_id]       # merged map < 200 KF
    est, gt = [], []
    for ts, _, t_wc, st in sys_.trajectory_world(a1.agent_id):
        if st != tsys.OK or ts < 100:
            continue
        R, t = traj1[int(ts - 100)]
        est.append(t_wc)
        gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    assert len(est) > 25
    ate = np.sqrt(((umeyama_align(est, gt) - gt) ** 2).sum(1).mean())
    assert ate < 0.08, ate
    # forward and reverse observations still agree after the merge
    ms = sys_.ms
    fmp = ms.kf_feat_mp.numpy()
    for p in np.where(ms.mp_valid.numpy())[0][:300]:
        for m in range(int(ms.mp_nobs[p])):
            kf, ft = int(ms.mp_obs_kf[p, m]), int(ms.mp_obs_feat[p, m])
            assert kf < 0 or fmp[kf, ft] == p


def test_agent_relocalizes_into_other_agents_map():
    world = SyntheticWorld(n_mp=1400, seed=9)
    sys_ = port_system(recently_lost_frames=12)
    a0, a1 = sys_.add_agent(), sys_.add_agent()
    t = 0.0
    for R, tt in arc_trajectory(40, start_x=0.0):
        sys_.track(a0, port_frame(world, R, tt), t)
        t += 1.0
    assert sys_.agents[a0].state == tsys.OK
    for R, tt in arc_trajectory(24, start_x=4.5):
        sys_.track(a1, port_frame(world, R, tt), t)
        t += 1.0
    assert sys_.agents[a1].state == tsys.OK
    assert sys_.agents[a1].map_id != sys_.agents[a0].map_id

    # occluded, then awake inside agent 0's region
    for _ in range(3):
        sys_.track(a1, empty_frame(), t)
        t += 1.0
    assert sys_.agents[a1].state == tsys.RECENTLY_LOST
    states = []
    for R, tt in arc_trajectory(10, start_x=0.4):
        states.append(sys_.track(a1, port_frame(world, R, tt), t)[0])
        t += 1.0
    relocs = [e for e in sys_.events if e.startswith("RELOC")]
    assert [e for e in relocs if f"-> {sys_.agents[a0].map_id}" in e], (
        sys_.events, states)
    assert sys_.agents[a1].map_id == sys_.agents[a0].map_id
    assert tsys.OK in states
    assert sorted(a.agent_id for a in sys_.agents
                  if a.map_id == sys_.agents[a0].map_id) == [0, 1]
