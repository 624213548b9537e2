"""Twin of tests/test_four_agent_dist_gba.py (BASELINE config 5, the
4-agent centralised BA): both packages' ``SlamSystem`` + ``LoopServer``
(the port with the reference's RANSAC draws) track four overlapping
strips of SyntheticWorld(n_mp=2000, seed=11), 64 frames each; both log
the same MERGE events (>= 3) and end with every keyframe in one map.
Then the edge-list BA over that map (its first keyframe fixed): the
port's ``dist_run_ba`` on 4 ranks spawned over gloo against its own
``run_ba`` (cameras within 1e-2, the cost no worse than 1.001x the
starting one, tests/test_four_agent_dist_gba.py:56-71) and against the
reference's ``dist_run_ba`` on 4 virtual devices on the same problem.
As slow as its reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.parallel import dist_ba as jdb
from mam3slam_tpu.solvers import ba as jba
from mam3slam_tpu.slam.server import LoopServer, ServerConfig
from mam3slam_tpu.slam.system import SlamConfig, SlamSystem
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.parallel import mesh as tmesh
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.solvers import ba as tba
from test_server_merge import arc_trajectory
from test_slam_e2e import CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld
from test_torch_capacity import _port, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
import torch_dist_ranks

pytestmark = pytest.mark.slow   # as tests/test_four_agent_dist_gba.py

CFG = dict(width=W, height=H, n_feat=N_FEAT, max_kf=160, max_mp=10240,
           n_levels=4, kf_max_interval=10, min_init_matches=60)
SRV = dict(min_kfs_in_map=4, vocab_k=8, vocab_depth=3)


def test_four_agents_merge_and_distributed_ba(tmp_path):
    world = SyntheticWorld(n_mp=2000, seed=11)
    jsys_ = SlamSystem(SlamConfig(**CFG), jcam.make_pinhole(FX, FY, CX, CY))
    jsys_.server = LoopServer(jsys_, ServerConfig(**SRV))
    tsys_ = tsys.SlamSystem(tsys.SlamConfig(**CFG), tcam.make_pinhole(
        FX, FY, CX, CY, device="cpu"))
    reference_draws(tsys_, 0)
    tsys_.server = tserver.LoopServer(tsys_, tserver.ServerConfig(**SRV))
    reference_draws(tsys_.server, 1234)
    for s_ in (jsys_, tsys_):
        for _ in range(4):
            s_.add_agent()
    t_i = 0.0
    for a, start in enumerate((0.0, 1.1, 2.2, 3.3)):
        for R, t in arc_trajectory(64, start_x=start):
            f, _ = world.render(R, t)
            jsys_.track(a, f, t_i)
            tsys_.track(a, _port(f), t_i)
            t_i += 1.0

    merges = [[e.split(" kf=")[0] for e in s_.server.events
               if e.startswith("MERGE")] for s_ in (jsys_, tsys_)]
    assert merges[1] == merges[0] and len(merges[1]) >= 3, merges
    ms = tsys_.ms
    kfm = ms.kf_map[ms.kf_valid].numpy()
    assert len(np.unique(kfm)) == 1
    final = int(kfm[0])
    assert sorted(a.map_id for a in tsys_.agents) == [final] * 4

    in_map = (ms.kf_valid & (ms.kf_map == final)).clone()
    in_map[int(torch.argmax(in_map.to(torch.int32)))] = False
    prob = tsteps.build_local_ba_problem(
        ms, in_map, torch.tensor(tsys_.cfg.inv_sigma2))
    local = tba.run_ba(prob, tcam.PINHOLE, iters=6, cg_iters=30)
    dist = tmesh.run_ranks(
        torch_dist_ranks.solvers, (4,), ("edge",), str(tmp_path),
        (("run_ba",), "edge", "edge", tcam.PINHOLE, prob, None, None, 6),
        backend="gloo", device="cpu", deadline_s=600)[0]["run_ba"]
    np.testing.assert_allclose(dist.cam_t, local.cam_t.numpy(), atol=1e-2)
    cost0 = float(tba.ba_cost_and_inliers(prob, tcam.PINHOLE)[0])
    assert float(dist.cost) <= cost0 * 1.001
    jprob = jba.BAProblem(
        obs=jba.Obs(*(jnp.asarray(x.numpy()) for x in prob.obs)),
        **{f: jnp.asarray(getattr(prob, f).numpy())
           for f in jba.BAProblem._fields if f != "obs"})
    ref = jax.jit(lambda p: jdb.dist_run_ba(
        p, Mesh(np.array(jax.devices()[:4]), ("edge",)), jcam.PINHOLE,
        iters=6, cg_iters=30))(jprob)
    np.testing.assert_allclose(dist.cam_t, np.asarray(ref.cam_t), atol=1e-2)
