"""Atlas checkpoints (``mapstate/checkpoint.py``) against the reference's
format, on the run of tests/test_checkpoint.py (SyntheticWorld(n_mp=900,
seed=6), 35 frames of ``arc_trajectory(60)`` with a loop server that
trains its vocabulary):

* the port saves and reloads every ``MapState`` field and dtype exactly,
  the agents and the server's vocabulary and keyframe database;
* a file the reference saved loads in the port, and a file the port
  saved loads in the reference, each equal to ``convert``'s image of the
  other's state;
* an old file (without ``kf_seq``, the loop edges and the points' first
  agent) loads to identical states in both packages, the loop edges at
  64 slots whatever the system's configuration says;
* a resumed port system keeps tracking the same world: > 90% of 20
  further frames OK and a growing map (tests/test_checkpoint.py:26).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from mam3slam_tpu.geometry import cameras as jcameras
from mam3slam_tpu.mapstate import checkpoint as jcheckpoint
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.ops import bow as jbow
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu.slam import system as jsys

from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.mapstate import checkpoint
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import system as tsys
from test_server_merge import arc_trajectory
from test_slam_e2e import CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld
from test_torch_server_e2e import port_frame
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

CFG = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
           n_levels=4, kf_max_interval=10, min_init_matches=60)
SRV = dict(min_kfs_in_map=4, vocab_k=8, vocab_depth=3)
OLD_FILE_DROPS = ("ms_kf_seq", "ms_loop_i", "ms_loop_j", "ms_loop_valid",
                  "ms_mp_first_agent", "ms_mp_first_agent_kf")


def port_system(**cfg):
    sys_ = tsys.SlamSystem(tsys.SlamConfig(**{**CFG, **cfg}),
                           cameras.make_pinhole(FX, FY, CX, CY, device="cpu"))
    sys_.server = tserver.LoopServer(sys_, tserver.ServerConfig(**SRV))
    return sys_


def ref_system():
    """A reference system and server (nothing compiled: loading and
    saving are eager)."""
    sys_ = jsys.SlamSystem(jsys.SlamConfig(**CFG),
                           jcameras.make_pinhole(FX, FY, CX, CY))
    sys_.server = jserver.LoopServer(sys_, jserver.ServerConfig(**SRV))
    return sys_


@pytest.fixture(scope="module")
def world_run():
    world = SyntheticWorld(n_mp=900, seed=6)
    traj = arc_trajectory(60)
    sys_ = port_system()
    aid = sys_.add_agent()
    for i in range(35):
        sys_.track(aid, port_frame(world, *traj[i]), float(i))
    assert sys_.agents[aid].state == tsys.OK
    assert sys_.server.voc is not None
    return sys_, world, traj


def as_reference(port) -> jsys.SlamSystem:
    """A reference system holding the port system's state."""
    ref = ref_system()
    ref.ms = JS.MapState(*(jnp.asarray(x) for x in
                               convert.to_numpy(port.ms)))
    for a in port.agents:
        b = ref.agents[ref.add_agent()]
        b.state, b.map_id, b.ref_kf, b.next_agent_kf_id = (
            a.state, a.map_id, a.ref_kf, a.next_agent_kf_id)
        b.q, b.t = jnp.asarray(a.q), jnp.asarray(a.t)
    voc = port.server.voc
    ref.server.voc = jbow.Vocabulary(
        centroid_bits=tuple(jnp.asarray(c.numpy()) for c in
                            voc.centroid_bits),
        idf=jnp.asarray(voc.idf.numpy()), k=voc.k, depth=voc.depth,
        leaf_map=None)
    ref.server.kf_bow_words = port.server.kf_bow_words.copy()
    ref.server.kf_bow_vals = port.server.kf_bow_vals.copy()
    return ref


def assert_state_equals(ms, ref_np) -> None:
    """A port MapState equals numpy fields: values, dtypes, shapes."""
    for f, want in zip(S.MapState._fields, ref_np):
        got = convert.to_numpy(getattr(ms, f))
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def assert_agents_equal(port_agents, ref_agents) -> None:
    assert len(port_agents) == len(ref_agents)
    for a, b in zip(port_agents, ref_agents):
        assert (a.state, a.map_id, a.ref_kf, a.next_agent_kf_id) == (
            b.state, b.map_id, b.ref_kf, b.next_agent_kf_id)
        np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
        np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))


def assert_server_equal(srv, ref_srv) -> None:
    assert (srv.voc.k, srv.voc.depth) == (ref_srv.voc.k, ref_srv.voc.depth)
    for c, d in zip(srv.voc.centroid_bits, ref_srv.voc.centroid_bits):
        np.testing.assert_array_equal(c.cpu().numpy(), np.asarray(d))
    np.testing.assert_array_equal(srv.voc.idf.cpu().numpy(),
                                  np.asarray(ref_srv.voc.idf))
    np.testing.assert_array_equal(srv.kf_bow_words, ref_srv.kf_bow_words)
    np.testing.assert_array_equal(srv.kf_bow_vals, ref_srv.kf_bow_vals)


def test_port_roundtrip_is_exact(world_run, tmp_path):
    sys1 = world_run[0]
    path = str(tmp_path / "atlas.npz")
    checkpoint.save_atlas(sys1, path, server=sys1.server)
    with np.load(path) as data:
        assert data["agent_scalars"].dtype == np.int64
        assert data["agent_scalars"].shape == (1, 5)
    sys2 = port_system()
    checkpoint.load_atlas(sys2, path, server=sys2.server)
    for f in S.MapState._fields:
        a, b = getattr(sys1.ms, f), getattr(sys2.ms, f)
        assert a.dtype == b.dtype and b.device == sys2.device, f
        assert torch.equal(a, b), f
    assert_agents_equal(sys2.agents, sys1.agents)
    a2 = sys2.agents[0]
    assert a2.dev_chain is None and a2.vel_q is None
    assert_server_equal(sys2.server, sys1.server)


def test_files_load_across_packages(world_run, tmp_path):
    port = world_run[0]
    ref = as_reference(port)
    # reference file -> port
    jpath = str(tmp_path / "ref.npz")
    jcheckpoint.save_atlas(ref, jpath, server=ref.server)
    sys2 = port_system()
    checkpoint.load_atlas(sys2, jpath, server=sys2.server)
    assert_state_equals(sys2.ms, convert.to_numpy(port.ms))
    assert_agents_equal(sys2.agents, ref.agents)
    assert_server_equal(sys2.server, ref.server)
    # port file -> reference
    tpath = str(tmp_path / "port.npz")
    checkpoint.save_atlas(port, tpath, server=port.server)
    ref2 = ref_system()
    jcheckpoint.load_atlas(ref2, tpath, server=ref2.server)
    back = convert.map_state_from_numpy(
        JS.MapState(*(np.asarray(x) for x in ref2.ms)), device="cpu")
    for f in S.MapState._fields:
        assert torch.equal(getattr(back, f), getattr(port.ms, f)), f
    assert_agents_equal(port.agents, ref2.agents)
    assert_server_equal(port.server, ref2.server)
    # the two packages write the same arrays
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_old_files_load_alike(world_run, tmp_path):
    port = world_run[0]
    path = str(tmp_path / "atlas.npz")
    checkpoint.save_atlas(port, path, server=port.server)
    with np.load(path) as data:
        old = {k: data[k] for k in data.files if k not in OLD_FILE_DROPS}
    old_path = str(tmp_path / "old.npz")
    np.savez_compressed(old_path, **old)
    # the filled loop-edge fields keep the old files' 64 slots even where
    # the system's arena has another number
    sys2 = port_system()
    sys2.ms = S.init_map_state(S.MapConfig(
        max_kf=CFG["max_kf"], max_mp=CFG["max_mp"], n_feat=N_FEAT,
        max_loop_edges=16), device="cpu")
    checkpoint.load_atlas(sys2, old_path, server=sys2.server)
    ref2 = ref_system()
    jcheckpoint.load_atlas(ref2, old_path, server=ref2.server)
    assert_state_equals(sys2.ms, [np.asarray(x) for x in ref2.ms])
    assert_agents_equal(sys2.agents, ref2.agents)
    assert sys2.ms.loop_i.shape == (64,) and not sys2.ms.loop_valid.any()
    assert (sys2.ms.mp_first_agent == -1).all()
    kf_valid = port.ms.kf_valid
    assert torch.equal(sys2.ms.kf_seq[kf_valid],
                       torch.nonzero(kf_valid)[:, 0].to(torch.int32))


def test_resumed_system_keeps_tracking(world_run, tmp_path):
    sys1, world, traj = world_run
    path = str(tmp_path / "atlas.npz")
    checkpoint.save_atlas(sys1, path, server=sys1.server)
    n_kf1 = int(sys1.ms.kf_valid.sum())
    sys2 = port_system()
    checkpoint.load_atlas(sys2, path, server=sys2.server)
    a2 = sys2.agents[0]
    assert a2.state == tsys.OK and a2.ref_kf == sys1.agents[0].ref_kf
    states = [sys2.track(0, port_frame(world, *traj[i]), float(i))[0]
              for i in range(35, 55)]
    assert np.mean([s == tsys.OK for s in states]) > 0.9, states
    assert int(sys2.ms.kf_valid.sum()) > n_kf1          # the map grew
