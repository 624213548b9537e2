"""The distributed global BA on a live map state
(``parallel/dist_window_ba.dist_global_ba`` and the server's
``ServerConfig.gba_mesh``) held to the reference, after
tests/test_dist_ba.py:270 and tests/test_two_level_mesh.py:108.

One state in both packages (``test_torch_ba_cg.live_state``: the port's
``SlamSystem`` on tests/test_dist_ba.py's 40 frames, converted into the
reference's ``MapState``).  The port's rank 0 runs ``dist_global_ba`` in
the dense branch and in the forced psum-CG branch, then the server's own
``_run_gba`` with ``gba_mesh``, while the other ranks follow in ``serve``
(spawned over gloo on the CPU: a world of 4 on "shard", and the
(host, chip) = (2, 2) mesh reducing over "chip"); the reference runs
``dist_global_ba`` on meshes of the same sizes.  Both are held to the
single-device ``global_ba`` program and to each other at the reference
tests' tolerances: keyframe translations within 5e-3 (dense) / 2e-2
(psum-CG), points within 2e-2.  A world of 1 over gloo in this process
runs the port's server ``_run_gba`` beside the reference server's with a
one-device ``gba_mesh``."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mam3slam_tpu.geometry import cameras as jcam
from mam3slam_tpu.parallel import dist_window_ba as jdwb
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu.slam import system as jsys
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.parallel import mesh as tmesh
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import system as tsys
from test_slam_e2e import CX, CY, FX, FY
from test_torch_ba_cg import live_state
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
import torch_dist_ranks

PIN = 0


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def gba(tmp_path_factory):
    ms, jms, cfg, map_id = live_state()
    worlds = (("w4", (4,), ("shard",), "shard"),
              ("w22", (2, 2), ("host", "chip"), "chip"))
    with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
        futures = {key: pool.submit(
            tmesh.run_ranks, torch_dist_ranks.global_ba, shape, names,
            str(tmp_path_factory.mktemp(key)),
            (axis, ms, cfg, map_id, PIN), backend="gloo", device="cpu",
            deadline_s=240) for key, shape, names, axis in worlds}

        jcfg = jsys.SlamConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
        jsys_ = jsys.SlamSystem(jcfg, jcam.make_pinhole(FX, FY, CX, CY))
        m4 = _jmesh((4,), ("shard",))
        ref = dict(
            local=jsys_.fns["global_ba"](jms, jnp.asarray(map_id)),
            dense=jdwb.dist_global_ba(jms, jcfg, m4, map_id, PIN),
            psum=jdwb.dist_global_ba(jms, jcfg, m4, map_id, PIN,
                                     dense_free_cap=0),
            chip=jdwb.dist_global_ba(jms, jcfg, _jmesh((2, 2),
                                                       ("host", "chip")),
                                     map_id, PIN, axis="chip"))
        jsys_.ms = jms
        jsrv = jserver.LoopServer(jsys_, jserver.ServerConfig(
            gba_mesh=_jmesh((1,), ("shard",))))
        jsrv._run_gba(map_id)
        ref["server"] = jsys_.ms
        ref = jax.tree.map(np.asarray, ref)

        local = tsys.programs(cfg, PIN)["global_ba"](ms, map_id)
        tsys_ = tsys.SlamSystem(cfg, convert.camera_from_numpy(
            ms.kf_cam[0].numpy(), PIN, "cpu"))
        tsys_.ms = ms
        store = tmp_path_factory.mktemp("world1")
        mesh1 = tmesh.init_mesh((1,), ("shard",), "gloo",
                                f"file://{store}/store", device="cpu")
        try:
            tsrv = tserver.LoopServer(tsys_, tserver.ServerConfig(
                gba_mesh=mesh1))
            tsrv._run_gba(map_id)
        finally:
            tmesh.close_mesh()
        port = dict(local=convert.to_numpy(local),
                    server1=convert.to_numpy(tsys_.ms),
                    gba_runs=tsrv.gba_runs)
        port.update({key: f.result() for key, f in futures.items()})
    sel = dict(kf=ms.kf_valid.numpy(), mp=ms.mp_valid.numpy())
    return dict(ref=ref, port=port, sel=sel, ms0=convert.to_numpy(ms))


def _held(got, want, kf_tol, sel, mp_tol=2e-2):
    np.testing.assert_allclose(got.kf_t[sel["kf"]], want.kf_t[sel["kf"]],
                               atol=kf_tol)
    np.testing.assert_allclose(got.mp_pos[sel["mp"]],
                               want.mp_pos[sel["mp"]], atol=mp_tol)


def test_the_state_moves(gba):
    """The global BA has work to do: the single-device result moves
    keyframes and points off the tracked state, the map's oldest
    keyframe stays fixed, and both packages' programs agree."""
    ms0, sel = gba["ms0"], gba["sel"]
    local = gba["port"]["local"]
    assert sel["kf"].sum() >= 3
    moved = np.abs(local.mp_pos - ms0.mp_pos)[sel["mp"]].max()
    assert moved > 1e-4
    _held(local, gba["ref"]["local"], 5e-3, sel)


@pytest.mark.parametrize("key,axis_note", [("w4", "shard"),
                                           ("w22", "chip")])
def test_dist_global_ba_dense_branch(gba, key, axis_note):
    """Few free cameras: the dense branch, on 4 ranks and on the "chip"
    axis of (2, 2), within 5e-3 (keyframes) / 2e-2 (points) of the
    single-device epoch and of the reference on the same mesh."""
    got = gba["port"][key][0]["dense"]
    _held(got, gba["port"]["local"], 5e-3, gba["sel"])
    _held(got, gba["ref"]["dense" if key == "w4" else "chip"], 5e-3,
          gba["sel"])


@pytest.mark.parametrize("key", ["w4", "w22"])
def test_dist_global_ba_psum_branch(gba, key):
    """The psum-CG branch forced (``dense_free_cap=0``): keyframes within
    2e-2 and points within 2e-2 of the single-device epoch, and of the
    reference's psum branch on 4 devices."""
    got = gba["port"][key][0]["psum"]
    _held(got, gba["port"]["local"], 2e-2, gba["sel"])
    _held(got, gba["ref"]["psum"], 2e-2, gba["sel"])


def test_followers_join_every_solve(gba):
    """Every rank but 0 joined the three solves rank 0 started (two
    ``dist_global_ba`` calls and the server's ``_run_gba``) and left its
    loop at ``stop``; the server's run on the mesh is the dense branch's
    result bit for bit."""
    for key in ("w4", "w22"):
        ranks = gba["port"][key]
        assert ranks[1:] == [3] * (len(ranks) - 1)
        for f in ("kf_q", "kf_t", "mp_pos"):
            np.testing.assert_array_equal(getattr(ranks[0]["server"], f),
                                          getattr(ranks[0]["dense"], f))


def test_server_gba_mesh_world_of_one_matches_reference(gba):
    """The port's ``LoopServer._run_gba`` with a one-rank ``gba_mesh``
    (gloo, this process) against the reference server's with a one-device
    mesh, on the same state: the same run recorded, keyframes within 5e-3
    and points within 2e-2; and the single-device epoch."""
    got = gba["port"]["server1"]
    assert gba["port"]["gba_runs"] == [int(gba["ref"]["server"].kf_map[
        gba["sel"]["kf"]][0])]
    _held(got, gba["ref"]["server"], 5e-3, gba["sel"])
    _held(got, gba["port"]["local"], 5e-3, gba["sel"])
