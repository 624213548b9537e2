"""Rank entry points of the port's distributed parity tests.

The spawned ranks import this module to find their function, so it
imports no JAX (and nothing that does): every rank would pay JAX's
import and the conftest's settings.  Each function takes the mesh first,
then port tensors, and returns numpy results (every rank returns its
own copy of the replicated result)."""

from __future__ import annotations

import os
import time

from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.parallel import dist_ba, dist_window_ba as dwb
from mam3slam_tpu_torch.parallel import mesh as M
from mam3slam_tpu_torch.slam import server, system


SOLVERS = {
    "run_ba": lambda mesh, axis, kind, edge, window, iters:
        dist_ba.dist_run_ba(edge, mesh, kind, axis=axis, iters=iters,
                            cg_iters=30),
    "dense": lambda mesh, axis, kind, edge, window, iters:
        dwb.dist_run_window_ba_dense(window, mesh, kind, axis=axis,
                                     iters=iters),
    "psum": lambda mesh, axis, kind, edge, window, iters:
        dwb.dist_run_window_ba_psum(window, mesh, kind, axis=axis,
                                    iters=iters, cg_iters=30),
    "cg": lambda mesh, axis, kind, edge, window, iters:
        dwb.dist_run_window_ba(window, mesh, kind, axis=axis, iters=iters,
                               cg_iters=30),
    "solve_dense": lambda mesh, axis, kind, edge, window, iters:
        dwb.dist_solve_window_ba(window, mesh, kind, axis=axis,
                                 iters=iters),
    "solve_psum": lambda mesh, axis, kind, edge, window, iters:
        dwb.dist_solve_window_ba(window, mesh, kind, axis=axis, iters=iters,
                                 dense_free_cap=0),
}


def solvers(mesh, names, axis, pose_axis, kind, edge_prob, window_prob,
            pose_args, iters):
    """The named distributed solvers (``SOLVERS``) over ``mesh[axis]`` and,
    given ``pose_args``, the agent-batched pose solve over
    ``mesh[pose_axis]``, on the same problems."""
    out = {name: SOLVERS[name](mesh, axis, kind, edge_prob, window_prob,
                               iters) for name in names}
    out.update(rank=M.axis_rank(mesh, axis), size=M.axis_size(mesh, axis))
    if pose_args is not None:
        out["pose"] = dist_ba.batched_pose_optimization(
            mesh, kind, pose_axis)(*pose_args)
    return convert.to_numpy(out)


def global_ba(mesh, axis, ms, cfg, map_id, kind):
    """Rank 0: the server's ``dist_global_ba`` in both branches (the dense
    one at the default cap, the psum-CG one forced), then the server's own
    ``_run_gba`` with ``gba_mesh``; the other ranks join through
    ``serve``.  Returns rank 0's states, the others' solve counts."""
    if mesh.get_rank() != 0:
        return dwb.serve(mesh)
    out = dict(
        dense=dwb.dist_global_ba(ms, cfg, mesh, map_id, kind, axis=axis),
        psum=dwb.dist_global_ba(ms, cfg, mesh, map_id, kind, axis=axis,
                                dense_free_cap=0))
    sys_ = system.SlamSystem(cfg, convert.camera_from_numpy(
        ms.kf_cam[0].numpy(), kind, "cpu"))
    sys_.ms = ms
    srv = server.LoopServer(sys_, server.ServerConfig(gba_mesh=mesh))
    srv._run_gba(map_id)
    out["server"] = sys_.ms
    dwb.stop(mesh)
    return convert.to_numpy(out)


def failing(mesh, bad_rank, seconds):
    """Rank ``bad_rank`` raises at once; the others enter a collective it
    never joins (and would wait ``seconds`` more before giving up)."""
    if mesh.get_rank() == bad_rank:
        raise ValueError("rank fault")
    time.sleep(0.1)
    M.psum(convert.tensor([1.0], "cpu"), mesh, mesh.mesh_dim_names[0])
    time.sleep(seconds)
    return os.getpid()
