"""Distributed edge-list bundle adjustment and the agent-batched pose
solve over a ``DeviceMesh`` axis.

Port of ``mam3slam_tpu.parallel.dist_ba``.  ``dist_run_ba`` shards the
observation edges over ``mesh[axis]``: every rank holds the replicated
camera and point state and its block of edges, and each segment sum of
the LM / PCG (and the cost) is all-reduced over the axis, so every rank
steps identically.  ``batched_pose_optimization`` deals the agents'
motion-only pose problems out along ``mesh[axis]``: on CUDA tensors each
rank solves its block in one launch of the pose kernel (its batch axis
B = the agents of the rank), on CPU tensors with the plain version, and
the results are gathered back.
"""

from __future__ import annotations

import torch

from mam3slam_tpu_torch.ops import cuda_pose
from mam3slam_tpu_torch.parallel import mesh as M
from mam3slam_tpu_torch.solvers import ba as ba_mod


def pad_obs_to_multiple(obs: ba_mod.Obs, n: int) -> ba_mod.Obs:
    """Edges padded to a multiple of ``n`` with inert ones (camera 0,
    point 0, w = 0, invalid)."""
    pad = (-obs.cam.shape[0]) % n
    if pad == 0:
        return obs

    def p(x):
        return torch.cat([x, torch.zeros((pad,) + x.shape[1:],
                                         dtype=x.dtype, device=x.device)])

    return ba_mod.Obs(*(p(x) for x in obs))


def dist_run_ba(problem: ba_mod.BAProblem, mesh, kind: int,
                axis: str = "edge", iters: int = 10, cg_iters: int = 30,
                **kw) -> ba_mod.BAResult:
    """``run_ba`` with the edge list sharded over ``mesh[axis]``: every
    rank passes the whole problem and gets the whole result (``inlier``
    over the padded edge list)."""
    obs = pad_obs_to_multiple(problem.obs, M.axis_size(mesh, axis))
    local = problem._replace(obs=ba_mod.Obs(
        *(M.shard_rows(x, mesh, axis) for x in obs)))
    res = ba_mod.run_ba(local, kind, iters=iters, cg_iters=cg_iters,
                        group=M.axis_group(mesh, axis), **kw)
    return res._replace(inlier=M.all_gather_rows(res.inlier, mesh, axis))


def batched_pose_optimization(mesh, kind: int, axis: str = "agent"):
    """A function optimising N agents' frame poses with the agent batch
    dealt out over ``mesh[axis]`` (N a multiple of the axis size):

    fn(q0 [N, 4], t0 [N, 3], cam_params [N, 8], pts [N, M, 3],
       uv [N, M, 2], w [N, M], valid [N, M]) -> PoseOptResult over N.
    """
    def fn(q0, t0, cam_params, pts, uv, w, valid):
        n = M.axis_size(mesh, axis)
        if q0.shape[0] % n:
            raise ValueError(f"{q0.shape[0]} agents over {n} ranks")
        lq, lt, lcam, lpts, luv, lw, lvalid = (
            M.shard_rows(x, mesh, axis).contiguous()
            for x in (q0, t0, cam_params, pts, uv, w, valid))
        q, t, inlier, n_in = cuda_pose.pose_optimization_batched(
            lq, lt, lcam, kind, lpts, luv, lw, lvalid)
        return ba_mod.PoseOptResult(
            *(M.all_gather_rows(x, mesh, axis) for x in (q, t, inlier,
                                                         n_in)))

    return fn
