"""Conversion of the reference package's state into the port and back.

Every function takes numpy-convertible leaves (numpy arrays, or anything
``np.asarray`` accepts) and returns torch tensors on the given device
(the card unless the caller names another);
``to_numpy`` maps a tensor tree back to numpy arrays.  The loop server's
keyframe database (``kf_bow_words``, ``kf_bow_vals``) is numpy in both
packages and carries over as it is.  The inertial state converts the
same way: ``ImuCalib``, ``Preintegrated`` (batched or not) and
``InertialEdges`` by field, and an agent's IMU fields, which both
packages keep on the host, by value.
"""

from __future__ import annotations

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import bow
from mam3slam_tpu_torch.slam import steps
from mam3slam_tpu_torch.solvers import imu, vi

CUDA = torch.device("cuda")


def tensor(x, device=CUDA) -> torch.Tensor:
    """numpy-convertible -> tensor with the same dtype and shape."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def camera_from_numpy(params, kind: int, device=CUDA) -> cam_mod.Camera:
    return cam_mod.Camera(tensor(np.asarray(params, np.float32), device),
                          int(kind))


def from_numpy(cls, obj, device=CUDA):
    """Any object with every field of the NamedTuple ``cls`` (a MapState,
    FrameObs, WindowProblem, TwoViewResult, PGOEdges, ...), by name ->
    ``cls`` of tensors."""
    return cls(*(tensor(getattr(obj, f), device) for f in cls._fields))


def frame_from_numpy(frame, device=CUDA) -> steps.FrameObs:
    """Any object with ``uv, level, angle, desc, valid`` -> FrameObs."""
    return from_numpy(steps.FrameObs, frame, device)


def map_state_from_numpy(ms, device=CUDA) -> S.MapState:
    """Any object with every MapState field, by name -> MapState."""
    return from_numpy(S.MapState, ms, device)


def vocabulary_from_numpy(voc, device=CUDA) -> bow.Vocabulary:
    """Any object with the Vocabulary fields -> Vocabulary."""
    return bow.Vocabulary(
        centroid_bits=tuple(tensor(c, device) for c in voc.centroid_bits),
        idf=tensor(voc.idf, device), k=int(voc.k), depth=int(voc.depth),
        leaf_map=None if voc.leaf_map is None
        else tensor(voc.leaf_map, device))


def imu_calib_from_numpy(calib, device=CUDA) -> imu.ImuCalib:
    """Any object with the ImuCalib fields -> ImuCalib of f32 scalars."""
    return imu.ImuCalib(*(tensor(np.asarray(getattr(calib, f), np.float32),
                                 device) for f in imu.ImuCalib._fields))


def preintegrated_from_numpy(p, device=CUDA) -> imu.Preintegrated:
    """Any object with the Preintegrated fields (any leading axes)."""
    return from_numpy(imu.Preintegrated, p, device)


def inertial_edges_from_numpy(edges, device=CUDA) -> vi.InertialEdges:
    """Any object with ``i, j, preint, valid`` -> InertialEdges."""
    return vi.InertialEdges(
        i=tensor(edges.i, device), j=tensor(edges.j, device),
        preint=preintegrated_from_numpy(edges.preint, device),
        valid=tensor(edges.valid, device))


# an agent's IMU state (AgentState fields of either package)
AGENT_IMU_FIELDS = ("vel_w", "bias_g", "bias_a", "imu_initialized",
                    "imu_init_map", "imu_scale", "gravity_w", "last_ts",
                    "n_fallback")


def agent_imu_from_numpy(src, dst, device=CUDA):
    """Set the port's agent ``dst``'s IMU fields from ``src`` (an
    AgentState of either package): host vectors as f32 numpy, the
    calibration as the port's on ``device``, the buffered (ts, q, t,
    gyro, acc, dts) entries as numpy."""
    def host(x):
        return None if x is None else np.array(x, np.float32)

    for f in AGENT_IMU_FIELDS:
        v = getattr(src, f)
        setattr(dst, f, host(v) if f in ("vel_w", "bias_g", "bias_a",
                                          "gravity_w") else v)
    dst.imu_calib = (None if src.imu_calib is None
                     else imu_calib_from_numpy(src.imu_calib, device))
    dst.imu_buf = [(e[0],) + tuple(host(x) for x in e[1:])
                   for e in src.imu_buf]


def to_numpy(tree):
    """Tensor, tuple (NamedTuples kept), list or dict of them -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(x) for x in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree
