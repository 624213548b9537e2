"""Conversion of the reference package's state into the port and back.

Every function takes numpy-convertible leaves (numpy arrays, or anything
``np.asarray`` accepts) and returns torch tensors on the given device;
``to_numpy`` maps a tensor tree back to numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.slam import steps


def tensor(x, device=None) -> torch.Tensor:
    """numpy-convertible -> tensor with the same dtype and shape."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def camera_from_numpy(params, kind: int, device=None) -> cam_mod.Camera:
    return cam_mod.Camera(tensor(np.asarray(params, np.float32), device),
                          int(kind))


def from_numpy(cls, obj, device=None):
    """Any object with every field of the NamedTuple ``cls`` (a MapState,
    FrameObs, WindowProblem, TwoViewResult, ...), by name -> ``cls`` of
    tensors."""
    return cls(*(tensor(getattr(obj, f), device) for f in cls._fields))


def frame_from_numpy(frame, device=None) -> steps.FrameObs:
    """Any object with ``uv, level, angle, desc, valid`` -> FrameObs."""
    return from_numpy(steps.FrameObs, frame, device)


def map_state_from_numpy(ms, device=None) -> S.MapState:
    """Any object with every MapState field, by name -> MapState."""
    return from_numpy(S.MapState, ms, device)


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
