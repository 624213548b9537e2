"""Conversion of the reference package's state into the port and back.

Every function takes numpy-convertible leaves (numpy arrays, or anything
``np.asarray`` accepts) and returns torch tensors on the given device
(the card unless the caller names another);
``to_numpy`` maps a tensor tree back to numpy arrays.  The loop server's
keyframe database (``kf_bow_words``, ``kf_bow_vals``) is numpy in both
packages and carries over as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from mam3slam_tpu_torch.geometry import cameras as cam_mod
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import bow
from mam3slam_tpu_torch.slam import steps

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
