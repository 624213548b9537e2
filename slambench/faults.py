"""Faults planted in the timed path, to read what the comparison makes
of a broken program: ``control.py`` reads the numbers under each on the
card at a cell's own size, and ``tests/test_slambench_faults.py`` sees
``correct`` come out false under each on the CPU.

* ``mapping_unchanged``: a step that returns its state unchanged, the
  mapping epoch (``SlamSystem._local_mapping``) leaving the map as it
  was;
* ``ba_unchanged``: the same at the bundle adjustment: every window,
  welding and global BA (``run_window_ba_dense``) returns the cameras
  and points it was given, with the inliers it found;
* ``pose_unchanged``: the same at the tracking pose: ``track_pose``
  returns the pose it started from (the motion model's prediction),
  with the inliers it found;
* ``half_the_keypoints``: half of the batch left out, every second
  keypoint of a frame dropped;
* ``descriptor_bit``: an answer altered where it is produced, the first
  byte of every descriptor inverted by the extractor.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("mapping_unchanged", "ba_unchanged", "pose_unchanged",
          "half_the_keypoints", "descriptor_bit")


def _drop_half(extract):
    def broken(img, cfg):
        f = extract(img, cfg)
        keep = torch.arange(f.valid.shape[0], device=f.valid.device) % 2 == 0
        return f._replace(valid=f.valid & keep)
    return broken


def _flip_a_byte(extract):
    def broken(img, cfg):
        f = extract(img, cfg)
        desc = f.desc.clone()
        desc[:, 0] ^= 0xFF
        return f._replace(desc=desc)
    return broken


def _ba_unchanged(run):
    def broken(prob, *args, **kwargs):
        res = run(prob, *args, **kwargs)
        return res._replace(cam_q=prob.cam_q, cam_t=prob.cam_t,
                            pts=prob.pts)
    return broken


def _pose_unchanged(track_pose):
    def broken(ms, frame, feat_mp, q0, t0, *args):
        _, _, inlier, n_in = track_pose(ms, frame, feat_mp, q0, t0, *args)
        return q0, t0, inlier, n_in
    return broken


@contextlib.contextmanager
def planted(name: str):
    """Run the body with fault ``name`` planted in the program (or none
    for ``None``), and take it out again."""
    if name is None:
        yield
        return
    from mam3slam_tpu_torch.ops import orb
    from mam3slam_tpu_torch.slam import steps, system
    from mam3slam_tpu_torch.solvers import ba_window

    owner, attr, make = {
        "mapping_unchanged": (system.SlamSystem, "_local_mapping",
                              lambda f: lambda self, a, kf: None),
        "ba_unchanged": (ba_window, "run_window_ba_dense", _ba_unchanged),
        "pose_unchanged": (steps, "track_pose", _pose_unchanged),
        "half_the_keypoints": (orb, "extract_orb", _drop_half),
        "descriptor_bit": (orb, "extract_orb", _flip_a_byte),
    }[name]
    old = owner.__dict__[attr]
    setattr(owner, attr, make(getattr(owner, attr)))
    try:
        yield
    finally:
        setattr(owner, attr, old)
