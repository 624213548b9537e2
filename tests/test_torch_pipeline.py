"""Pipelined tracking (``SlamSystem.pipeline``) held to the reference on
the frames of tests/test_async_mapping.py (SyntheticWorld(seed=0), 60
frames rendered once): both packages' ``SlamSystem`` at pipeline depths
1, 4 and 8, the port with the reference's RANSAC draws
(``test_torch_capacity.reference_draws``).

At every depth the runs agree on the state every ``track`` returns, the
refused-insertion counter after every call, the events (``mps=`` within
1% of the live points), the surviving ``kf_seq``, the live points
(within 1%) and, after ``flush``, the trajectory rows (reference
keyframes and states exact, relative poses within 1e-3 rad and 1e-3 of
the translation scale).  At depth 1 the port's run also equals its own
synchronous run exactly, its state view one frame late once tracking.
Depth 8 forces structurally
stale deferred frames: a keyframe lands between a frame's dispatch and
its completion, the frame's keyframe request is refused and counted,
and its found/visible deltas are dropped; the host's re-application of
the deltas on a changed state (``update_found_visible`` calls) and the
found / visible totals must agree with the reference's.
"""

import numpy as np
import pytest
import torch
from mam3slam_tpu.geometry import cameras as jcameras
from mam3slam_tpu.slam import system as jsys

from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.slam import system as tsys
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)
from test_torch_capacity import _port, assert_events_match, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
from test_torch_slam import _ang

N_FRAMES = 60
CFG = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
           n_levels=4, kf_max_interval=12, min_init_matches=60)


def _system(pkg: str, depth: int):
    """A system of ``pkg`` ("port" or "ref"), pipelined to ``depth`` (0:
    synchronous), with its ``update_found_visible`` calls counted."""
    if pkg == "port":
        sys_ = tsys.SlamSystem(tsys.SlamConfig(**CFG), cameras.make_pinhole(
            FX, FY, CX, CY, device="cpu"))
        reference_draws(sys_, 0)
    else:
        sys_ = jsys.SlamSystem(jsys.SlamConfig(**CFG),
                               jcameras.make_pinhole(FX, FY, CX, CY))
    sys_.pipeline = depth > 0
    sys_.pipeline_depth = max(depth, 1)
    sys_.fns = dict(sys_.fns)
    ufv = sys_.fns["update_found_visible"]
    sys_.stats_calls = 0

    def counted(*args):
        sys_.stats_calls += 1
        return ufv(*args)

    sys_.fns["update_found_visible"] = counted
    return sys_


def _run(pkg: str, depth: int, frames) -> dict:
    sys_ = _system(pkg, depth)
    aid = sys_.add_agent()
    states, refused = [], []
    for i, frame in enumerate(frames):
        if pkg == "port":
            frame = _port(frame)
        states.append(int(sys_.track(aid, frame, float(i))[0]))
        refused.append(sys_.agents[aid].kf_insertions_refused)
    sys_.flush()
    ms = sys_.ms
    valid = np.asarray(ms.kf_valid)
    return dict(
        sys=sys_, states=states, refused=refused, events=list(sys_.events),
        kf_seq=sorted(np.asarray(ms.kf_seq)[valid].tolist()),
        n_mp=int(np.asarray(ms.mp_valid).sum()),
        rows=[(ts, int(ref), np.asarray(q), np.asarray(t), int(st))
              for ts, ref, q, t, st in sys_.agents[aid].trajectory],
        q=np.asarray(sys_.agents[aid].q), stats_calls=sys_.stats_calls,
        found=float(np.asarray(ms.mp_found).sum()),
        visible=float(np.asarray(ms.mp_visible).sum()))


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(seed=0)
    frames = [world.render(R, t)[0] for R, t in make_trajectory(N_FRAMES)]
    out = {("port", 0): _run("port", 0, frames)}
    for depth in (1, 4, 8):
        for pkg in ("ref", "port"):
            out[pkg, depth] = _run(pkg, depth, frames)
    return out


def assert_pipelined_runs_match(port: dict, ref: dict) -> None:
    tol = 0.01 * ref["n_mp"]
    assert port["states"] == ref["states"]
    assert port["refused"] == ref["refused"]
    assert port["kf_seq"] == ref["kf_seq"]
    assert abs(port["n_mp"] - ref["n_mp"]) <= tol
    assert_events_match(port["events"], ref["events"], tol)
    assert len(port["rows"]) == len(ref["rows"]) > N_FRAMES - 8
    q_ref = np.asarray([r[2] for r in ref["rows"]])
    t_ref = np.asarray([r[3] for r in ref["rows"]])
    assert [r[:2] + r[4:] for r in port["rows"]] == \
        [r[:2] + r[4:] for r in ref["rows"]]
    assert _ang(np.asarray([r[2] for r in port["rows"]]), q_ref).max() < 1e-3
    np.testing.assert_allclose(np.asarray([r[3] for r in port["rows"]]),
                               t_ref, atol=1e-3 * np.abs(t_ref).max())


@pytest.mark.parametrize("depth", [1, 4])
def test_pipelined_run_matches_reference(runs, depth):
    port, ref = runs["port", depth], runs["ref", depth]
    assert_pipelined_runs_match(port, ref)
    assert tsys.OK in port["states"] and len(port["kf_seq"]) >= 3


def test_depth1_equals_sync_one_frame_behind(runs):
    """The same operations in the same order: the identical map, pose and
    trajectory; initialisation is not deferred, tracked frames are."""
    sync, pipe = runs["port", 0], runs["port", 1]
    for f in tsys.S.MapState._fields:
        assert torch.equal(getattr(pipe["sys"].ms, f),
                           getattr(sync["sys"].ms, f)), f
    np.testing.assert_array_equal(pipe["q"], sync["q"])
    # tests/test_async_mapping.py's view: one frame late once initialised
    assert (pipe["states"][1:] == sync["states"][:-1]
            or pipe["states"] == sync["states"])
    assert pipe["events"] == sync["events"]
    assert len(pipe["rows"]) == len(sync["rows"])
    for a, b in zip(pipe["rows"], sync["rows"]):
        assert a[:2] + a[4:] == b[:2] + b[4:]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])


def test_stale_deferred_frames_match_reference(runs):
    """Depth 8: keyframe requests of stale deferred frames are refused
    and counted, and the found/visible deltas take the reference's three
    branches (kept, re-applied, dropped)."""
    port, ref = runs["port", 8], runs["ref", 8]
    assert_pipelined_runs_match(port, ref)
    assert ref["refused"][-1] > 0
    assert port["stats_calls"] == ref["stats_calls"] > 0
    for key in ("found", "visible"):
        assert abs(port[key] - ref[key]) <= 0.01 * ref[key], key
    # dropped deltas: fewer found/visible counts than at depth 1
    assert port["visible"] < runs["port", 1]["visible"]
