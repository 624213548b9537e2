"""The port's asynchronous mapping worker (``SlamSystem(async_mapping=
True)``) on the synthetic worlds of tests/test_async_mapping.py:

* with ``flush`` after every frame the asynchronous system performs the
  synchronous system's operations in the same order: every state, event
  and ``MapState`` field is identical;
* back-pressure: while the worker is busy, keyframe insertions are
  refused and counted per agent; more than 5 refusals force the next weak
  frame's insertion (condition c1d); once the worker is free an insertion
  goes through and resets the count;
* an exception raised inside a mapping job is re-raised by the next
  ``track`` and by ``flush``; ``shutdown`` joins the worker;
* forward-mode jacobians taken by several threads at once (the tracking
  thread's relocalization and the worker's server) all succeed and equal
  a lone one;
* asynchronous mapping with depth-4 pipelined tracking keeps
  tests/test_async_mapping.py's ATE bound (3% of the span).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.utils import autodiff
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory, umeyama_align)
from test_torch_capacity import _port
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


def _system(async_mapping=True, **kw):
    base = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
                n_levels=4, kf_max_interval=12, min_init_matches=60)
    base.update(kw)
    return tsys.SlamSystem(tsys.SlamConfig(**base), cameras.make_pinhole(
        FX, FY, CX, CY, device="cpu"), async_mapping=async_mapping)


def _frames(n, seed=0):
    world = SyntheticWorld(seed=seed)
    return [_port(world.render(R, t)[0]) for R, t in make_trajectory(n)]


def test_flushed_async_equals_sync():
    frames = _frames(50)
    runs = []
    for async_mapping in (False, True):
        sys_ = _system(async_mapping)
        aid = sys_.add_agent()
        states = []
        for i, frame in enumerate(frames):
            states.append(sys_.track(aid, frame, float(i))[0])
            sys_.flush()
        sys_.shutdown()
        runs.append((sys_, states))
    (sync, st_sync), (asy, st_async) = runs
    assert st_async == st_sync and tsys.OK in st_sync
    assert asy.events == sync.events
    assert len(asy.epochs) == len(sync.epochs) >= 2
    assert asy.ms_epoch == sync.ms_epoch
    for f in tsys.S.MapState._fields:
        assert torch.equal(getattr(asy.ms, f), getattr(sync.ms, f)), f
    assert not asy._worker.is_alive()


def _blocking_mapping(sys_):
    """Hold every mapping job until the returned event is set."""
    release = threading.Event()
    run = sys_._local_mapping

    def blocked(a, kf):
        release.wait(timeout=120)
        return run(a, kf)

    sys_._local_mapping = blocked
    return release


def test_busy_worker_refuses_and_counts_insertions():
    # a keyframe request on nearly every frame (the reference's
    # back-pressure test), the worker held busy once tracking runs
    sys_ = _system(kf_max_interval=2, kf_min_interval=1)
    aid = sys_.add_agent()
    a = sys_.agents[aid]
    frames = _frames(30, seed=3)
    i = 0
    while a.state != tsys.OK:
        sys_.track(aid, frames[i], float(i))
        i += 1
    release = _blocking_mapping(sys_)
    n_kf = int(sys_.ms.n_kf)          # insertions so far (culling aside)
    refused = []
    while a.kf_insertions_refused <= 5:
        sys_.track(aid, frames[i], float(i))
        refused.append(a.kf_insertions_refused)
        i += 1
    # one insertion went through and queued its job; the rest were refused
    assert sys_._pending_mapping == 1
    assert int(sys_.ms.n_kf) == n_kf + 1
    assert refused[-1] == 6 and refused == sorted(refused)
    assert a.state == tsys.OK
    release.set()
    sys_.flush()
    # free again: the next insertion is accepted and resets the count
    while a.kf_insertions_refused:
        sys_.track(aid, frames[i], float(i))
        i += 1
    sys_.flush()
    assert int(sys_.ms.n_kf) >= n_kf + 2
    sys_.shutdown()


@pytest.mark.parametrize("refused,n_in,expect", [
    (5, 50, False),      # 5 refusals: no forced insertion
    (6, 50, True),       # c1d: more than 5, and the frame is weak
    (6, 95, False)])     # not weak: no forced insertion
def test_refusals_force_insertion_c1d(refused, n_in, expect):
    """frames_since_kf below kf_min_interval, so only c1d can ask."""
    sys_ = _system(async_mapping=False)
    a = sys_.agents[sys_.add_agent()]
    a.state, a.frames_since_kf, a.ref_kf_tracked = tsys.OK, 1, 100
    a.kf_insertions_refused = refused
    assert sys_._need_new_keyframe(a, n_in) is expect


def test_worker_error_surfaces_at_track_and_flush():
    sys_ = _system()
    aid = sys_.add_agent()
    frame = _frames(1)[0]

    def fail(a, kf):
        raise RuntimeError(f"mapping job of keyframe {kf} failed")

    sys_._local_mapping = fail
    for surface in ("track", "flush"):
        sys_._pending_mapping += 1
        sys_._jobs.put(("mapping", aid, 7))
        sys_._jobs.join()
        with pytest.raises(RuntimeError, match="keyframe 7 failed"):
            if surface == "track":
                sys_.track(aid, frame, 0.0)
            else:
                sys_.flush()
        assert sys_._pending_mapping == 0
    sys_.flush()          # raised once: nothing left to raise
    sys_.shutdown()
    assert not sys_._worker.is_alive()


def test_jacobians_from_several_threads():
    x = torch.linspace(0.1, 1.0, 7, dtype=torch.float64)

    def f(v):
        return torch.sin(v) * v.sum()

    want = autodiff.jacfwd(f, x)
    errors, results = [], []

    def work():
        try:
            for _ in range(50):
                results.append(autodiff.jacfwd(f, x))
        except RuntimeError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(results) == 400
    assert all(torch.equal(J, want) for J in results)


def test_async_plus_pipelined_ate():
    poses = make_trajectory(60)
    world = SyntheticWorld(seed=0)
    frames = [_port(world.render(R, t)[0]) for R, t in poses]
    sys_ = _system()
    sys_.pipeline = True
    sys_.pipeline_depth = 4
    aid = sys_.add_agent()
    for i, frame in enumerate(frames):
        sys_.track(aid, frame, float(i))
        if i % 5 == 4:
            sys_.flush()
    sys_.shutdown()
    assert not sys_._worker.is_alive()
    assert sys_.agents[aid].state == tsys.OK
    assert int(sys_.ms.kf_valid.sum()) >= 3
    est, gt = [], []
    for ts, _, t_wc, st in sys_.trajectory_world(aid):
        if st == tsys.OK:
            R, t = poses[int(ts)]
            gt.append(-R.T @ t)
            est.append(t_wc)
    est, gt = np.array(est), np.array(gt)
    assert len(est) > 40
    ate = np.sqrt(((umeyama_align(est, gt) - gt) ** 2).sum(-1).mean())
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert ate / span < 0.03, f"ATE {ate:.4f} over span {span:.3f}"
