"""Mono-inertial tracking (``SlamSystem.track(..., imu=)``) held to the
reference on tests/test_inertial_tracking.py's scene: SyntheticWorld(n_mp
=900, seed=4), a gentle arc then a 6-frame yaw burst of 7 deg a frame at
frame 45, perfect IMU windows of 10 samples a frame at 20 Hz.  The port
takes the reference's RANSAC draws (``test_torch_capacity
.reference_draws``).

Both packages run the IMU run on the same frames and windows: the state
every ``track`` returns, ``n_fallback``, the events (``mps=`` within 1% of
the live points) with ``IMU_INIT`` at the same frame and the trajectory
rows (reference keyframes and states exact, poses within 1e-3 rad and
1e-3 of the translation scale) agree.  The initialisation is
ill-conditioned in f32 (information entries of 1e8 and more): the
reference's own scale moves 0.55% between its buffer and the port's,
whose poses differ by 1e-4, so the scale of the two runs is held within
1e-2 relative and the gravity within 0.05 deg, and the reference's
initialisation run on the port's own buffer is held to the port's
estimate within 1e-3 (scale, relative), 0.05 deg (gravity), 1e-4
(biases) and 1e-3 (velocity, relative).  A lost frame clears the IMU
buffer.  The reference test's gates and the pipelined run are in
test_torch_inertial_burst.py."""

import numpy as np
import pytest
import torch

from mam3slam_tpu.geometry import cameras as jcameras
from mam3slam_tpu.slam import system as jsys
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.slam import system as tsys
from test_inertial_tracking import burst_trajectory, synth_imu
from test_slam_e2e import CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld
from test_torch_capacity import _port, assert_events_match, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
from test_torch_slam import _ang

FPS = 20.0
CFG = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=6144,
           n_levels=4, min_init_matches=60, kf_max_interval=10)


def _system(pkg: str, depth: int = 0):
    if pkg == "port":
        sys_ = tsys.SlamSystem(tsys.SlamConfig(**CFG), cameras.make_pinhole(
            FX, FY, CX, CY, device="cpu"))
        reference_draws(sys_, 0)
    else:
        sys_ = jsys.SlamSystem(jsys.SlamConfig(**CFG),
                               jcameras.make_pinhole(FX, FY, CX, CY))
    sys_.pipeline = depth > 0
    sys_.pipeline_depth = max(depth, 1)
    return sys_


def _run(pkg: str, frames, imus, depth: int = 0,
         depth_after_init: int = 0) -> dict:
    """One run; ``depth_after_init`` (> 0) pipelines the system to that
    depth once the inertial initialisation has run."""
    sys_ = _system(pkg, depth)
    aid = sys_.add_agent()
    states, init = [], {}
    buffer_and_init = sys_._imu_buffer_and_init

    def capture(a, ts, imu):
        """Keep the buffer the initialisation ran on and its estimate."""
        before = a.imu_initialized
        buf = list(a.imu_buf) + [(ts, np.array(a.q), np.array(a.t))
                                 + tuple(np.asarray(x) for x in imu)]
        buffer_and_init(a, ts, imu)
        if a.imu_initialized and not before:
            init.update(buf=buf, frame=round(ts * FPS),
                        **{k: np.array(getattr(a, k)) for k in (
                "imu_scale", "gravity_w", "bias_g", "bias_a", "vel_w")})

    sys_._imu_buffer_and_init = capture
    for i, (frame, imu) in enumerate(zip(frames, imus)):
        if pkg == "port":
            frame = _port(frame)
        states.append(int(sys_.track(aid, frame, i / FPS, imu=imu)[0]))
        if depth_after_init and init:
            sys_.pipeline, sys_.pipeline_depth = True, depth_after_init
    if pkg == "port":
        sys_.flush()
    else:
        sys_.drain()
    a = sys_.agents[aid]
    ms = sys_.ms
    return dict(
        sys=sys_, aid=aid, states=states, events=list(sys_.events),
        init_frame=init.get("frame"), init=init,
        n_fallback=a.n_fallback, scale=a.imu_scale,
        gravity=None if a.gravity_w is None else np.asarray(a.gravity_w),
        n_mp=int(np.asarray(ms.mp_valid).sum()),
        rows=[(ts, int(ref), np.asarray(q), np.asarray(t), int(st))
              for ts, ref, q, t, st in a.trajectory])


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(n_mp=900, seed=4)
    poses = burst_trajectory()
    frames = [world.render(R, t)[0] for R, t, _ in poses]
    imus = [None] + [synth_imu(poses, i) for i in range(1, len(poses))]
    return dict(frames=frames, imus=imus, ref=_run("ref", frames, imus),
                port=_run("port", frames, imus))


def _strip_scale(events):
    return [" ".join(x for x in e.split() if not x.startswith("scale="))
            for e in events]


def assert_rows_match(got, ref, init_ts=None, after=3e-3):
    """Reference keyframes and states exact; rotations within 1e-3 rad,
    translations within 1e-3 of their scale, ``after`` of it from the
    inertial initialisation at ``init_ts`` on (the predictions then
    carry the initialisation's f32 conditioning; the port reaches
    1.2e-3 there)."""
    assert [r[:2] + r[4:] for r in got] == [r[:2] + r[4:] for r in ref]
    q_ref = np.asarray([r[2] for r in ref])
    t_ref = np.asarray([r[3] for r in ref])
    assert _ang(np.asarray([r[2] for r in got]), q_ref).max() < 1e-3
    ts = np.asarray([r[0] for r in ref])
    late = (ts >= init_ts if init_ts is not None
            else np.zeros(len(ts), bool))[:, None]
    err = np.abs(np.asarray([r[3] for r in got]) - t_ref)
    scale = np.abs(t_ref).max()
    assert (err <= np.where(late, after, 1e-3) * scale).all(), err.max()


def _gravity_deg(a, b):
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def assert_estimates_match(got, ref, scale_rtol):
    assert got["init_frame"] == ref["init_frame"] is not None
    assert abs(got["scale"] / ref["scale"] - 1) < scale_rtol
    assert _gravity_deg(got["gravity"], ref["gravity"]) < 0.05


def test_imu_run_matches_reference(runs):
    port, ref = runs["port"], runs["ref"]
    assert port["states"] == ref["states"]
    assert port["n_fallback"] == ref["n_fallback"]
    assert_events_match(_strip_scale(port["events"]),
                        _strip_scale(ref["events"]), 0.01 * ref["n_mp"])
    assert_estimates_match(port, ref, 1e-2)
    # the initialisation lands at the burst's first frame, so the rest
    # of the burst is IMU-predicted
    assert port["init_frame"] <= 45
    assert_rows_match(port["rows"], ref["rows"], ref["init_frame"] / FPS)


def test_reference_init_on_port_buffer_matches_port(runs):
    """The reference's ``_imu_buffer_and_init`` on the buffer the port's
    initialisation ran on gives the port's estimate."""
    est = runs["port"]["init"]
    buf = est["buf"]
    assert len(buf) >= 8
    jsys_ = _system("ref")
    a = jsys_.agents[jsys_.add_agent()]
    a.imu_buf = buf[:-1]
    a.q, a.t = buf[-1][1], buf[-1][2]
    jsys_._imu_buffer_and_init(a, buf[-1][0], buf[-1][3:])
    assert a.imu_initialized and jsys_.events[-1].startswith("IMU_INIT")
    assert abs(float(est["imu_scale"]) / a.imu_scale - 1) < 1e-3
    assert _gravity_deg(est["gravity_w"], np.asarray(a.gravity_w)) < 0.05
    np.testing.assert_allclose(est["bias_g"], a.bias_g, rtol=0, atol=1e-4)
    np.testing.assert_allclose(est["bias_a"], a.bias_a, rtol=0, atol=1e-4)
    v_ref = np.asarray(a.vel_w)
    np.testing.assert_allclose(est["vel_w"], v_ref, rtol=0,
                               atol=1e-3 * np.abs(v_ref).max())


def test_lost_frame_clears_imu_buffer(runs):
    """A frame that tracks nothing breaks the chain of tracked poses:
    the agent is RECENTLY_LOST and its IMU buffer is emptied."""
    port = runs["port"]
    sys_, aid = port["sys"], port["aid"]
    a = sys_.agents[aid]
    assert a.state == tsys.OK and len(a.imu_buf) > 0
    blank = _port(runs["frames"][-1])._replace(
        valid=torch.zeros(N_FEAT, dtype=torch.bool))
    state, _ = sys_.track(aid, blank, len(runs["frames"]) / FPS,
                          imu=runs["imus"][-1])
    assert state == tsys.RECENTLY_LOST
    assert a.imu_buf == []
