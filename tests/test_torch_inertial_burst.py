"""The reference test's gates of mono-inertial tracking
(tests/test_inertial_tracking.py:91-105) on the port, and its pipelined
IMU run: the port alone on test_torch_inertial.py's frames and IMU
windows, with IMU (synchronous, and pipelined to depth 4 from the
inertial initialisation on) and without (the constant-velocity run that
``fb_imu < fb_cv`` compares with).

An IMU-predicted frame first completes the agent's deferred frames, and
its prediction replaces the device chain's on the device, so once the
agent is inertial, pipelining to depth 4 changes nothing: that run's
states (one frame late), events, fallbacks, estimate, map and
trajectory rows equal the synchronous run's exactly.  (Before the
initialisation a depth-4 run lags its keyframe decisions and differs
from the synchronous run, as in the reference.)"""

import numpy as np
import pytest
import torch

from mam3slam_tpu_torch.slam import system as tsys
from test_inertial_tracking import burst_trajectory, synth_imu
from test_slam_e2e import SyntheticWorld
from test_torch_inertial import _run
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(n_mp=900, seed=4)
    poses = burst_trajectory()
    frames = [world.render(R, t)[0] for R, t, _ in poses]
    imus = [None] + [synth_imu(poses, i) for i in range(1, len(poses))]
    return dict(imu=_run("port", frames, imus),
                cv=_run("port", frames, [None] * len(frames)),
                d4=_run("port", frames, imus, depth_after_init=4))


def test_port_imu_prediction_survives_rotation_burst(runs):
    st_imu, fb_imu = runs["imu"]["states"], runs["imu"]["n_fallback"]
    fb_cv = runs["cv"]["n_fallback"]
    ok_imu = st_imu[45:60].count(tsys.OK)
    assert ok_imu >= 13, (ok_imu, st_imu)
    assert fb_imu < fb_cv, (fb_imu, fb_cv)
    assert fb_imu <= 1, fb_imu
    assert st_imu[10:45].count(tsys.OK) >= 33
    assert not any(e.startswith("IMU_INIT") for e in runs["cv"]["events"])


def test_pipelined_imu_run_equals_synchronous(runs):
    d4, d1 = runs["d4"], runs["imu"]
    k = d1["init_frame"] + 1
    assert d4["states"][:k] == d1["states"][:k]
    assert d4["states"][k + 1:] == d1["states"][k:-1]
    for key in ("events", "n_fallback", "init_frame", "scale"):
        assert d4[key] == d1[key], key
    np.testing.assert_array_equal(d4["gravity"], d1["gravity"])
    for f in tsys.S.MapState._fields:
        assert torch.equal(getattr(d4["sys"].ms, f),
                           getattr(d1["sys"].ms, f)), f
    assert len(d4["rows"]) == len(d1["rows"])
    for a, b in zip(d4["rows"], d1["rows"]):
        assert a[:2] + a[4:] == b[:2] + b[4:]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
