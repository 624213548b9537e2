"""Port parity of ``LoopServer.correct_loop`` on the shared state of
test_torch_server.py (the port's map at the merge trigger of
tests/test_server_merge.py's world, carried into a JAX SlamSystem +
LoopServer): after the same loop hypothesis inside agent 0's map the
integer state must be identical and the poses agree within 1e-3 rad /
1e-3 x scale."""

import jax.numpy as jnp
import numpy as np
import pytest

from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.slam import server as tserver
from test_torch_server import _compare_after, _pair, merge_snapshot
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def snap():
    return merge_snapshot()


def test_correct_loop_matches_reference(snap):
    """A loop inside agent 0's map: its newest keyframe re-observes its
    oldest, with the hypothesis' Sim3 a perturbation of the current
    pose."""
    tsys_, jsys_ = _pair(snap)
    ms_np = convert.to_numpy(snap["ms"])
    m0 = snap["agents"][0].map_id
    in0 = np.where(ms_np.kf_valid & (ms_np.kf_map == m0))[0]
    seq = ms_np.kf_seq[in0]
    kf, tgt = int(in0[np.argmax(seq)]), int(in0[np.argmin(seq)])
    S = jlie.sim3_compose(
        jlie.sim3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.02, 0.005,
                                   0.03])),
        jlie.Sim3(jnp.asarray(ms_np.kf_q[kf]), jnp.asarray(ms_np.kf_t[kf]),
                  jnp.asarray(1.0)))
    fields = dict(target_kf=tgt, is_merge=False, n_coincidences=3,
                  q=np.asarray(S.q), t=np.asarray(S.t), s=float(S.s),
                  last_kf=kf)
    jsys_.server.correct_loop(0, kf, jserver.Hypothesis(**fields))
    tsys_.server.correct_loop(0, kf, tserver.Hypothesis(**fields))
    _compare_after(tsys_, jsys_)
    # two maps live: the loop takes no global BA in either package
    assert tsys_.server.gba_runs == jsys_.server.gba_runs == []
    assert tsys_.server.events == jsys_.server.events
    moved = np.abs(tsys_.ms.kf_t.numpy() - ms_np.kf_t)[in0].max()
    assert moved > 1e-3


def test_correct_loop_inertial_matches_reference(snap):
    """The same loop with agent 0 marked inertial in both packages, as a
    completed VI initialisation marks it (tests/test_server_loop.py:
    170-176, map-frame gravity -y): both take the 4DoF PGO and log
    ``pgo=4dof``; the integer state is identical and the poses agree
    within 1e-3 rad / 1e-3 x scale."""
    tsys_, jsys_ = _pair(snap)
    ms_np = convert.to_numpy(snap["ms"])
    m0 = snap["agents"][0].map_id
    ja = jsys_.agents[0]
    ja.imu_initialized, ja.imu_init_map = True, m0
    ja.gravity_w = np.array([0.0, -9.81, 0.0])
    ja.imu_buf = [(0.5, np.float32([1, 0, 0, 0]), np.zeros(3, np.float32),
                   np.zeros((10, 3)), np.ones((10, 3)), np.full(10, 5e-3))]
    convert.agent_imu_from_numpy(ja, tsys_.agents[0], device="cpu")
    ta = tsys_.agents[0]
    assert (ta.imu_initialized, ta.imu_init_map) == (True, m0)
    assert ta.gravity_w.dtype == np.float32 and ta.imu_calib is None
    assert ta.imu_buf[0][4].dtype == np.float32
    in0 = np.where(ms_np.kf_valid & (ms_np.kf_map == m0))[0]
    seq = ms_np.kf_seq[in0]
    kf, tgt = int(in0[np.argmax(seq)]), int(in0[np.argmin(seq)])
    S = jlie.sim3_compose(
        jlie.sim3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.0, 0.02, 0.0,
                                   0.0])),
        jlie.Sim3(jnp.asarray(ms_np.kf_q[kf]), jnp.asarray(ms_np.kf_t[kf]),
                  jnp.asarray(1.0)))
    fields = dict(target_kf=tgt, is_merge=False, n_coincidences=3,
                  q=np.asarray(S.q), t=np.asarray(S.t), s=float(S.s),
                  last_kf=kf)
    jsys_.server.correct_loop(0, kf, jserver.Hypothesis(**fields))
    tsys_.server.correct_loop(0, kf, tserver.Hypothesis(**fields))
    assert tsys_.server.events == jsys_.server.events
    assert tsys_.server.events[-1].endswith(" pgo=4dof")
    _compare_after(tsys_, jsys_)
    moved = np.abs(tsys_.ms.kf_t.numpy() - ms_np.kf_t)[in0].max()
    assert moved > 1e-3
