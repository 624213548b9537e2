"""Port parity of the loop server's candidate detection and
verification, on the shared state of test_torch_server.py: the port's
map at the merge trigger of tests/test_server_merge.py's world, carried
into a JAX SlamSystem + LoopServer.  The candidates and the funnel
counters of ``_verify_candidate`` (the port given the reference's RANSAC
draws) must be identical, the Sim3 within 1e-3."""

import jax
import numpy as np
import pytest

from test_torch_mapping import _T
from test_torch_server import _ang, _pair, merge_snapshot
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def snap():
    return merge_snapshot()


def test_detect_and_verify_match_reference(snap):
    tsys_, jsys_ = _pair(snap)
    kf = snap["kf"]
    tsrv, jsrv = tsys_.server, jsys_.server
    assert tsrv._detect_candidates(kf) == jsrv._detect_candidates(kf)
    cands = [c for cl in jsrv._detect_candidates(kf) for c in cl]
    cands.append(snap["h"].target_kf)
    n_passed = 0
    for cand in cands:
        sub = jax.random.split(jsrv.key)[1]
        tsrv._probe = lambda shape, agent_id: _T(
            jax.random.uniform(sub, shape))
        ref = jsrv._verify_candidate(kf, cand)
        got = tsrv._verify_candidate(kf, cand, 0)
        assert tsrv.last_verify == jsrv.last_verify
        assert (got is None) == (ref is None)
        if ref is not None:
            n_passed += 1
            assert _ang(got[0], ref[0]) < 1e-3
            np.testing.assert_allclose(got[1], ref[1], rtol=1e-3,
                                       atol=1e-3 * np.abs(ref[1]).max())
            assert abs(got[2] / ref[2] - 1) < 1e-3
    assert n_passed >= 1
