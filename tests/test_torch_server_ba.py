"""Port parity of the loop server's welding BA and global BA on the
shared state of test_torch_server.py (the port's map at the merge
trigger of tests/test_server_merge.py's world, carried into a JAX
SlamSystem): the optimised keyframe and point masks must be identical,
the poses agree within 1e-3 rad / 1e-3 x scale."""

import jax.numpy as jnp
import numpy as np
import pytest

from mam3slam_tpu_torch import convert
from test_torch_mapping import _T
from test_torch_server import _assert_poses_match, _pair, merge_snapshot
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def snap():
    return merge_snapshot()


def test_welding_and_global_ba_match_reference(snap):
    tsys_, jsys_ = _pair(snap)
    kf = snap["kf"]
    ms_np = convert.to_numpy(snap["ms"])
    cur = ms_np.kf_valid & (ms_np.kf_map == ms_np.kf_map[kf])
    ref, r_mask, r_pts = jsys_.fns["welding_ba"](
        jsys_.ms, jnp.asarray(kf), jnp.asarray(cur))
    got, g_mask, g_pts = tsys_.fns["welding_ba"](tsys_.ms, kf, _T(cur))
    np.testing.assert_array_equal(g_mask.numpy(), np.asarray(r_mask))
    np.testing.assert_array_equal(g_pts.numpy(), np.asarray(r_pts))
    assert g_mask.sum() >= 2 and g_pts.sum() > 100
    _assert_poses_match(got, ref)

    map_id = int(ms_np.kf_map[kf])
    ref = jsys_.fns["global_ba"](jsys_.ms, jnp.asarray(map_id))
    got = tsys_.fns["global_ba"](tsys_.ms, map_id)
    _assert_poses_match(got, ref)
    moved = np.abs(np.asarray(ref.kf_t) - ms_np.kf_t).max()
    assert moved > 1e-5
