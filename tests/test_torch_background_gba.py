"""The background global BA (``slam/background_gba.py``) and the server's
``async_gba`` hooks held to the reference, after tests/test_background_gba.py:
both packages' ``SlamSystem`` track the same 46 frames of
SyntheticWorld(seed=0) (the port with the reference's RANSAC draws), a
background GBA starts on that state, both track the same 24 further
frames (keyframes are born meanwhile), then the GBA finishes.

* ``finish``: both apply, the same keyframe slots are corrected or caught
  up, and ``kf_q``, ``kf_t`` and ``mp_pos`` agree at the dense-BA
  tolerances (rotation 1e-3 rad, translation 1e-3 of the scale, points
  rtol 1e-3); in the port the snapshot's keyframes hold exactly the
  synchronous ``global_ba`` of the snapshot and the keyframes born during
  the GBA keep their pose relative to their parent;
* ``abort`` leaves the state as it was;
* the server with ``async_gba``: a GBA started by ``_run_gba`` is
  harvested by the next keyframe's server epoch ("GBA applied"), a
  trigger aborts one in flight ("GBA aborted"), ``flush`` applies the
  last; the same ``gba_runs``, events and states in both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from mam3slam_tpu.geometry import cameras as jcameras
from mam3slam_tpu.slam import server as jserver
from mam3slam_tpu.slam import system as jsys
from mam3slam_tpu.slam.background_gba import BackgroundGBA as JBackgroundGBA

from mam3slam_tpu_torch.geometry import cameras, lie
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.slam.background_gba import BackgroundGBA
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)
from test_torch_capacity import _port, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401
from test_torch_slam import _ang

CFG = dict(width=W, height=H, n_feat=N_FEAT, max_kf=64, max_mp=4096,
           n_levels=4, kf_max_interval=12, min_init_matches=60)
SRV = dict(min_kfs_in_map=4, vocab_k=8, vocab_depth=3, async_gba=True)
N_SNAP = 46


@pytest.fixture(scope="module")
def frames():
    world = SyntheticWorld(seed=0)
    before = [world.render(R, t)[0] for R, t in make_trajectory(N_SNAP)]
    world = SyntheticWorld(seed=0)      # fresh noise, same landmarks
    after = [world.render(R, t)[0] for R, t in make_trajectory(70)[N_SNAP:]]
    return before, after


def _system(pkg):
    if pkg == "port":
        sys_ = tsys.SlamSystem(tsys.SlamConfig(**CFG), cameras.make_pinhole(
            FX, FY, CX, CY, device="cpu"))
        reference_draws(sys_, 0)
    else:
        sys_ = jsys.SlamSystem(jsys.SlamConfig(**CFG),
                               jcameras.make_pinhole(FX, FY, CX, CY))
    sys_.add_agent()
    return sys_


def _track(sys_, pkg, frames, t0):
    for i, frame in enumerate(frames):
        sys_.track(0, _port(frame) if pkg == "port" else frame,
                   float(t0 + i))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _poses(sys_):
    return {k: _np(getattr(sys_.ms, k)).copy() for k in
            ("kf_q", "kf_t", "mp_pos", "kf_valid", "kf_seq", "kf_parent",
             "mp_valid")}


@pytest.fixture(scope="module")
def gba_runs(frames):
    """Per package: the snapshot, the states just before and after
    ``finish``, and the synchronous GBA of the snapshot."""
    before, after = frames
    out = {}
    for pkg in ("ref", "port"):
        sys_ = _system(pkg)
        _track(sys_, pkg, before, 0)
        assert sys_.agents[0].state == tsys.OK
        map_id = sys_.agents[0].map_id
        snap = _poses(sys_)
        snap["n_kf"] = int(_np(sys_.ms.n_kf))
        gba = (BackgroundGBA(sys_) if pkg == "port"
               else JBackgroundGBA(sys_))
        sync = (sys_.fns["global_ba"](sys_.ms, map_id) if pkg == "port"
                else sys_.fns["global_ba"](sys_.ms, jnp.asarray(map_id)))
        gba.start(map_id)
        _track(sys_, pkg, after, N_SNAP)
        pre = _poses(sys_)
        assert gba.running and gba.ready
        applied = gba.finish()
        out[pkg] = dict(sys=sys_, gba=gba, snap=snap, pre=pre,
                        post=_poses(sys_), applied=applied,
                        sync_q=_np(sync.kf_q), sync_t=_np(sync.kf_t))
    return out


def _moved(r):
    """Keyframe slots whose pose ``finish`` changed."""
    dq = np.abs(r["post"]["kf_q"] - r["pre"]["kf_q"]).max(1)
    dt = np.abs(r["post"]["kf_t"] - r["pre"]["kf_t"]).max(1)
    return sorted(np.where(r["pre"]["kf_valid"] & ((dq > 0) | (dt > 0)))[0]
                  .tolist())


def test_finish_matches_reference(gba_runs):
    port, ref = gba_runs["port"], gba_runs["ref"]
    assert port["applied"] and ref["applied"]
    kv = ref["post"]["kf_valid"]
    np.testing.assert_array_equal(port["post"]["kf_valid"], kv)
    np.testing.assert_array_equal(port["post"]["kf_seq"], ref["post"]["kf_seq"])
    born = kv & (ref["post"]["kf_seq"] >= ref["snap"]["n_kf"])
    assert born.sum() >= 1
    # the same slots corrected or caught up
    assert _moved(port) == _moved(ref) and len(_moved(ref)) >= 3
    assert _ang(port["post"]["kf_q"][kv], ref["post"]["kf_q"][kv]).max() \
        < 1e-3
    t_ref = ref["post"]["kf_t"][kv]
    np.testing.assert_allclose(port["post"]["kf_t"][kv], t_ref,
                               atol=1e-3 * np.abs(t_ref).max())
    pv = ref["post"]["mp_valid"] & port["post"]["mp_valid"]
    assert pv.sum() >= 0.99 * ref["post"]["mp_valid"].sum()
    p_ref = ref["post"]["mp_pos"][pv]
    np.testing.assert_allclose(port["post"]["mp_pos"][pv], p_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(p_ref).max())


def test_port_finish_is_the_sync_gba_plus_catch_up(gba_runs):
    """tests/test_background_gba.py's checks on the port alone."""
    r = gba_runs["port"]
    post, pre, snap = r["post"], r["pre"], r["snap"]
    kv = post["kf_valid"]
    snap_live = kv & (post["kf_seq"] == snap["kf_seq"]) & (
        post["kf_seq"] < snap["n_kf"])
    anchor = int(np.argmin(np.where(snap_live, snap["kf_seq"], 1 << 30)))
    checked = [k for k in np.where(snap_live)[0] if k != anchor]
    assert len(checked) >= 3
    np.testing.assert_allclose(post["kf_q"][checked], r["sync_q"][checked],
                               atol=1e-6)
    np.testing.assert_allclose(post["kf_t"][checked], r["sync_t"][checked],
                               atol=1e-6)

    def rel(d, k, p):
        T = lie.se3_compose(
            lie.SE3(torch.tensor(d["kf_q"][k]), torch.tensor(d["kf_t"][k])),
            lie.se3_inverse(lie.SE3(torch.tensor(d["kf_q"][p]),
                                    torch.tensor(d["kf_t"][p]))))
        return T.q.numpy(), T.t.numpy()

    caught = 0
    for k in np.where(kv & (post["kf_seq"] >= snap["n_kf"]))[0]:
        p = post["kf_parent"][k]
        if p < 0 or not kv[p]:
            continue
        (q0, t0), (q1, t1) = rel(pre, k, p), rel(post, k, p)
        if np.dot(q0, q1) < 0:
            q1 = -q1
        np.testing.assert_allclose(q1, q0, atol=1e-5)
        np.testing.assert_allclose(t1, t0, atol=1e-4)
        caught += 1
    assert caught >= 1


def test_abort_is_noop(gba_runs):
    sys_, gba = gba_runs["port"]["sys"], gba_runs["port"]["gba"]
    before = [t.clone() for t in sys_.ms]
    gba.start(sys_.agents[0].map_id)
    gba.abort()
    assert not gba.running and not gba.ready
    for a, b in zip(sys_.ms, before):
        assert torch.equal(a, b)


def _server_run(pkg, before, after):
    """GBA started through the server, harvested at the next keyframe;
    another started, aborted by a trigger (its correction left out);
    a third applied by ``flush``."""
    sys_ = _system(pkg)
    _track(sys_, pkg, before, 0)
    if pkg == "port":
        srv = tserver.LoopServer(sys_, tserver.ServerConfig(**SRV))
        reference_draws(srv, 1234)
        hyp = tserver.Hypothesis
    else:
        srv = jserver.LoopServer(sys_, jserver.ServerConfig(**SRV))
        hyp = jserver.Hypothesis
    sys_.server = srv
    map_id = sys_.agents[0].map_id
    srv._run_gba(map_id)
    assert srv.gba.running
    _track(sys_, pkg, after[:12], N_SNAP)
    harvested = list(srv.events)
    srv._run_gba(map_id)
    srv.correct_loop = lambda *args: None
    kf = sys_.agents[0].ref_kf
    srv.hyp[0] = hyp(target_kf=kf, n_coincidences=3, last_kf=kf)
    srv._trigger(0, kf, srv.hyp[0])
    srv._run_gba(map_id)
    sys_.flush()
    return dict(sys=sys_, harvested=harvested, events=list(srv.events),
                gba_runs=list(srv.gba_runs), post=_poses(sys_))


def test_server_async_gba_matches_reference(frames):
    port, ref = (_server_run(pkg, *frames) for pkg in ("port", "ref"))
    assert ref["harvested"] == ["GBA applied"]
    assert ref["events"] == ["GBA applied", "GBA aborted", "GBA applied"]
    assert port["harvested"] == ref["harvested"]
    assert port["events"] == ref["events"]
    assert port["gba_runs"] == ref["gba_runs"] == [0, 0, 0]
    kv = ref["post"]["kf_valid"]
    np.testing.assert_array_equal(port["post"]["kf_valid"], kv)
    assert _ang(port["post"]["kf_q"][kv], ref["post"]["kf_q"][kv]).max() \
        < 1e-3
    t_ref = ref["post"]["kf_t"][kv]
    np.testing.assert_allclose(port["post"]["kf_t"][kv], t_ref,
                               atol=1e-3 * np.abs(t_ref).max())
