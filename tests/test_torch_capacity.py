"""Port twins of tests/test_capacity.py, each held to the reference on the
same inputs: both packages' ``SlamSystem`` (the port's on CPU tensors)
take the same frames, and the port takes the reference's RANSAC draws
(``reference_draws``), since the two packages' generators differ.

* atlas map slots recycle after merges; exhaustion raises MapCapacityError
* keyframe arena exhaustion raises MapCapacityError before corruption
* a tiny arena run stays bounded with unique keyframe identities
* keyframe slots freed by culling are recycled (kf_seq keeps identity)
* map-point arena overflow drops triangulations and counts them

The runs must agree with the reference on every frame's tracking state,
the events, the culled keyframe slots and the surviving keyframe
identities, with the counts of map points (live, dropped, and each
event's ``mps=``) within 1% of the reference's live points: a point at
the edge of a triangulation gate can fall the other way in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_capacity as ref_capacity
from mam3slam_tpu.mapstate import state as JS
from mam3slam_tpu.slam import system as jsystem
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam.system import (MapCapacityError, SlamConfig,
                                            SlamSystem)
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

CAPACITY_ERRORS = (MapCapacityError, jsystem.MapCapacityError)


def reference_draws(obj, seed: int) -> None:
    """Give a port ``SlamSystem`` or ``LoopServer`` the RANSAC draws of
    its reference counterpart built with ``seed``: the reference splits
    its ``jax.random`` key once per draw and draws uniforms from the
    subkey.  The port draws from one generator per agent (its ``_probe``
    takes the agent); the reference's one key serves every agent, so the
    agent is ignored here and every draw comes from that one sequence."""
    key = [jax.random.PRNGKey(seed)]

    def probe(shape, agent_id=None):
        key[0], sub = jax.random.split(key[0])
        return torch.tensor(np.asarray(jax.random.uniform(sub, tuple(shape))),
                            device=obj.device)

    obj._probe = probe


def _port(frame) -> tsteps.FrameObs:
    return tsteps.FrameObs(*(torch.from_numpy(np.array(getattr(frame, k)))
                             for k in tsteps.FrameObs._fields))


def small_system(max_kf=8, max_mp=512, max_maps=None, **kw):
    cam = cameras.make_pinhole(FX, FY, CX, CY, device="cpu")
    cfg = SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=max_kf,
                     max_mp=max_mp, n_levels=4, min_init_matches=60, **kw)
    sys_ = SlamSystem(cfg, cam)
    reference_draws(sys_, 0)
    if max_maps is not None:
        sys_.ms = sys_.ms._replace(
            map_valid=torch.zeros(max_maps, dtype=torch.bool),
            map_change=torch.zeros(max_maps, dtype=torch.int32))
    return sys_


def both(**kw):
    """(port, reference) systems of one small configuration."""
    return small_system(**kw), ref_capacity.small_system(**kw)


def _outcome(fn) -> str:
    try:
        fn()
    except CAPACITY_ERRORS as e:
        return f"raised: {e}"
    return "ok"


def _set_kf_valid(sys_, slot, value):
    if isinstance(sys_, SlamSystem):
        sys_.ms.kf_valid[slot] = value
    else:
        sys_.ms = sys_.ms._replace(kf_valid=sys_.ms.kf_valid.at[slot].set(
            value))


def _set_map_valid(sys_, slot, value):
    if isinstance(sys_, SlamSystem):
        sys_.ms.map_valid[slot] = value
    else:
        sys_.ms = sys_.ms._replace(
            map_valid=sys_.ms.map_valid.at[slot].set(value))


def test_map_id_allocator_exhausts_loudly():
    runs = []
    for sys_ in both(max_maps=3):
        ids = [sys_.add_agent() for _ in range(3)]
        runs.append((ids, [a.map_id for a in sys_.agents],
                     _outcome(sys_.add_agent), list(sys_.events)))
    assert runs[0] == runs[1]
    assert runs[0][:2] == ([0, 1, 2], [0, 1, 2])
    assert runs[0][2].startswith("raised")


def test_map_id_allocator_recycles_freed_slots():
    runs = []
    for sys_ in both(max_maps=4):
        aid = sys_.add_agent()  # map 0
        # the agent abandons map 0 (it stays valid in the atlas) for map 1
        _set_map_valid(sys_, 0, True)
        sys_._create_map_in_atlas(sys_.agents[aid])
        first = sys_.agents[aid].map_id
        # map 1 never initialised; a merge frees map 0
        _set_map_valid(sys_, 0, False)
        sys_._create_map_in_atlas(sys_.agents[aid])
        runs.append((first, sys_.agents[aid].map_id, list(sys_.events)))
    assert runs[0] == runs[1]
    assert runs[0][:2] == (1, 0)                      # recycled
    assert runs[0][2][-1] == "NEWMAP agent=0 map=0"


def test_kf_arena_exhaustion_raises():
    runs = []
    for sys_ in both(max_kf=8):
        sys_.add_agent()
        for k in range(8):
            _set_kf_valid(sys_, k, True)
        out = [_outcome(lambda: sys_._kf_capacity_check(1))]
        # one slot free, but initialisation needs two
        _set_kf_valid(sys_, 3, False)
        out += [_outcome(lambda: sys_._kf_capacity_check(n)) for n in (1, 2)]
        runs.append(out)
    assert runs[0] == runs[1]
    assert [o.split(":")[0] for o in runs[0]] == ["raised", "ok", "raised"]


def _drive(sys_, frames) -> dict:
    """Track ``frames`` with agent 0 until the end or a MapCapacityError;
    what the capacity tests compare."""
    aid = sys_.add_agent()
    states, raised = [], None
    for i, frame in enumerate(frames):
        if isinstance(sys_, SlamSystem):
            frame = _port(frame)
        try:
            states.append(int(sys_.track(aid, frame, float(i))[0]))
        except CAPACITY_ERRORS as e:
            raised = (i, str(e))
            break
    ms = sys_.ms
    valid = np.asarray(ms.kf_valid)
    return dict(states=states, raised=raised, events=list(sys_.events),
                culled=sorted(sys_.culled_kf), mp_dropped=sys_.mp_dropped,
                kf_seq=sorted(np.asarray(ms.kf_seq)[valid].tolist()),
                n_mp=int(np.asarray(ms.mp_valid).sum()))


def assert_events_match(got, ref, tol: float) -> None:
    """The same events in order: each ``mps=`` count within ``tol``
    points of the reference's, every other token identical."""
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        assert len(g.split()) == len(r.split()), (g, r)
        for x, y in zip(g.split(), r.split()):
            if x.startswith("mps=") and y.startswith("mps="):
                assert abs(int(x[4:]) - int(y[4:])) <= tol, (g, r)
            else:
                assert x == y, (g, r)


def assert_runs_match(port: dict, ref: dict) -> None:
    """Two ``_drive`` results, as the module's docstring states."""
    tol = 0.01 * ref["n_mp"]
    for key in ("states", "raised", "culled", "kf_seq"):
        assert port[key] == ref[key], key
    for key in ("n_mp", "mp_dropped"):
        assert abs(port[key] - ref[key]) <= tol, (key, port[key], ref[key])
    assert_events_match(port["events"], ref["events"], tol)


def test_kf_arena_tiny_run_stays_bounded():
    """A tiny arena either stays within capacity (culling keeps up) or
    fails loudly: never a clobbered slot.  20 frames of the reference's
    60: with a keyframe every frame, culling reaches its steady state by
    frame 10."""
    world = SyntheticWorld(seed=0)
    frames = [world.render(R, t)[0] for R, t in make_trajectory(60)[:20]]
    port, ref = (_drive(s, frames) for s in both(
        max_kf=6, kf_max_interval=1, kf_min_interval=1))
    assert_runs_match(port, ref)
    assert port["raised"] is not None or port["culled"]
    assert len(port["kf_seq"]) <= 6
    assert len(port["kf_seq"]) == len(set(port["kf_seq"]))  # unique


def _recycle_slots(mod, arr, ms) -> dict:
    """Add keyframes at x = 0, 1, 2, remove slot 1, add one at x = 3."""
    F = 8

    def add(ms, x):
        return mod.add_keyframe(
            ms, arr(np.float32([1, 0, 0, 0])), arr(np.float32([x, 0, 0])),
            0, 0, 0.0, 0, arr(np.zeros((F, 2), np.float32)),
            arr(np.zeros(F, np.int32)), arr(np.zeros(F, np.float32)),
            arr(np.zeros((F, 32), np.uint8)), arr(np.zeros(F, bool)),
            arr(np.full(F, -1, np.int32)))

    slots = []
    for x in (0.0, 1.0, 2.0, None, 3.0):
        if x is None:
            ms = mod.remove_keyframe(ms, 1)
            continue
        ms, k = add(ms, x)
        slots.append(int(k))
    return dict(slots=slots, n_kf=int(ms.n_kf),
                kf_seq=np.asarray(ms.kf_seq).tolist(),
                kf_valid=np.asarray(ms.kf_valid).tolist(),
                kf_t=np.asarray(ms.kf_t).tolist())


def test_kf_slot_recycling_preserves_identity():
    cfg = S.MapConfig(max_kf=4, max_mp=64, n_feat=8, max_obs=4)
    port = _recycle_slots(S, torch.from_numpy,
                          S.init_map_state(cfg, device="cpu"))
    ref = _recycle_slots(JS, jnp.asarray, JS.init_map_state(cfg))
    assert port == ref
    assert port["slots"] == [0, 1, 2, 1]     # slot recycled
    assert port["kf_seq"][1] == 3            # but the identity is new
    assert port["n_kf"] == 4                 # insertion counter monotonic
    assert port["kf_t"][1][0] == 3.0
    seqs = [s for s, v in zip(port["kf_seq"], port["kf_valid"]) if v]
    assert sorted(seqs) == [0, 2, 3]


def test_mp_arena_overflow_drops_and_counts():
    world = SyntheticWorld(n_mp=1200, seed=1)
    frames = [world.render(R, t)[0] for R, t in make_trajectory(30)]
    port, ref = (_drive(s, frames) for s in both(max_kf=32, max_mp=192))
    assert_runs_match(port, ref)
    # the arena is never over-filled; the drops are counted and logged
    assert port["n_mp"] <= 192
    assert port["mp_dropped"] > 0
    assert any(e.startswith("MP_ARENA_FULL") for e in port["events"])
