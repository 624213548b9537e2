"""Agents in rooms of their own stay apart: their draws and their maps.

One RANSAC generator per agent, in the port's ``SlamSystem`` (two-view
initialisation, relocalization) and ``LoopServer`` (Sim3 RANSAC, keyed by
the agent whose keyframe it processes):

* the seed rule: agent 0 draws what the system's one generator drew
  (``seed``; the server's ``seed + 1234``), so a one-agent mission is
  unchanged; agent k draws from ``agent_seed(seed, k)``;
* the tests' hook (``test_torch_capacity.reference_draws``) still hands
  a port object the reference's one ``jax.random`` sequence, whichever
  agent draws;
* at the benchmark's half-size ``tiny`` deployment, two agents in rooms
  of their own draw in company exactly the numbers each draws alone,
  and their mission (``slambench/tests/data/tiny2.json``, through
  ``harness.fly`` and ``check.run_check``) comes out correct with two
  maps and no MERGE.

One arena, separate maps: a batch of point replacements (the mapping
epoch's fuse) leaves no keyframe linked to a dead point, so no later
point, of this map or another agent's, inherits the link; after the
tiny2 mission no keyframe links a dead point or a point of another map.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import system as tsystem
from slambench import check, harness, traffic
from test_torch_capacity import reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "slambench", "tests", "data")
SEED = 2**31 + 23
SHAPES = ((200, 8), (128, 6), (200, 8), (128, 3))


def small_system(seed, n_agents):
    cam = cameras.make_pinhole(200.0, 200.0, 160.0, 120.0, device="cpu")
    sys_ = tsystem.SlamSystem(tsystem.SlamConfig(width=320, height=240,
                                                 max_kf=8, max_mp=256),
                              cam, seed=seed)
    for _ in range(n_agents):
        sys_.add_agent()
    return sys_


def bad_links(ms):
    """(links to a dead point, links to another map's point) of the live
    keyframes."""
    P = ms.mp_valid.shape[0]
    has = (ms.kf_feat_mp >= 0) & ms.kf_valid[:, None]
    idx = torch.clamp(ms.kf_feat_mp, 0, P - 1).long()
    dead = has & ~ms.mp_valid[idx]
    other = has & ms.mp_valid[idx] & (ms.mp_map[idx] != ms.kf_map[:, None])
    return int(dead.sum()), int(other.sum())


def one_generator(seed, shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(s, generator=gen) for s in shapes]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_agent_zero_draws_what_the_one_generator_drew(seed):
    sys_ = small_system(seed, 3)
    srv = tserver.LoopServer(sys_, seed=seed)
    for obj, base in ((sys_, seed), (srv, seed + 1234)):
        got = [obj._probe(s, 0) for s in SHAPES]
        assert all(torch.equal(a, b)
                   for a, b in zip(got, one_generator(base, SHAPES)))
        # the others draw from their own seeds, whatever agent 0 drew
        for k in (1, 2):
            want = one_generator(tsystem.agent_seed(base, k), SHAPES[:2])
            got = [obj._probe(s, k) for s in SHAPES[:2]]
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert not torch.equal(got[0], one_generator(base, SHAPES)[0])
    assert len({tsystem.agent_seed(seed, k) for k in range(64)}) == 64


def test_reference_draws_hand_every_agent_the_one_sequence():
    sys_ = small_system(0, 2)
    srv = tserver.LoopServer(sys_)
    for obj, seed in ((sys_, 0), (srv, 1234)):
        reference_draws(obj, seed)
        key = jax.random.PRNGKey(seed)
        for i, shape in enumerate(SHAPES):
            key, sub = jax.random.split(key)
            want = np.asarray(jax.random.uniform(sub, shape))
            np.testing.assert_array_equal(obj._probe(shape, i % 2).numpy(),
                                          want)


# -- one arena, separate maps ------------------------------------------

def linked_map():
    """Two keyframes of map 0 over points 0-7: keyframe 0 sees points
    0-7 on features 0-7, keyframe 1 points 1, 2, 4 and 5 on features
    0-3."""
    ms = S.init_map_state(S.MapConfig(max_kf=4, max_mp=16, n_feat=8,
                                      max_obs=4, max_maps=2), "cpu")
    fmp = ms.kf_feat_mp.clone()
    fmp[0] = torch.arange(8, dtype=torch.int32)
    fmp[1, :4] = torch.tensor([1, 2, 4, 5], dtype=torch.int32)
    ms = ms._replace(kf_valid=torch.tensor([True, True, False, False]),
                     kf_map=torch.zeros(4, dtype=torch.int32),
                     mp_valid=torch.arange(16) < 8,
                     mp_map=torch.zeros(16, dtype=torch.int32),
                     mp_found=torch.arange(16, dtype=torch.float32),
                     kf_feat_mp=fmp)
    return S.rebuild_reverse_obs(ms)


@pytest.mark.parametrize("pairs,killed", [
    ([(6, 7)], {6}),                          # no chain: as MapPoint::Replace
    ([(1, 2), (2, 3)], {2}),                  # a chain: 1 -> 2 waits
    ([(4, 5), (5, 4)], set()),                # a cycle: neither replaced
    ([(1, 2), (2, 3), (4, 5), (5, 4), (6, 7)], {2, 6})])
def test_replacements_leave_no_link_on_a_dead_point(pairs, killed):
    ms = linked_map()
    src = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
    dst = torch.tensor([b for _, b in pairs], dtype=torch.int32)
    out = S.replace_map_points(ms, src, dst, torch.ones(len(pairs),
                                                        dtype=torch.bool))
    assert set(np.nonzero(~out.mp_valid[:8].numpy())[0]) == killed
    assert bad_links(out) == (0, 0)
    # every link to a replaced point now names its survivor, the others
    # are untouched, and the survivor carries the replaced point's counts
    kept, want = dict(pairs), ms.kf_feat_mp.clone()
    for p in killed:
        want[ms.kf_feat_mp == p] = kept[p]
        assert out.mp_found[kept[p]] == ms.mp_found[kept[p]] + ms.mp_found[p]
    assert torch.equal(out.kf_feat_mp, want)


# -- the tiny deployment: two agents in rooms of their own ---------------

def tiny_cell():
    return harness.Cell(
        name="tiny.tiny2", workload={"chips": 1},
        config=harness.load_json(os.path.join(DATA, "tiny.json")),
        traffic=harness.load_json(os.path.join(DATA, "tiny2.json")),
        end_to_end=[], per_layer=[])


@pytest.fixture(scope="module")
def tiny2(tmp_path_factory):
    """The tiny2 mission in company, then each agent's frames alone (the
    other agent registered and never fed), with every draw recorded as
    (object, agent, values)."""
    cell = tiny_cell()
    agents = traffic.make_agents(cell.traffic, cell.config, SEED, "cpu")
    yaml_path = str(tmp_path_factory.mktemp("tiny2") / "settings.yaml")
    with open(yaml_path, "w") as f:
        f.write(harness.settings_yaml(cell.config["settings"]))
    draws = []
    mp = pytest.MonkeyPatch()
    for cls in (tsystem.SlamSystem, tserver.LoopServer):
        probe = cls._probe

        def recorded(self, shape, agent_id, probe=probe, cls=cls):
            out = probe(self, shape, agent_id)
            draws[-1].append((cls.__name__, agent_id, out.clone()))
            return out

        mp.setattr(cls, "_probe", recorded)
    try:
        draws.append([])
        mas, states, complete = harness.fly(cell, agents, yaml_path, "cpu",
                                            float("inf"), None, [], 0)
        links = bad_links(mas.sys.ms)
        record = harness.close(mas, states, complete)
        verdict = check.run_check(
            [record], agents, cell.config, cell.traffic, SEED,
            harness.orb_config(cell.config["settings"]),
            harness.ref_orb.OrbConfig(8, 8).scales)
        alone = []
        for k, ag in enumerate(agents):
            draws.append([])
            solo = harness.build_system(cell.config, yaml_path, len(agents),
                                        "cpu")
            for i in range(ag.n):
                solo.track_monocular(k, ag.frames[i], i / ag.fps)
            solo.shutdown()
            alone.append(draws[-1])
    finally:
        mp.undo()
    return dict(record=record, verdict=verdict, company=draws[0],
                alone=alone, links=links)


def test_each_agent_draws_in_company_what_it_draws_alone(tiny2):
    company = tiny2["company"]
    assert {a for _, a, _ in company} == {0, 1}     # both initialised
    for k, alone in enumerate(tiny2["alone"]):
        mine = [(c, v) for c, a, v in company if a == k]
        assert [c for c, _ in mine] == [c for c, a, _ in alone]
        assert all(a == k for _, a, _ in alone)
        assert all(torch.equal(v, w) for (_, v), (_, _, w)
                   in zip(mine, alone))


def test_two_agents_in_rooms_of_their_own_fly_a_correct_mission(tiny2):
    rec, v = tiny2["record"], tiny2["verdict"]
    assert rec.complete and rec.merges == 0 and rec.loops == 0
    assert len(set(rec.map_ids)) == 2
    assert v["correct"], (v["rows"], v["faults"])
    assert tiny2["links"] == (0, 0)
