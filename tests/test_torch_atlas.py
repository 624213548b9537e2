"""Twin of tests/test_atlas.py:89 ``test_new_map_after_long_loss_then_merge``
(EuRoC V1_03-style, BASELINE config 3): both packages' ``SlamSystem`` +
``LoopServer`` (the port with the reference's RANSAC draws) fed the same
frames of SyntheticWorld(n_mp=1400, seed=5): an arc that maps a region,
ten empty frames (LOST, a NEWMAP in the atlas), then a disjoint arc that
initialises a new map and sweeps back over the first.  The two packages
log the same NEWMAP and MERGE (or relocalization into map 0) events with
the same map ids, and the port holds the reference test's gates.  As slow
as its reference."""

import re

import numpy as np
import pytest
import torch

from mam3slam_tpu.slam import system as jsys
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.slam import server as tserver
from mam3slam_tpu_torch.slam import steps as tsteps
from mam3slam_tpu_torch.slam import system as tsys
from test_atlas import build_system, empty_frame
from test_server_merge import arc_trajectory
from test_slam_e2e import CX, CY, FX, FY, N_FEAT, SyntheticWorld
from test_torch_capacity import _port, reference_draws
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401

pytestmark = pytest.mark.slow   # as tests/test_atlas.py


def _port_system(jsys_):
    sys_ = tsys.SlamSystem(tsys.SlamConfig(**{
        f: getattr(jsys_.cfg, f) for f in tsys.SlamConfig.__dataclass_fields__
    }), tcam.make_pinhole(FX, FY, CX, CY, device="cpu"))
    reference_draws(sys_, 0)
    aid = sys_.add_agent()
    srv = tserver.LoopServer(sys_, tserver.ServerConfig(
        min_kfs_in_map=4, vocab_k=8, vocab_depth=3))
    reference_draws(srv, 1234)
    sys_.server = srv
    return sys_, aid, srv


def _empty_port():
    z = torch.zeros
    return tsteps.FrameObs(uv=z(N_FEAT, 2), level=z(N_FEAT, dtype=torch.int32),
                           angle=z(N_FEAT), desc=z(N_FEAT, 32,
                                                   dtype=torch.uint8),
                           valid=z(N_FEAT, dtype=torch.bool))


def test_new_map_after_long_loss_then_merge_twin():
    world = SyntheticWorld(n_mp=1400, seed=5)
    jsys_, jaid, jsrv = build_system(reloc_window=6)
    tsys_, taid, tsrv = _port_system(jsys_)
    runs = dict(ref=(jsys_, jaid, jsrv, []), port=(tsys_, taid, tsrv, []))
    t_i = 0

    def feed(frame_pair):
        nonlocal t_i
        for key, f in zip(("ref", "port"), frame_pair):
            sys_, aid, _, states = runs[key]
            states.append(int(sys_.track(aid, f, float(t_i))[0]))
        t_i += 1

    for R, t in arc_trajectory(40, start_x=0.0):
        f, _ = world.render(R, t)
        feed((f, _port(f)))
    assert runs["port"][3][-1] == tsys.OK == jsys.OK
    for _ in range(10):
        feed((empty_frame(), _empty_port()))
    for key in runs:
        sys_, aid, _, states = runs[key]
        assert states[-1] in (tsys.LOST, tsys.NOT_INITIALIZED)
        assert sys_.agents[aid].map_id != 0
    for R, t in arc_trajectory(60, start_x=3.6, step=-0.05):
        f, _ = world.render(R, t)
        feed((f, _port(f)))

    def events(key):
        sys_, aid, srv, states = runs[key]
        kinds = ("NEWMAP", "INIT", "RELOC", "LOST")
        return ([re.sub(r" (ts|mps|kfs)=\S+", "", e) for e in sys_.events
                 if e.startswith(kinds)],
                [e.split(" kf=")[0] for e in srv.events],
                sys_.agents[aid].map_id, states)

    ref, got = events("ref"), events("port")
    assert got[0] == ref[0], (got[0], ref[0])       # NEWMAP / INIT / RELOC
    assert got[1] == ref[1], (got[1], ref[1])       # MERGE map a -> b
    assert got[2] == ref[2]
    assert np.mean(np.equal(got[3], ref[3])) > 0.95
    # the reference test's gates, on the port
    sys_, aid, srv, states = runs["port"]
    assert [e for e in sys_.events if e.startswith("NEWMAP")]
    assert tsys.OK in states[50:]
    merges = [e for e in srv.events if e.startswith("MERGE")]
    relocs = [e for e in sys_.events if e.startswith("RELOC")]
    assert merges or any("-> 0" in e for e in relocs), (srv.events,
                                                         sys_.events)
    if merges:
        kfm = sys_.ms.kf_map[sys_.ms.kf_valid].numpy()
        assert len(np.unique(kfm)) == 1
