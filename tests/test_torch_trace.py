"""The port's tracer (``mam3slam_tpu_torch/utils/timing.py``) on short
synthetic-world missions with the server on, and the benchmark's
reduction of its records against a device trace
(``slambench/program_trace.py``):

* off (the default): nothing is recorded, a span allocates nothing, and
  the operator's series (``LM_<agent>``, ``PR``, ``LC``,
  ``AgentState.times_ms``) count one value an event as before: one
  ``LM_0`` a mapping epoch, one ``PR`` a keyframe, one ``LC`` a LOOP;
* on: every call yields one ``frame`` root whose spans lie inside it and
  share its frame id, span names come from the documented set, the
  series are the durations of the spans that share their boundaries,
  the counters match the verified candidates and the spans the events
  (keyframes inserted, LOOP / MERGE corrections); a block that raises
  feeds no series, and ``take`` loses no span another thread records;
* under ``async_mapping`` the worker's ``mapping`` spans run under the
  inserting frame's ``track`` span with its frame id;
* every OptimizeSim3 call is one ``server.sim3_opt`` span, under
  ``server.verify`` or ``server.refine``, which
  ``server_sim3_opt_ms_per_call`` averages over the window;
* the facade's pinhole undistortion is a span ``extract.undistort`` under
  ``extract`` (none for KB8), and the counters ``verify_tried_merge`` /
  ``verify_passed_merge`` count the candidates of another map only;
  ``undistort_ms_p50`` and ``merge_verify_per_kf`` read them;
* the anchors put the spans on the device trace's clock: an idle gap
  inside a ``server.verify`` span is named by it, and a device op that
  starts inside ``mapping`` counts for it.
"""

import os
import re
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.io import writers
from mam3slam_tpu_torch.slam import system as tsys
from mam3slam_tpu_torch.slam.server import Hypothesis, LoopServer, ServerConfig
from mam3slam_tpu_torch.utils import timing
from mam3slam_tpu_torch.utils.timing import TRACER
from slambench import harness
from slambench import program_trace as pt
from test_server_merge import arc_trajectory
from test_slam_e2e import SyntheticWorld
from test_torch_async_mapping import _frames, _system
from test_torch_server_e2e import (port_frame, port_system,  # noqa: F401
                                   torch_threads_per_worker)


@pytest.fixture(autouse=True)
def tracer_left_off():
    """Every test starts and ends with the tracer off and empty."""
    TRACER.disable()
    TRACER.take()
    yield
    TRACER.disable()
    TRACER.take()


def count_insertions(sys_):
    """Wrap the system's keyframe insertion; returns the list of keyframe
    slots it created."""
    made = []
    sys_.fns = dict(sys_.fns)     # the programs are shared between systems
    add = sys_.fns["add_kf_step"]

    def counted(*args):
        ms, kf = add(*args)
        made.append(int(kf))
        return ms, kf

    sys_.fns["add_kf_step"] = counted
    return made


def close_loop(sys_, aid):
    """A LOOP through ``correct_loop`` between the agent's last and first
    keyframes, with the last one's own pose as the verified Sim3."""
    ms = sys_.ms
    kfs = [k for k in range(ms.kf_valid.shape[0])
           if bool(ms.kf_valid[k]) and int(ms.kf_map[k])
           == sys_.agents[aid].map_id]
    kf, target = kfs[-1], kfs[0]
    sys_.server.correct_loop(aid, kf, Hypothesis(
        target_kf=target, q=ms.kf_q[kf].numpy(), t=ms.kf_t[kf].numpy(),
        s=1.0, n_coincidences=3, last_kf=kf))


def events(sys_, kind):
    return [e for e in sys_.server.events if e.startswith(kind)]


# -- off --------------------------------------------------------------

def test_off_records_nothing_and_feeds_the_operators_series(tmp_path):
    sys_ = _system(async_mapping=False)
    sys_.server = LoopServer(sys_, ServerConfig(min_kfs_in_map=4, vocab_k=8,
                                                vocab_depth=3))
    made = count_insertions(sys_)
    aid = sys_.add_agent()
    frames = _frames(36)
    for i, frame in enumerate(frames):
        sys_.track(aid, frame, float(i))
    close_loop(sys_, aid)
    rec = TRACER.take()
    assert rec.spans == [] and rec.counts == []
    assert len(made) >= 2
    series, server = sys_.timers.series, sys_.server.timers.series
    assert len(series["LM_0"]) == len(sys_.epochs) == len(made)
    assert len(server["PR"]) == len(made)          # one a keyframe
    assert len(server["LC"]) == len(events(sys_, "LOOP")) == 1
    assert "MM" not in server and not events(sys_, "MERGE")
    assert len(sys_.agents[aid].times_ms) == len(frames)
    assert all(v > 0 for s in (series, server) for vs in s.values()
               for v in vs)
    # the shutdown artifacts: one line of milliseconds an event
    writers.save_all(sys_, sys_.server, str(tmp_path))
    lines = {name: (tmp_path / f"{name}.txt").read_text().splitlines()
             for name in ("TimesT_0", "TimesLM_0", "TimesPR", "TimesLC",
                          "TimesMM")}
    assert {k: len(v) for k, v in lines.items()} == dict(
        TimesT_0=len(frames), TimesLM_0=len(made), TimesPR=len(made),
        TimesLC=1, TimesMM=0)
    assert all(re.fullmatch(r"\d+\.\d{3}", x) for v in lines.values()
               for x in v)


def test_an_off_span_is_one_shared_object():
    assert TRACER.span("track") is TRACER.span("server.verify")
    assert TRACER.frame(0, 1) is TRACER.adopt((3, (0, 1))) is TRACER.span("x")
    assert TRACER.current() is None and TRACER.count("verify_tried") is None
    tracemalloc.start()
    try:
        with TRACER.span("x"):
            pass
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with TRACER.frame(0, 0), TRACER.span("track"):
                TRACER.count("verify_tried")
        grown = sum(d.size_diff for d in
                    tracemalloc.take_snapshot().compare_to(before, "lineno")
                    if d.traceback[0].filename == timing.__file__)
    finally:
        tracemalloc.stop()
    assert grown <= 0


# -- on: a two-agent merge, then a loop closed by hand -------------------

# the spans each span runs under in a synchronous system
PARENTS = {"extract": {"frame"}, "extract.undistort": {"extract"},
           "track": {"frame"},
           "track.init": {"track"}, "track.step": {"track"},
           "track.read": {"track", "track.step"},   # the two reads
           "track.ref_kf": {"track"},
           "track.reloc": {"track"}, "kf.insert": {"track"},
           "mapping": {"track"}, "server": {"track"},
           "mapping.epoch": {"mapping"}, "mapping.read": {"mapping"},
           "mapping.cull": {"mapping"},
           **{f"server.{n}": {"server"} for n in
              ("vocab", "index", "detect", "verify", "refine", "correct",
               "merge")},
           **{f"server.{n}": {"server.correct", "server.merge"} for n in
              ("pgo", "fuse", "gba")},
           "server.sim3_opt": {"server.verify", "server.refine"}}


@pytest.fixture(scope="module")
def merge_run():
    """tests/test_server_merge.py's mission (agent 0 maps x in [0, 2.2],
    agent 1 starts at 1.1 and merges into its map) traced, then one LOOP
    closed by hand outside any call."""
    TRACER.take()
    TRACER.enable()
    try:
        world = SyntheticWorld(n_mp=1200, seed=1)
        sys_ = port_system()
        made = count_insertions(sys_)
        a0, a1 = sys_.add_agent(), sys_.add_agent()
        calls = 0
        sim3_calls = _build.PLAIN_CALLS["sim3_opt"]
        for aid, x0, ts0 in ((a0, 0.0, 0.0), (a1, 1.1, 100.0)):
            for i, (R, t) in enumerate(arc_trajectory(50, start_x=x0)):
                sys_.track(aid, port_frame(world, R, t), ts0 + i)
                calls += 1
        sim3_calls = _build.PLAIN_CALLS["sim3_opt"] - sim3_calls
        mission = TRACER.take()
        close_loop(sys_, a0)
        loop = TRACER.take()
    finally:
        TRACER.disable()
    return dict(sys=sys_, made=made, calls=calls, mission=mission, loop=loop,
                sim3_calls=sim3_calls)


def test_every_call_is_one_frame_root_with_its_spans_inside(merge_run):
    spans = merge_run["mission"].spans
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert all(s.name == "frame" for s in roots)
    assert len(roots) == merge_run["calls"]
    assert sorted(r.frame for r in roots) == sorted(
        [(0, i) for i in range(50)] + [(1, i) for i in range(50)])
    assert {s.name for s in spans} <= set(timing.SPAN_NAMES)
    assert {"frame", "track", "track.step", "track.read", "kf.insert",
            "mapping", "mapping.epoch", "mapping.read", "mapping.cull",
            "server", "server.vocab", "server.index", "server.detect",
            "server.verify", "server.merge", "server.pgo", "server.fuse",
            "server.gba"} <= {s.name for s in spans}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)
        assert s.frame == p.frame
        assert p.name in PARENTS[s.name], (s.name, p.name)
    # each tracking step waits once inside (the coarse count) and once
    # after it (the packed vector)
    steps = {s.id for s in spans if s.name == "track.step"}
    reads = [s for s in spans if s.name == "track.read"]
    assert sorted(s.parent for s in reads if s.parent in steps) == sorted(
        steps)
    assert sum(s.parent not in steps for s in reads) == len(steps)


def test_the_operators_series_are_the_spans_durations(merge_run):
    sys_ = merge_run["sys"]
    spans = merge_run["mission"].spans + merge_run["loop"].spans

    def ms(name, agent=None):
        return [(s.t1_ns - s.t0_ns) / 1e6 for s in spans if s.name == name
                and (agent is None or s.frame[0] == agent)]

    assert sys_.timers.series["LM_0"] == ms("mapping", 0)
    assert sys_.timers.series["LM_1"] == ms("mapping", 1)
    srv = sys_.server.timers.series
    assert srv["PR"] == ms("server")
    assert srv["MM"] == ms("server.merge") and len(srv["MM"]) == 1
    assert srv["LC"] == ms("server.correct") and len(srv["LC"]) == 1
    loop = [s for s in merge_run["loop"].spans]
    assert {s.name for s in loop} == {"server.correct", "server.pgo",
                                      "server.fuse", "server.gba"}
    assert all(s.frame is None for s in loop)


def test_counters_match_the_events(merge_run):
    sys_ = merge_run["sys"]
    counts = merge_run["mission"].counts + merge_run["loop"].counts
    spans = merge_run["mission"].spans + merge_run["loop"].spans

    def total(name):
        return sum(c.amount for c in counts if c.name == name)

    def n(name):
        return sum(s.name == name for s in spans)

    assert {c.name for c in counts} <= set(timing.COUNTER_NAMES)
    assert n("kf.insert") == len(merge_run["made"]) == len(sys_.epochs)
    assert n("server.merge") == len(events(sys_, "MERGE")) == 1
    assert n("server.correct") == len(events(sys_, "LOOP")) == 1
    assert total("verify_tried") == n("server.verify") >= 1
    assert 1 <= total("verify_passed") <= total("verify_tried")
    # the MERGE followed candidates of the other map
    assert 1 <= total("verify_passed_merge") <= total("verify_tried_merge")
    assert total("verify_tried_merge") <= total("verify_tried")
    assert total("verify_passed_merge") <= total("verify_passed")
    # a count carries the frame id of the call it was made in
    frames = {s.frame for s in spans if s.name == "server.verify"}
    assert {c.frame for c in counts} == frames


def test_every_sim3_optimisation_is_one_span_under_verification(merge_run):
    spans = merge_run["mission"].spans
    by_id = {s.id: s for s in spans}
    opt = [s for s in spans if s.name == "server.sim3_opt"]
    assert {by_id[s.parent].name for s in opt} == {"server.verify",
                                                    "server.refine"}
    # on the CPU each call runs the plain version once
    assert len(opt) == merge_run["sim3_calls"] >= 2


def test_sim3_opt_reader_means_the_window_spans():
    from slambench.layers import server_sim3_opt_ms_per_call as reader

    TRACER.disable()                  # its import turned the tracer on
    ms, p0 = 1_000_000, 10**18 + 10**9

    def trace(*spans):
        t = type("Trace", (), {})()
        t.program = pt.Program(
            [pt.Span(i, name, 10**18 + a * ms, 10**18 + b * ms, None, None)
             for i, (name, a, b) in enumerate(spans)], [], p0)
        return t

    assert reader.read(trace(("server.verify", 0, 90),
                             ("server.sim3_opt", 10, 12),
                             ("server.refine", 100, 150),
                             ("server.sim3_opt", 110, 111),
                             ("server.sim3_opt", 1500, 1600)),  # profiled
                       None) == pytest.approx(1.5)
    assert reader.read(trace(("server.verify", 0, 90)), None) is None
    none = type("Trace", (), {"program": None})()
    assert reader.read(none, None) is None


@pytest.mark.parametrize("passing,want", [
    ("loop", dict(verify_tried=1, verify_passed=1)),
    ("merge", dict(verify_tried=2, verify_passed=1, verify_tried_merge=1,
                   verify_passed_merge=1)),
    (None, dict(verify_tried=2, verify_tried_merge=1))])
def test_merge_counters_count_the_other_maps_candidates(merge_run, passing,
                                                         want):
    """A keyframe given one planted loop candidate and one merge candidate
    (loop candidates are verified first; the first to pass ends the
    search): only the merge candidate counts as ``*_merge``."""
    sys_ = merge_run["sys"]
    srv = LoopServer(sys_, ServerConfig(min_kfs_in_map=1))
    kfs = [k for k in range(sys_.ms.kf_valid.shape[0])
           if bool(sys_.ms.kf_valid[k])]
    kf, loop_c, merge_c = kfs[-1], kfs[0], kfs[1]
    srv.voc = object()                    # trained: no bootstrap, no index
    srv.ensure_vocab = srv._index_keyframe = lambda *a: None
    srv._detect_candidates = lambda k: ([loop_c], [merge_c])
    kind = {loop_c: "loop", merge_c: "merge"}

    def verify(k, cand, agent_id):
        return ((np.array([1.0, 0, 0, 0]), np.zeros(3), 1.0)
                if kind[cand] == passing else None)

    srv._verify_candidate = verify
    TRACER.enable()
    with TRACER.frame(0, 0):
        srv.process_keyframe(0, kf)
    counts = {}
    for c in TRACER.take().counts:
        counts[c.name] = counts.get(c.name, 0) + c.amount
    assert counts == want
    assert (0 in srv.hyp) == (passing is not None)
    assert passing is None or srv.hyp[0].is_merge == (passing == "merge")


@pytest.mark.parametrize("camera", ["PinHole", "KannalaBrandt8"])
def test_undistortion_is_a_span_under_extract_for_a_pinhole_only(tmp_path,
                                                                 camera):
    config = harness.load_json(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "slambench", "tests", "data", "tiny.json"))
    st = config["settings"]
    if camera != "PinHole":
        st = dict(st, **{"Camera.type": camera, "Camera1.k3": 0.0,
                         "Camera1.k4": 0.0, "Camera.width": 240,
                         "Camera1.cx": 119.5, "Camera1.cy": 119.5})
    path = str(tmp_path / "settings.yaml")
    with open(path, "w") as f:
        f.write(harness.settings_yaml(st))
    mas = harness.build_system(config, path, 1, "cpu")
    gen = torch.Generator().manual_seed(5)
    TRACER.enable()
    for i in range(2):
        img = torch.randint(0, 256, (int(st["Camera.height"]),
                                     int(st["Camera.width"])),
                            generator=gen).to(torch.uint8)
        mas.track_monocular(0, img, i / 20)
    spans = TRACER.take().spans
    by_id = {s.id: s for s in spans}
    extract = [s for s in spans if s.name == "extract"]
    undistort = [s for s in spans if s.name == "extract.undistort"]
    assert len(extract) == 2
    if camera == "PinHole":
        assert sorted(s.parent for s in undistort) == sorted(
            s.id for s in extract)
        for s in undistort:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
            assert s.frame == p.frame
    else:
        assert undistort == []


def test_undistort_and_merge_verify_readers_read_the_window():
    from slambench.layers import merge_verify_per_kf, undistort_ms_p50

    TRACER.disable()                  # their import turned the tracer on
    ms, t0 = 1_000_000, 10**18
    p0 = t0 + 10**9                   # the profiled mission's start

    def trace(spans, counts=()):
        t = type("Trace", (), {})()
        t.program = pt.Program(
            [pt.Span(i, name, t0 + a * ms, t0 + b * ms, None, None)
             for i, (name, a, b) in enumerate(spans)],
            [pt.Count(name, n, None, t0 + at * ms)
             for name, n, at in counts], p0)
        return t

    full = trace([("extract.undistort", 0, 2), ("extract.undistort", 10, 19),
                  ("extract.undistort", 20, 24), ("server", 30, 40),
                  ("server", 50, 60), ("extract.undistort", 1100, 1190),
                  ("server", 1200, 1300)],             # the last two profiled
                 [("verify_tried_merge", 2, 35), ("verify_tried_merge", 1, 55),
                  ("verify_tried", 5, 56), ("verify_tried_merge", 4, 1250)])
    assert undistort_ms_p50.read(full, None) == pytest.approx(4.0)
    assert merge_verify_per_kf.read(full, None) == pytest.approx(1.5)
    # a server with no merge candidate reads 0; no keyframe, nothing
    assert merge_verify_per_kf.read(
        trace([("server", 30, 40)]), None) == 0.0
    for empty in (trace([]), trace([("extract", 0, 5)]),
                  type("Trace", (), {"program": None})()):
        assert undistort_ms_p50.read(empty, None) is None
        assert merge_verify_per_kf.read(empty, None) is None


def test_merge_verify_reader_reads_nothing_from_a_program_without_the_counter(
        monkeypatch):
    from slambench.layers import merge_verify_per_kf

    TRACER.disable()
    t = type("Trace", (), {})()
    t.program = pt.Program([pt.Span(0, "server", 0, 10, None, None)], [],
                           None)
    assert merge_verify_per_kf.read(t, None) == 0.0
    monkeypatch.setattr(timing, "COUNTER_NAMES",
                        ("verify_tried", "verify_passed"))
    assert merge_verify_per_kf.read(t, None) is None


def test_a_raising_block_feeds_no_series_and_take_loses_nothing():
    timers = timing.Timers()
    for on in (False, True):
        (TRACER.enable if on else TRACER.disable)()
        with pytest.raises(ValueError):
            with TRACER.timed("mapping", timers, "LM_0"):
                raise ValueError
        with TRACER.timed("mapping", timers, "LM_0"):
            pass
    assert len(timers.series["LM_0"]) == 2
    assert [s.name for s in TRACER.take().spans] == ["mapping", "mapping"]
    n, taken = 20000, []

    def record():
        for _ in range(n):
            with TRACER.span("server.verify"):
                TRACER.count("verify_tried")

    worker = threading.Thread(target=record)
    worker.start()
    while worker.is_alive():
        taken.append(TRACER.take())
    worker.join()
    taken.append(TRACER.take())
    assert sum(len(r.spans) for r in taken) == n
    assert sum(len(r.counts) for r in taken) == n


# -- on, under the mapping worker ---------------------------------------

def test_worker_spans_carry_the_inserting_frame_and_refusals_count():
    sys_ = _system(kf_max_interval=2, kf_min_interval=1)
    made = count_insertions(sys_)
    aid = sys_.add_agent()
    a = sys_.agents[aid]
    frames = _frames(30, seed=3)
    TRACER.enable()
    refused, i = 0, 0
    while a.state != tsys.OK:
        sys_.track(aid, frames[i], float(i))
        i += 1
    release = threading.Event()
    run = sys_._local_mapping

    def held(a_, kf):
        release.wait(timeout=120)
        return run(a_, kf)

    sys_._local_mapping = held
    while a.kf_insertions_refused <= 5:
        before = a.kf_insertions_refused
        sys_.track(aid, frames[i], float(i))
        refused += a.kf_insertions_refused > before
        i += 1
    release.set()
    sys_.flush()
    for j in range(i, i + 4):             # the next insertion resets c1d
        before = a.kf_insertions_refused
        sys_.track(aid, frames[j], float(j))
        refused += a.kf_insertions_refused > before
        sys_.flush()
    sys_.shutdown()
    rec = TRACER.take()
    assert refused == 6 and a.kf_insertions_refused == 0
    inserts = [s for s in rec.spans if s.name == "kf.insert"]
    assert len(inserts) == len(made)
    worker = sorted((s for s in rec.spans if s.name == "mapping"),
                    key=lambda s: s.t0_ns)
    assert len(worker) == len(sys_.epochs) == len(inserts) >= 2
    by_id = {s.id: s for s in rec.spans}
    for ins, m in zip(inserts, worker):
        assert m.frame == ins.frame
        assert m.parent == ins.parent and by_id[m.parent].name == "track"
        assert m.t0_ns >= ins.t1_ns
    assert sys_.timers.series["LM_0"] == [(m.t1_ns - m.t0_ns) / 1e6
                                          for m in worker]


# -- the benchmark's reduction on the device trace's clock ---------------

def records(spans, counts=(), anchors=((10**18, 5_000),)):
    return timing.Records(
        [timing.Span(*s) for s in spans],
        [timing.Count(*c) for c in counts], list(anchors))


def test_anchor_arithmetic_names_gaps_and_launches():
    w = 10**18 - 5_000            # wall minus perf of the anchor
    rec = records([
        (0, "frame", 10_000, 90_000, None, (0, 7)),
        (1, "track", 12_000, 88_000, 0, (0, 7)),
        (2, "server", 20_000, 80_000, 1, (0, 7)),
        (3, "server.verify", 30_000, 50_000, 2, (0, 7)),
        (4, "frame", 100_000, 200_000, None, (0, 8)),
        (5, "mapping", 120_000, 180_000, 4, (0, 8))],
        [("verify_tried", 1, (0, 7), 31_000)],
        anchors=((10**18 + 1, 4_999), (10**18, 5_000)))
    prog = pt.from_records(rec, profiled_ns=0)     # all profiled
    assert prog.spans[3].t0 == 30_000 + w
    assert pt.program_span_at(prog, 40_000 + w) == (
        "frame/track/server/server.verify")
    assert pt.program_span_at(prog, 95_000 + w) == pt.BETWEEN
    # two device ops and the idle gap between them, inside server.verify
    ops = [("a", 25_000 + w, 31_000 + w), ("b", 45_000 + w, 46_000 + w)]
    gaps = [(31_000 + w, 14_000)]
    assert pt.idle_gaps_program(prog, gaps) == [
        ["frame/track/server/server.verify", 14e-6]]
    rows, named = pt.idle_by_program_span(prog, gaps)
    assert rows == [["server.verify", 14e-6]] and named == 1.0
    # a gap across the end of the call: part named, part between calls
    rows, named = pt.idle_by_program_span(prog, [(85_000 + w, 10_000)])
    assert dict(rows) == {"track": 3e-6, "frame": 2e-6,
                          pt.BETWEEN: 5e-6}
    assert named == 0.5
    # device ops count for the span open at their device start
    starts = [115_000 + w, 130_000 + w, 179_000 + w, 180_000 + w]
    assert pt.ops_in(prog, ("mapping",), starts) == 2
    assert pt.ops_in(prog, ("server.verify",), starts) == 0
    assert pt.ops_in(prog, ("mapping",), [o[1] for o in ops]) == 0


def test_records_of_a_run_split_at_the_profiled_mission():
    class Trace:
        window_ns = (10**18 + 60_000, 10**18 + 300_000)
        spans = []

    TRACER.enable()
    for call in range(2):
        with TRACER.frame(0, call), TRACER.span("track"):
            TRACER.count("verify_tried")
    rec = TRACER.take()
    t = Trace()
    assert pt.records(t) is None           # taken already: nothing left
    assert not TRACER.enabled              # the first reader turns it off
    prog = pt.from_records(rec, profiled_ns=pt.to_wall(
        rec.anchors, rec.spans[-1].t0_ns))
    assert len(prog.window_spans("frame")) == 1
    assert len(prog.profiled_spans("frame")) == 1
    assert prog.window_count("verify_tried") == 1
