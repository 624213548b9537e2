"""The readers of the program's own records (``program_trace.py`` and the
six ``layers/`` files that read it): each gives its number from a
hand-built ``Trace`` and None without records; the first reader takes
the window's records from the tracer and turns it off; on the card, one
short traced run of ``kb8_fixture.loop1`` puts every program ``mapping``
and ``server`` span inside the benchmark's wrapper span of the same
call, on the shared clock, one program span a wrapper span.

    python -m pytest slambench/tests/test_slambench_program_trace.py
    python -m pytest slambench/tests/test_slambench_program_trace.py -m cuda
"""

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import harness  # noqa: E402
from slambench import program_trace as pt  # noqa: E402
from slambench import trace as trace_mod  # noqa: E402

READERS = ("server_pr_ms_per_kf", "server_verify_ms_per_kf",
           "server_correct_ms_per_event", "track_read_wait_ms_p50",
           "mapping_launches_per_epoch", "verify_yield_pct")
MS = 1_000_000                  # ns
T0 = 10**18                     # the window's start, wall clock ns
P0 = T0 + 1000 * MS             # the profiled mission's start


def span(i, name, t0_ms, t1_ms, parent, frame, base=T0):
    return pt.Span(i, name, base + t0_ms * MS, base + t1_ms * MS, parent,
                   frame)


def program():
    """Two window calls (the second inserts a keyframe: mapping, then the
    server with place recognition, two verifications, a refinement and a
    loop correction), then one profiled call with a mapping epoch."""
    spans = [
        span(0, "frame", 0, 20, None, (0, 0)),
        span(1, "track", 5, 19, 0, (0, 0)),
        span(2, "track.read", 10, 13, 1, (0, 0)),
        span(3, "track.step", 6, 9, 1, (0, 0)),
        span(4, "track.read", 7, 8, 3, (0, 0)),
        span(10, "frame", 30, 600, None, (0, 1)),
        span(11, "track", 35, 590, 10, (0, 1)),
        span(12, "track.read", 40, 48, 11, (0, 1)),
        span(13, "mapping", 50, 150, 11, (0, 1)),
        span(14, "server", 150, 580, 11, (0, 1)),
        span(15, "server.vocab", 151, 171, 14, (0, 1)),
        span(16, "server.index", 171, 181, 14, (0, 1)),
        span(17, "server.detect", 181, 191, 14, (0, 1)),
        span(18, "server.verify", 191, 221, 14, (0, 1)),
        span(19, "server.verify", 221, 271, 14, (0, 1)),
        span(20, "server.refine", 271, 281, 14, (0, 1)),
        span(21, "server.correct", 281, 561, 14, (0, 1)),
        span(30, "frame", 0, 400, None, (0, 0), base=P0),
        span(31, "track", 5, 390, 30, (0, 0), base=P0),
        span(32, "track.read", 10, 15, 31, (0, 0), base=P0),
        span(33, "mapping", 100, 300, 31, (0, 0), base=P0)]
    counts = [pt.Count("verify_tried", 1, (0, 1), T0 + 191 * MS),
              pt.Count("verify_tried", 1, (0, 1), T0 + 221 * MS),
              pt.Count("verify_passed", 1, (0, 1), T0 + 271 * MS),
              pt.Count("verify_tried", 1, (0, 0), P0 + 200 * MS)]
    return pt.Program(spans, counts, P0)


def hand_built_trace(prog):
    # device ops of the profiled mission: 3 start inside its mapping span
    ops = [("k", P0 + t * MS, P0 + t * MS + 1000) for t in
           (50, 120, 150, 299, 350)]
    t = trace_mod.Trace(spans=[], calls={}, intervals=ops,
                        window_ns=(P0, P0 + 400 * MS), frames_profiled=1,
                        wall_minus_perf_ns=0)
    t.program = prog
    return t


def read(name, trace):
    return harness.metric_module("layers", name).read(trace, None)


def test_each_reader_reads_the_hand_built_records():
    t = hand_built_trace(program())
    got = {name: read(name, t) for name in READERS}
    assert got == pytest.approx(dict(
        server_pr_ms_per_kf=40.0,               # (20 + 10 + 10) / 1 keyframe
        server_verify_ms_per_kf=90.0,           # 30 + 50 + 10
        server_correct_ms_per_event=280.0,
        track_read_wait_ms_p50=4.0,             # 3 + 1, the call with no epoch
        mapping_launches_per_epoch=3.0,
        verify_yield_pct=50.0))                 # the window's 1 of 2


def test_each_reader_returns_none_without_records():
    for prog in (None, pt.Program([], [], P0)):
        t = hand_built_trace(prog)
        for name in READERS:
            assert read(name, t) is None, name
    # a program without a tracer, or one that recorded nothing
    t = hand_built_trace(None)
    del t.program
    tr = pt.tracer()
    tr.disable()
    tr.take()
    assert all(read(name, t) is None for name in READERS)


def test_the_first_reader_takes_the_window_and_turns_the_tracer_off():
    tr = pt.tracer()
    pt.switch_on()
    tr.take()
    with tr.frame(0, 0), tr.span("track"):       # before the window
        tr.count("verify_tried")
    time.sleep(0.01)
    mark = time.perf_counter_ns()     # the first wrapper span's start
    time.sleep(0.01)
    with tr.frame(0, 1), tr.span("track"):
        tr.count("verify_tried")
        tr.count("verify_passed")
    wall = time.time_ns() - time.perf_counter_ns()
    t = trace_mod.Trace(spans=[("track", mark / 1e9, mark / 1e9 + 1e-3, 0,
                                False)],
                        calls={}, intervals=[], window_ns=(2**62, 2**62 + 1),
                        frames_profiled=1, wall_minus_perf_ns=wall)
    assert read("verify_yield_pct", t) == 100.0     # the window's 1 of 1
    assert not tr.enabled and tr.take().spans == []
    assert [s.frame for s in t.program.spans] == [(0, 1), (0, 1)]
    assert t.program.window_count("verify_tried") == 1


@pytest.mark.cuda
def test_program_spans_lie_inside_the_wrappers_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell("kb8_fixture.loop1")
    pt.switch_on()          # the warm-up too, which records() leaves out
    out = harness.run_cell(cell, 2**31 + 5, 8.0, True,
                           torch.device("cuda", 0), 0.0)
    trace = out["trace"]
    prog = pt.records(trace)
    assert not pt.tracer().enabled
    off = trace.wall_minus_perf_ns
    for name in ("mapping", "server"):
        wrappers = sorted((s for s in trace.spans if s[0] == name),
                          key=lambda s: s[1])
        mine = [s for s in prog.spans if s.name == name]
        assert len(mine) == len(wrappers) >= 1, name
        for w, p in zip(wrappers, mine):
            # the anchors and the harness's offset read the two clocks
            # at other instants: 1 ms of room
            lo, hi = w[1] * 1e9 + off, w[2] * 1e9 + off
            assert lo - 1e6 <= p.t0 <= p.t1 <= hi + 1e6, (w, p)
    assert len(prog.profiled_spans("mapping")) == sum(
        1 for s in trace.spans if s[0] == "mapping" and s[4])
