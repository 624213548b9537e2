"""The program's own spans and counters in a traced run (``--trace 1``),
on the clock of the profiler's device trace.

The program's tracer (``mam3slam_tpu_torch/utils/timing.py``, ``TRACER``)
records, while it is on, one span at each layer boundary (name, start,
end, the span it ran under, the frame id ``(agent, call)`` of the call
it serves), its counters, and anchor pairs ``(time.time_ns(),
time.perf_counter_ns())`` that put its perf-counter stamps on the wall
clock, the clock torch.profiler stamps device events with
(``trace.device_intervals``).  It costs nothing when off, and is on
only in a traced run: the harness imports the per-layer readers
(``layers/<metric>.py``) only under ``--trace 1``, after the warm-up and
before the window, and a reader of the program's records calls
``switch_on`` when it is imported.  The first reader to run takes the
records (``records``), turns the tracer off and keeps the records on the
``Trace``, from the window's first call on (what ended before the
benchmark's first wrapper span is dropped): spans that start before the
profiled mission (``Trace.window_ns``) are the window's, the rest the
profiled mission's.  A program without the tracer gives no records; the
readers then return None.

A device op counts for the program span open at the op's device start.
``Trace`` keeps no runtime calls, so the host time of the launch is not
known; the device start trails it by little, since the card idles most
of the time and every layer that hands over to the next ends on a host
read.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

BREAKDOWN_ENTRIES = 10
BETWEEN = "between calls"


def tracer():
    """The program's tracer, or None where the program has none."""
    try:
        timing = importlib.import_module("mam3slam_tpu_torch.utils.timing")
    except ImportError:
        return None
    return getattr(timing, "TRACER", None)


def switch_on() -> None:
    """Turn the program's tracer on (where it has one)."""
    t = tracer()
    if t is not None and not t.enabled:
        t.enable()


def to_wall(anchors, perf_ns: int) -> int:
    """A perf-counter stamp on the wall clock, through the anchor pair
    nearest to it."""
    w, p = min(anchors, key=lambda a: abs(a[1] - perf_ns))
    return perf_ns + (w - p)


@dataclass
class Span:
    id: int
    name: str
    t0: int             # wall clock ns
    t1: int
    parent: Optional[int]
    frame: Optional[tuple]

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


@dataclass
class Count:
    name: str
    amount: int
    frame: Optional[tuple]
    t: int              # wall clock ns


@dataclass
class Program:
    """The program's records of one run, on the wall clock."""

    spans: List[Span]
    counts: List[Count]
    profiled_ns: Optional[int]   # the profiled mission's start, None: none

    def in_window(self, t: int) -> bool:
        return self.profiled_ns is None or t < self.profiled_ns

    def window_spans(self, *names) -> List[Span]:
        return [s for s in self.spans if self.in_window(s.t0)
                and (not names or s.name in names)]

    def profiled_spans(self, *names) -> List[Span]:
        return [s for s in self.spans if not self.in_window(s.t0)
                and (not names or s.name in names)]

    def window_count(self, name: str) -> int:
        return sum(c.amount for c in self.counts
                   if self.in_window(c.t) and c.name == name)

    def by_id(self) -> Dict[int, Span]:
        return {s.id: s for s in self.spans}

    def root_of(self, span: Span, by_id=None) -> Span:
        """The outermost recorded span above ``span``."""
        by_id = by_id or self.by_id()
        while span.parent is not None and span.parent in by_id:
            span = by_id[span.parent]
        return span

    def path(self, span: Span, by_id=None) -> str:
        """``frame/track/mapping/mapping.cull``: the names from the root
        down to ``span``."""
        by_id = by_id or self.by_id()
        names = [span.name]
        while span.parent is not None and span.parent in by_id:
            span = by_id[span.parent]
            names.append(span.name)
        return "/".join(reversed(names))


def from_records(rec, profiled_ns: Optional[int] = None) -> Program:
    """The program's ``Records`` (``TRACER.take()``) on the wall clock."""
    a = rec.anchors
    spans = [Span(s.id, s.name, to_wall(a, s.t0_ns), to_wall(a, s.t1_ns),
                  s.parent, s.frame) for s in rec.spans]
    counts = [Count(c.name, c.amount, c.frame, to_wall(a, c.t_ns))
              for c in rec.counts]
    spans.sort(key=lambda s: s.t0)
    return Program(spans, counts, profiled_ns)


def records(trace) -> Optional[Program]:
    """The program's records of the run ``trace`` belongs to: taken from
    the tracer by the first reader, which turns it off, and kept on
    ``trace`` for the others.  Records that ended before the benchmark's
    first wrapper span (``trace.spans``) are not the window's and are
    dropped.  None where the program has no tracer or recorded
    nothing."""
    if not hasattr(trace, "program"):
        t = tracer()
        trace.program = None
        if t is not None and t.enabled:
            t.disable()
            prog = from_records(t.take(), trace.window_ns[0])
            if trace.spans:
                first = (min(s[1] for s in trace.spans) * 1e9
                         + trace.wall_minus_perf_ns)
                prog.spans = [s for s in prog.spans if s.t1 > first]
                prog.counts = [c for c in prog.counts if c.t > first]
            if prog.spans:
                trace.program = prog
    return trace.program


# -- device ops against the program's spans ----------------------------

def innermost(spans: List[Span]):
    """The program's timeline as (start, end, span) pieces, each under
    the innermost span open there (the latest started; None between
    calls), in time order."""
    spans = [s for s in spans if s.t1 > s.t0]
    edges = sorted({t for s in spans for t in (s.t0, s.t1)})
    if not edges:
        return []
    starts = defaultdict(list)
    ends = defaultdict(list)
    for s in spans:
        starts[s.t0].append(s)
        ends[s.t1].append(s)
    open_, out = [], []
    for a, b in zip(edges[:-1], edges[1:]):
        for s in ends.get(a, ()):
            open_.remove(s)
        open_.extend(starts.get(a, ()))
        top = max(open_, key=lambda s: (s.t0, s.id)) if open_ else None
        out.append((a, b, top))
    return out


class Timeline:
    """Which program span the host was in at a wall-clock instant."""

    def __init__(self, prog: Program, spans: List[Span]):
        self.prog = prog
        self.by_id = prog.by_id()
        self.pieces = innermost(spans)
        self.starts = [p[0] for p in self.pieces]

    def at(self, t: int) -> Optional[Span]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t >= self.pieces[i][1]:
            return None
        return self.pieces[i][2]

    def path_at(self, t: int) -> str:
        s = self.at(t)
        return self.prog.path(s, self.by_id) if s is not None else BETWEEN

    def split(self, t0: int, t1: int):
        """(span or None, ns) of each piece of [t0, t1]."""
        if not self.pieces:
            return [(None, t1 - t0)]
        lo, hi = self.pieces[0][0], self.pieces[-1][1]
        out = [(None, min(t1, lo) - t0)] if t0 < lo else []
        i = max(bisect.bisect_right(self.starts, t0) - 1, 0)
        while i < len(self.pieces) and self.pieces[i][0] < t1:
            a, b, s = self.pieces[i]
            part = min(b, t1) - max(a, t0)
            if part > 0:
                out.append((s, part))
            i += 1
        if t1 > hi:
            out.append((None, t1 - max(t0, hi)))
        return out


def program_span_at(prog: Program, wall_ns: int) -> str:
    """The innermost program span path the host was in at ``wall_ns``
    ("between calls" outside every span)."""
    return Timeline(prog, prog.spans).path_at(wall_ns)


def ops_in(prog: Program, names, times) -> int:
    """How many of the device ops at ``times`` (wall ns, sorted or not)
    fall inside a span named in ``names``."""
    spans = sorted((s.t0, s.t1) for s in prog.spans if s.name in names)
    starts = [a for a, _ in spans]
    n = 0
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        # spans of one name do not nest: the latest start is the one
        if i >= 0 and t < spans[i][1]:
            n += 1
    return n


def idle_gaps_program(prog: Program, gaps, n: int = BREAKDOWN_ENTRIES):
    """The ``n`` longest idle gaps ((start_ns, length_ns), as
    ``trace.idle_gaps`` gives them) named by the innermost program span
    path at their start: ``[[path, seconds], ...]``."""
    tl = Timeline(prog, prog.profiled_spans())
    top = sorted(gaps, key=lambda g: -g[1])[:n]
    return [[tl.path_at(s), ln / 1e9] for s, ln in top]


def idle_by_program_span(prog: Program, gaps, n: int = BREAKDOWN_ENTRIES):
    """Idle seconds summed by the innermost program span (by name; "between
    calls" outside every span), the ``n`` largest, and the share of all
    idle time named by a span: ``([[name, seconds], ...], share)``."""
    tl = Timeline(prog, prog.profiled_spans())
    by = defaultdict(int)
    for s, ln in gaps:
        for span, part in tl.split(s, s + ln):
            by[span.name if span is not None else BETWEEN] += part
    total = sum(by.values())
    named = total - by.get(BETWEEN, 0)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return ([[k, v / 1e9] for k, v in rows],
            named / total if total else None)
