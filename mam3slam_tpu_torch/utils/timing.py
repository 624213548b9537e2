"""Named series of wall-clock milliseconds per stage, and the spans and
counters of the port's layers.

``Timers`` holds the operator's series that the shutdown artifacts write
(``io/writers.py``): a system's ``LM_<agent>`` (``TimesLM_i``), a
server's ``PR`` / ``LC`` / ``MM`` (``TimesPR`` / ``TimesLC`` /
``TimesMM``).  Each is fed by the span of the same boundary
(``Tracer.timed``), whether tracing is on or off.

``TRACER``, the process's tracer, records while enabled:

* a span at each layer boundary (``SPAN_NAMES``): name, start and end
  (``time.perf_counter_ns``), the span it runs under and the frame id of
  the call it serves, ``(agent, per-agent call number)``, which the root
  span ``frame`` assigns and every span under it inherits.  The stack of
  open spans is per thread; a job handed to another thread carries its
  cause (``current`` / ``adopt``);
* a counter increment at the same boundaries (``COUNTER_NAMES``): name,
  amount, frame id and time;
* an anchor pair ``(time.time_ns(), time.perf_counter_ns())`` at
  ``enable`` and at each ``take``, which puts the spans on the wall clock
  that ``torch.profiler`` stamps device events with.

Records stay in memory until ``take`` hands them over.  A series gets a
value only from a span whose block returned.  No span touches
the device: a duration is host time, and ends on a host read only where
the code inside ends on one.  Off (the default) ``span``, ``frame``,
``adopt`` and ``count`` cost one call and one flag test.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

# every span the port records, parents before children
SPAN_NAMES = (
    "frame",                       # MultiAgentSystem.track_monocular
    "extract",                     # extract_orb + with_undistorted
    "extract.undistort",           # with_undistorted, pinhole only
    "track",                       # SlamSystem.track
    "track.init", "track.step", "track.read", "track.ref_kf",
    "track.reloc", "kf.insert",
    "mapping",                     # SlamSystem._local_mapping -> LM_<agent>
    "mapping.epoch", "mapping.read", "mapping.cull",
    "server",                      # LoopServer.process_keyframe -> PR
    "server.vocab", "server.index", "server.detect", "server.verify",
    "server.refine",
    "server.sim3_opt",             # OptimizeSim3 and its inlier count
    "server.correct",              # correct_loop -> LC
    "server.merge",                # merge_maps -> MM
    "server.pgo", "server.fuse", "server.gba")
# _verify_candidate: every candidate, and those of another map (a merge)
COUNTER_NAMES = ("verify_tried", "verify_passed", "verify_tried_merge",
                 "verify_passed_merge")


class Timers:
    """Named series of milliseconds, one value an event."""

    def __init__(self):
        self.series: Dict[str, List[float]] = defaultdict(list)

    def add(self, name: str, ms: float):
        self.series[name].append(ms)


class Span(NamedTuple):
    id: int
    name: str
    t0_ns: int                  # time.perf_counter_ns()
    t1_ns: int
    parent: Optional[int]       # id of the span it ran under
    frame: Optional[Tuple[int, int]]   # (agent, per-agent call number)


class Count(NamedTuple):
    name: str
    amount: int
    frame: Optional[Tuple[int, int]]
    t_ns: int                   # time.perf_counter_ns()


class Records(NamedTuple):
    spans: List[Span]
    counts: List[Count]
    anchors: List[Tuple[int, int]]   # (time.time_ns(), perf_counter_ns())


def anchor() -> Tuple[int, int]:
    """(wall ns, perf-counter ns) read together: the wall clock at the
    perf counter's midpoint of two reads."""
    p0 = time.perf_counter_ns()
    w = time.time_ns()
    p1 = time.perf_counter_ns()
    return w, (p0 + p1) // 2


class _Off:
    """A span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Timed:
    """A span that feeds a series while tracing is off: its duration."""

    __slots__ = ("timers", "key", "t0")

    def __init__(self, timers: Timers, key: str):
        self.timers, self.key = timers, key

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        if exc[0] is None:
            self.timers.add(self.key,
                            (time.perf_counter_ns() - self.t0) / 1e6)
        return False


class _Span:
    __slots__ = ("tracer", "name", "timers", "key", "frame", "id", "parent",
                 "t0")

    def __init__(self, tracer, name, timers=None, key=None, frame=None):
        self.tracer, self.name = tracer, name
        self.timers, self.key, self.frame = timers, key, frame

    def __enter__(self):
        stack = self.tracer._stack()
        if stack:
            self.parent, self.frame = stack[-1]
        else:
            self.parent = None
        self.id = next(self.tracer._ids)
        stack.append((self.id, self.frame))
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.tracer._stack().pop()
        with self.tracer._lock:   # a plain tuple; take() makes it a Span
            self.tracer._spans.append((self.id, self.name, self.t0, t1,
                                       self.parent, self.frame))
        if self.timers is not None and exc[0] is None:
            self.timers.add(self.key, (t1 - self.t0) / 1e6)
        return False


class _Adopted:
    """Open spans run under ``cause`` (another thread's span)."""

    __slots__ = ("tracer", "cause")

    def __init__(self, tracer, cause):
        self.tracer, self.cause = tracer, cause

    def __enter__(self):
        self.tracer._stack().append(self.cause)

    def __exit__(self, *exc):
        self.tracer._stack().pop()
        return False


class Tracer:
    """Spans and counters of the port's layers, kept in memory."""

    def __init__(self):
        self.enabled = False
        self._local = threading.local()
        self._lock = threading.Lock()   # the lists against take()
        self._ids = itertools.count()
        self._spans: list = []        # plain tuples of Span fields
        self._counts: list = []
        self._anchors: List[Tuple[int, int]] = []

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def enable(self):
        """Start recording (and record an anchor pair)."""
        with self._lock:
            self._anchors.append(anchor())
        self.enabled = True

    def disable(self):
        self.enabled = False

    def take(self) -> Records:
        """Hand over what was recorded since the last ``take`` and clear
        it; the anchors end with one read now."""
        a = anchor()
        with self._lock:
            spans, counts, anchors = self._spans, self._counts, self._anchors
            self._spans, self._counts, self._anchors = [], [], [a]
        return Records([Span._make(s) for s in spans],
                       [Count._make(c) for c in counts], anchors + [a])

    def span(self, name: str):
        """``with TRACER.span(name):`` records the block as span
        ``name``."""
        if not self.enabled:
            return _OFF
        return _Span(self, name)

    def timed(self, name: str, timers: Timers, key: str):
        """``span(name)`` whose duration also goes to series ``key`` of
        ``timers``, on or off."""
        if not self.enabled:
            return _Timed(timers, key)
        return _Span(self, name, timers, key)

    def frame(self, agent: int, call: int):
        """The root span ``frame`` of one call of ``agent``, frame id
        ``(agent, call)``; nothing where a span is already open on this
        thread (the caller's root holds)."""
        if not self.enabled or self._stack():
            return _OFF
        return _Span(self, "frame", frame=(agent, call))

    def current(self):
        """(span id, frame id) of this thread's innermost open span, for
        a job handed to another thread; None when off or outside every
        span."""
        if not self.enabled:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    def adopt(self, cause=None):
        """``with TRACER.adopt(cause):`` spans opened inside run under
        ``cause`` (from ``current``) and share its frame id."""
        if not self.enabled or cause is None:
            return _OFF
        return _Adopted(self, cause)

    def count(self, name: str, amount: int = 1):
        """Add ``amount`` to counter ``name``."""
        if not self.enabled:
            return
        stack = self._stack()
        with self._lock:
            self._counts.append((name, amount,
                                 stack[-1][1] if stack else None,
                                 time.perf_counter_ns()))


TRACER = Tracer()
