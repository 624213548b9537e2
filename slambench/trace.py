"""What a traced run (``--trace 1``) records, and the reduction of the
profiler's trace.

Spans come from the benchmark's own wrappers around calls into the
program's layers: a per-layer metric file (``layers/<name>.py``) names
the calls it times in ``SPANS`` (``{"span": "module:attr"}``, ``attr``
may be ``Class.method``) and the calls whose arguments it reads in
``CALLS`` (``{"name": ("module:attr", keep)}``, where ``keep(args,
kwargs, result)`` picks what to hold).  A span synchronises the device
at both ends and records (name, start, end, frame id) on the host clock;
a call record keeps references to what ``keep`` picked, with no device
work, while the profiler runs.
After the window, one whole mission runs under ``torch.profiler``, whose
kernels, copies and memsets give the device's busy time; the span
metrics read the window's spans and leave that mission's out.
"""

from __future__ import annotations

import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

BREAKDOWN_ENTRIES = 10


def resolve(target: str):
    """'module:attr' or 'module:Class.method' -> (owner, attr name)."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


@dataclass
class Recorder:
    device: torch.device
    # (name, t0, t1, frame, profiled)
    spans: List[tuple] = field(default_factory=list)
    calls: Dict[str, list] = field(default_factory=dict)
    frame: int = -1            # id of the frame in flight (window order)
    profiling: bool = False    # the profiler runs: keep calls, flag spans
    span_targets: Dict[str, str] = field(default_factory=dict)
    _undo: List[tuple] = field(default_factory=list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str, target: str) -> None:
        """Time every call of ``target`` as span ``name`` (once a name)."""
        if name in self.span_targets:
            if self.span_targets[name] != target:
                raise ValueError(f"span {name!r} names two targets")
            return
        self.span_targets[name] = target
        owner, attr = resolve(target)
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            self._sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._sync()
                self.spans.append((name, t0, time.perf_counter(),
                                   self.frame, self.profiling))

        self._patch(owner, attr, timed)

    def call(self, name: str, target: str, keep) -> None:
        """Keep ``keep(args, kwargs, result)`` of every call of ``target``
        made while the profiler runs (once a name)."""
        if name in self.calls:
            return
        owner, attr = resolve(target)
        fn = getattr(owner, attr)
        rows = self.calls.setdefault(name, [])

        @functools.wraps(fn)
        def kept(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.profiling:
                rows.append(keep(args, kwargs, out))
            return out

        self._patch(owner, attr, kept)

    def _patch(self, owner, attr, new) -> None:
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, new)

    def remove(self) -> None:
        """Put every wrapped attribute back, newest first."""
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo.clear()


def device_intervals(prof):
    """(name, start_ns, end_ns) of every kernel, copy and memset that the
    profiler saw on the card, in start order; the timestamps are on the
    host's wall clock (``time.time_ns``)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    out.sort(key=lambda x: x[1])
    return out


def busy_ns(intervals, t0: int, t1: int) -> int:
    """Length of the union of the intervals inside [t0, t1]."""
    busy, cur_s, cur_e = 0, None, None
    for _, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(intervals, t0: int, t1: int):
    """(start_ns, length_ns) of each stretch inside [t0, t1] in which no
    operation ran on the card."""
    gaps, edge = [], t0
    for _, s, e in intervals:
        if s > edge:
            gaps.append((edge, min(s, t1) - edge))
        edge = max(edge, e)
        if edge >= t1:
            break
    if edge < t1:
        gaps.append((edge, t1 - edge))
    return [g for g in gaps if g[1] > 0]


@dataclass
class Trace:
    """What the metric readers get from a traced run."""

    spans: List[tuple]                 # (name, t0, t1, frame, profiled)
    calls: Dict[str, list]             # name -> [what keep picked]
    intervals: List[tuple]             # device (name, start_ns, end_ns)
    window_ns: tuple                   # the profiled mission (wall clock ns)
    frames_profiled: int               # calls the profiled mission made
    wall_minus_perf_ns: int            # time.time_ns() - perf_counter_ns()

    def timed_spans(self) -> List[tuple]:
        """(name, t0, t1, frame) of the window's spans (the profiled
        mission's left out)."""
        return [s[:4] for s in self.spans if not s[4]]

    def span_durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1, _ in self.timed_spans() if n == name]

    def frames_with(self, name: str) -> set:
        return {f for n, _, _, f in self.timed_spans() if n == name}

    def device_by_name(self) -> Dict[str, tuple]:
        """Kernel name -> (count, total ns) in the profiled mission."""
        out: Dict[str, list] = {}
        for name, s, e in self.intervals:
            c = out.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += e - s
        return {k: tuple(v) for k, v in out.items()}

    def busy_s(self) -> float:
        return busy_ns(self.intervals, *self.window_ns) / 1e9

    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def span_at(self, wall_ns: int) -> str:
        """The innermost benchmark span the host was in at ``wall_ns``."""
        t = (wall_ns - self.wall_minus_perf_ns) / 1e9
        best = None
        for n, t0, t1, _, _ in self.spans:
            if t0 <= t < t1 and (best is None or t0 > best[1]):
                best = (n, t0)
        return best[0] if best else "between calls"

    def breakdown(self) -> dict:
        ops = sorted(((k, v[1] / 1e9) for k, v in self.device_by_name().items()),
                     key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = sorted(idle_gaps(self.intervals, *self.window_ns),
                      key=lambda g: -g[1])[:BREAKDOWN_ENTRIES]
        return dict(device_ops=[[k[:120], v] for k, v in ops],
                    idle_gaps=[[self.span_at(s), n / 1e9] for s, n in gaps])
