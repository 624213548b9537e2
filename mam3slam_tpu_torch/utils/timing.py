"""Named series of wall-clock milliseconds per stage.

Port of ``mam3slam_tpu.utils.timing``: the reference's always-on per-stage
timing vectors (tracking, local mapping), recorded by a context manager or
added directly, summarised as (count, mean, median, max).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


class Timers:
    def __init__(self):
        self.series: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.series[name].append((time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float):
        self.series[name].append(ms)

    def summary(self) -> Dict[str, tuple]:
        out = {}
        for k, v in self.series.items():
            if v:
                a = np.asarray(v)
                out[k] = (len(a), float(a.mean()), float(np.median(a)),
                          float(a.max()))
        return out
