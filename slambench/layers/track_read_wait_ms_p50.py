"""track_read_wait_ms_p50: layer "tracking step" (the program's spans
``track.read``: the tracking step's two blocking reads, the coarse
inlier count that decides the widened retry inside
``track_frame_step``, and ``SlamSystem._read_vec``, the packed result).
Per call, their host time summed; the median over the window's calls
that ran no mapping epoch and no server epoch (as ``track_ms_p50``
takes them): the frame's wait for the card, against ``track_ms_p50``'s
whole step, whose rest is the host's dispatch.  The program's tracer is
on from this reader's import (a traced run only)."""

from collections import defaultdict

import numpy as np

from slambench import program_trace

program_trace.switch_on()


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    by_id = prog.by_id()
    busy = {prog.root_of(s, by_id).id
            for s in prog.window_spans("mapping", "server")}
    wait = defaultdict(float)
    for s in prog.window_spans("track.read"):
        root = prog.root_of(s, by_id).id
        if root not in busy:
            wait[root] += s.ms
    return float(np.median(list(wait.values()))) if wait else None
