"""server_verify_ms_per_kf: layer "server: verification" (the program's
spans ``server.verify``, one a ``_verify_candidate``: brute-force match,
Sim3 RANSAC, guided projections, OptimizeSim3; and ``server.refine``,
``_refine_hypothesis``).  Their host time in the window over the
keyframes the server processed there (its ``server`` spans).  The
program's tracer is on from this reader's import (a traced run only)."""

from slambench import program_trace

program_trace.switch_on()

PARTS = ("server.verify", "server.refine")


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    n = len(prog.window_spans("server"))
    if not n:
        return None
    return sum(s.ms for s in prog.window_spans(*PARTS)) / n
