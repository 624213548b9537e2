"""server_sim3_opt_ms_per_call: layer "server: verification" (the
program's spans ``server.sim3_opt``, one a ``_optimize_sim3_pairs`` call
under ``server.verify`` or ``server.refine``: the pairs' gathers,
OptimizeSim3 and the read of its inlier count).  Their mean host time in
the window; None where the program records no such span.  The program's
tracer is on from this reader's import (a traced run only)."""

from slambench import program_trace

program_trace.switch_on()


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    ms = [s.ms for s in prog.window_spans("server.sim3_opt")]
    return sum(ms) / len(ms) if ms else None
