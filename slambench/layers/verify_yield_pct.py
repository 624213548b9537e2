"""verify_yield_pct: layer "server: verification" (the program's
counters ``verify_tried`` and ``verify_passed``, one each a
``LoopServer._verify_candidate`` call and a candidate it confirmed).
The share of the window's verified candidates that passed.  The
program's tracer is on from this reader's import (a traced run only)."""

from slambench import program_trace

program_trace.switch_on()


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    tried = prog.window_count("verify_tried")
    if not tried:
        return None
    return 100.0 * prog.window_count("verify_passed") / tried
