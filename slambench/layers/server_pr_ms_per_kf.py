"""server_pr_ms_per_kf: layer "server: place recognition" (the program's
spans ``server.vocab``, ``server.index`` and ``server.detect`` under
``LoopServer.process_keyframe``: the bootstrap vocabulary, BoW indexing,
candidate detection).  Their host time in the window over the
keyframes the server processed there (its ``server`` spans).  The
program's tracer is on from this reader's import (a traced run only)."""

from slambench import program_trace

program_trace.switch_on()

PARTS = ("server.vocab", "server.index", "server.detect")


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    n = len(prog.window_spans("server"))
    if not n:
        return None
    return sum(s.ms for s in prog.window_spans(*PARTS)) / n
