"""server_correct_ms_per_event: layer "server: correction" (the
program's spans ``server.correct``, ``LoopServer.correct_loop``, and
``server.merge``, ``merge_maps``: Sim3 propagation, essential-graph PGO,
fuse, welding BA, the dispatch of the global BA).  Their mean host time
in the window.  The program's tracer is on from this reader's import (a
traced run only)."""

from slambench import program_trace

program_trace.switch_on()


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    ms = [s.ms for s in prog.window_spans("server.correct", "server.merge")]
    return sum(ms) / len(ms) if ms else None
