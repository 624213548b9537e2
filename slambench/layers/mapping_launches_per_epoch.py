"""mapping_launches_per_epoch: layer "mapping epoch"
(``SlamSystem._local_mapping``: the ``mapping_epoch`` program, its read,
KeyFrameCulling).  In the profiled mission (one whole mission after the
window under torch.profiler): the kernels, copies and memsets the card
ran that were launched inside the program's ``mapping`` spans, over
those spans.  A launch is placed by the op's device start
(``program_trace``: the trace keeps no runtime calls); the profiler
drops some kernels on the machine with the card, so the count is a
lower bound.  The program's tracer is on from this reader's import (a
traced run only)."""

from slambench import program_trace

program_trace.switch_on()


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None or not trace.intervals:
        return None
    epochs = prog.profiled_spans("mapping")
    if not epochs:
        return None
    n = program_trace.ops_in(prog, ("mapping",),
                             [s for _, s, _ in trace.intervals])
    return n / len(epochs)
