"""merge_verify_per_kf: layer "server: verification" (the program's
counter ``verify_tried_merge``: one a ``LoopServer._verify_candidate``
call on a candidate of another map, which a MERGE would follow).  Those
in the window over the keyframes the server processed there (its
``server`` spans): the cross-map verification load, which grows with
the maps in the atlas.  None where the program does not count such
candidates (its ``COUNTER_NAMES`` lack the counter) or processed no
keyframe.  The program's tracer is on from this reader's import (a
traced run only)."""

import importlib

from slambench import program_trace

program_trace.switch_on()

COUNTER = "verify_tried_merge"


def counted() -> bool:
    """Whether the program counts merge candidates at all."""
    try:
        timing = importlib.import_module("mam3slam_tpu_torch.utils.timing")
    except ImportError:
        return False
    return COUNTER in getattr(timing, "COUNTER_NAMES", ())


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None or not counted():
        return None
    n = len(prog.window_spans("server"))
    if not n:
        return None
    return prog.window_count(COUNTER) / n
