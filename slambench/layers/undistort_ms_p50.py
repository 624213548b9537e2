"""undistort_ms_p50: layer "extraction" (the program's spans
``extract.undistort``: ``ops/orb.py:with_undistorted`` on a pinhole
camera, the Newton undistortion of every keypoint in
``geometry/cameras.py``, under the facade's ``extract``).  The median of
their host time over the window's calls, one span a call.  None where
the program records no such span: a KB8 camera, or a program without
the span.  The program's tracer is on from this reader's import (a
traced run only).

Provisional: ``euroc_mono`` renders frames with no lens distortion and
so sets EuRoC cam0's k1, k2, p1 and p2 to zero.  A shortcut taken at
zero distortion moves this metric but not the deployment it stands for,
whose published coefficients are not zero: it is no gain there."""

import numpy as np

from slambench import program_trace

program_trace.switch_on()


def read(trace, run):
    prog = program_trace.records(trace)
    if prog is None:
        return None
    ms = [s.ms for s in prog.window_spans("extract.undistort")]
    return float(np.median(ms)) if ms else None
