"""extract_ms_p50: layer "extraction" (``ops/orb.py:extract_orb`` and
``with_undistorted``, ``csrc/orb_desc.cu``).  The median over frames of
the two spans' wall time, each synchronised at both ends."""

import numpy as np

SPANS = {"extract": "mam3slam_tpu_torch.ops.orb:extract_orb",
         "undistort": "mam3slam_tpu_torch.ops.orb:with_undistorted"}


def read(trace, run):
    per_frame = {}
    for name, t0, t1, frame in trace.timed_spans():
        if name in SPANS:
            per_frame[frame] = per_frame.get(frame, 0.0) + (t1 - t0)
    if not per_frame:
        return None
    return float(np.median(list(per_frame.values()))) * 1e3
