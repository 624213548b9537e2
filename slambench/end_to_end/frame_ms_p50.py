"""frame_ms_p50: the median wall time of every ``track_monocular`` call
in the window, from the frame handed to the facade until its state and
pose are on the host (host clock)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 50)) * 1e3
