"""mapping_epoch_ms_p50: layer "mapping epoch"
(``SlamSystem._local_mapping`` -> ``programs()["mapping_epoch"]``, the
window BA, ``csrc/segsum.cu``).  The median of its spans' wall time."""

import numpy as np

SPANS = {"mapping": "mam3slam_tpu_torch.slam.system:SlamSystem._local_mapping"}


def read(trace, run):
    ms = trace.span_durations("mapping")
    return float(np.median(ms)) * 1e3 if ms else None
