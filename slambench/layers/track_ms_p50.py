"""track_ms_p50: layer "tracking step" (``slam/system.py:SlamSystem.track``
on calls that ran no mapping epoch and no server epoch:
``programs()["track_frame_step"]``, ``csrc/match.cu``, ``csrc/pose.cu``).
The median of those spans' wall time."""

import numpy as np

SPANS = {"track": "mam3slam_tpu_torch.slam.system:SlamSystem.track",
         "mapping": "mam3slam_tpu_torch.slam.system:SlamSystem._local_mapping",
         "server": "mam3slam_tpu_torch.slam.server:LoopServer.process_keyframe"}


def read(trace, run):
    busy = trace.frames_with("mapping") | trace.frames_with("server")
    ms = [t1 - t0 for name, t0, t1, frame in trace.timed_spans()
          if name == "track" and frame not in busy]
    return float(np.median(ms)) * 1e3 if ms else None
