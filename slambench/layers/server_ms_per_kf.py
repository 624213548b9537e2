"""server_ms_per_kf: layer "server" (``slam/server.py:LoopServer.
process_keyframe``: place recognition, verification, loop and merge
correction, PGO, global BA).  The wall time of its spans in the window
over the keyframes it processed."""

SPANS = {"server": "mam3slam_tpu_torch.slam.server:LoopServer.process_keyframe"}


def read(trace, run):
    ms = trace.span_durations("server")
    return sum(ms) / len(ms) * 1e3 if ms else None
