"""launches_per_frame: layer "device".  Every kernel, copy and memset
that torch.profiler saw on the card in the profiled mission (one whole
mission after the window), over the calls that mission made.  The
profiler drops some kernels on the machine with the card (about 7.5% in
earlier runs), so the count is a lower bound."""


def read(trace, run):
    if not trace.intervals or not trace.frames_profiled:
        return None
    return len(trace.intervals) / trace.frames_profiled
