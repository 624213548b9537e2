"""device_idle_pct: layer "device".  The share of the profiled mission
(one whole mission after the window) in which no kernel, copy or memset
ran on the card (torch.profiler's timeline)."""


def read(trace, run):
    if not trace.intervals:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
