"""fps: every agent's frames completed in the window over the window's
seconds (host clock; the window ends when the last call returns)."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
