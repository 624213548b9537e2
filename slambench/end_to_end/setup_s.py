"""setup_s: seconds from process start to the first timed frame: the
imports, the kernel library (built on the first run in a checkout), the
rendered frames staged on the card and the warm-up system."""


def read(run):
    return run.setup_s
