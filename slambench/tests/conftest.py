"""Every test of the benchmark ends with the program's tracer off and
empty: importing a per-layer reader of the program's records turns it on
(``program_trace.switch_on``), as a traced run needs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import program_trace  # noqa: E402


@pytest.fixture(autouse=True)
def program_tracer_off():
    yield
    t = program_trace.tracer()
    if t is not None:
        t.disable()
        t.take()
