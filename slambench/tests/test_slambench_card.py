"""On the card, at each cell's own size: the program's extraction numbers
fall under their limits and the bfloat16 control's do not (one seed a
cell; ``slambench/control.py`` reads more).  Skips without a card.

    python -m pytest slambench/tests/test_slambench_card.py -m cuda
"""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import check, control, harness  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kb8_fixture.loop1"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = harness.load_cell(workload)
    r = control.readings(cell, 2**31 + 101, card)
    limits = check.limits_of(cell.config, cell.traffic)
    assert r["correct"], r
    assert any(r["control"][k] > limits[k] for k in r["control"]), r
