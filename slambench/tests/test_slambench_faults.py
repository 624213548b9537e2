"""A run of the harness on the CPU at a size a test can hold (the
euroc_mono deployment at half size, one agent, 36 frames), past the
look for a card: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cells
can have (``slambench/faults.py``): a step that returns its state
unchanged (the mapping epoch, the bundle adjustment, the tracking
pose), half of the batch left out (every second keypoint dropped), and
an answer altered where it is produced (a descriptor byte inverted).

The exchange between chips is left out of no cell: every cell runs on
one card.  The run measures nothing here: ``metrics_of`` reads the
host clock of a CPU run, and ``run.py`` refuses to report without a
card (``test_slambench_layout``).
"""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import faults, harness  # noqa: E402

SEED = 2**31 + 11
SECONDS = 45.0


def tiny_cell():
    return harness.Cell(
        name="tiny.tiny1", workload={"chips": 1},
        config=harness.load_json(os.path.join(HERE, "data", "tiny.json")),
        traffic=harness.load_json(os.path.join(HERE, "data", "tiny1.json")),
        end_to_end=[], per_layer=[])


def run_tiny():
    torch.manual_seed(0)
    return harness.run_cell(tiny_cell(), SEED, SECONDS, False, "cpu", 0.0)


def test_a_sound_run_is_correct():
    out = run_tiny()
    v = out["verdict"]
    assert out["run"].missions_complete >= 1
    assert v["correct"], (v["rows"], v["faults"])
    assert not out["forbidden"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(fault):
    with faults.planted(fault):
        v = run_tiny()["verdict"]
    assert not v["correct"], (v["rows"], v["faults"])
