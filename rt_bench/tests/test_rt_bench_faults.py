"""A run's check catches what the timed path could get wrong: each fault
is planted under the harness, which then runs on the CPU at a small size
with a cell's own limits, and ``correct`` must come out false; the sound
run must come out true.

The faults (``rt_bench/faults.py``, which also reads them on the card at
a cell's own size): a step that returns its state unchanged, half of a
step's samples left out with the mean taken over the rest, and an answer
altered where it is produced."""

import pytest

from rt_bench.faults import altered_answer, half_the_samples, unchanged_state
from rt_bench.tests.common import CELLS, run_small


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell, steps=2)
    assert res["correct"], res["rows"]


@pytest.mark.parametrize("fault", [unchanged_state, half_the_samples,
                                   altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    res = run_small(cell, steps=3)
    assert res["frames"] >= 2  # a fault in a later step has a step to hit
    assert not res["correct"], res["rows"]
