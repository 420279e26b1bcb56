"""The comparison catches a broken timed path.  Each test plants a fault of
``harness/faults.py`` underneath a tiny cell and drives the rest of a run
past the harness's look for a card: ``correct`` must come out false."""
from __future__ import annotations

import pytest

from portbench.harness import faults

CELLS = {"cnn-tiny": "scenario", "grid-tiny": "sweep", "lm-tiny": "lm_train"}
CASES = [(c, f) for c in CELLS for f in faults.NAMES]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_broken_program_is_not_correct(run_tiny, monkeypatch, name, fault):
    faults.plant(CELLS[name], fault, monkeypatch.setattr)
    out = run_tiny(name, seed=11)
    assert out["correct"] is False
    assert out["failed"] >= 1
