"""Each cell, cut to a CPU size, runs end to end past the harness's look
for a card: the plain reference agrees with the program within the cell's
limits, and the result's line keeps the contract's keys."""
from __future__ import annotations

import json
import math

import pytest

CELLS = ["cnn-tiny", "grid-tiny", "lm-tiny"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program(run_tiny, name):
    out = run_tiny(name, seed=2**31 + 17)
    for k, c in out["checks"].items():
        assert c["value"] is not None and c["limit"] is not None, k
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], (k, c)
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(run_tiny, name):
    out = run_tiny(name, seed=5)
    assert list(out) == KEYS + ["checks"]
    assert out["device"]["count"] == 1
    assert set(out["metrics"]) >= {"setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert m["value"] > 0
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_keys(run_tiny, name):
    out = run_tiny(name, seed=6, trace=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in out["metrics"]
    # on the CPU no device operation runs: the roofline readers stay silent
    assert not any("roofline" in k for k in out["metrics"])


def test_same_seed_same_inputs(run_tiny):
    a = run_tiny("cnn-tiny", seed=9)["checks"]
    b = run_tiny("cnn-tiny", seed=9)["checks"]
    assert a == b
