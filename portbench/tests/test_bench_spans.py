"""The readers of the program's phases and spans: each reads its phase
(``Run.phase``) or its tallied span's host time (``harness/spans.py``) in
the traced window, and nothing where the window was not traced, the phase
or span never ran or the program has neither."""
from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

from portbench.harness import spans, spec
from portbench.harness.record import Episode, Run

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())

# metric -> (phase, expected reading of the synthetic run below, whose two
# episodes hold 0.25 s of the phase each)
PHASE_READERS = {
    "world.share.sim": ("world", 100.0 * 0.5 / 10.0),
    "eval.share.sim": ("eval", 100.0 * 0.5 / 10.0),
    "batched.wave_ms_per_round": ("wave", 1e3 * 0.5 / 40),
}
# metric -> (span, expected reading of the synthetic run and a tally of
# 0.5 s of the span)
SPAN_READERS = {
    "k2.host_us_per_merge.sim": ("k2", 1e6 * 0.5 / 40),
    "k2.host_us_per_merge.lm": ("k2", 1e6 * 0.5 / 40),
    "lm.data_share": ("data", 100.0 * 0.5 / 10.0),
    "lm.update_share": ("step.update", 100.0 * 0.5 / 10.0),
    "eval.share.lm": ("eval", 100.0 * 0.5 / 10.0),
}
READERS = {**PHASE_READERS, **SPAN_READERS}
# the entries this change appends to ``per_layer``, in order
APPENDED = ["world.share.sim", "eval.share.sim", "batched.wave_ms_per_round",
            "k2.host_us_per_merge.sim", "k2.host_us_per_merge.lm",
            "lm.data_share", "lm.update_share", "eval.share.lm"]


def _run(traced=True, phases=None):
    eps = [Episode(index=i, seed=i, counts={"rounds": 20, "merges": 20},
                   phases=dict(phases or {}))
           for i in range(2)]
    return Run(cell=None, episodes=eps, window_s=10.0, launches={},
               trace=object() if traced else None)


def _tally(monkeypatch, totals):
    monkeypatch.setattr(spans, "totals", lambda: totals)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_reader_reads_its_span(monkeypatch, name):
    span, want = SPAN_READERS[name]
    read = spec.metric_reader(name).read
    _tally(monkeypatch, {span: (0.5, 3), "other": (9.0, 1)})
    assert read(_run()) == pytest.approx(want)
    assert read(_run(traced=False)) is None


@pytest.mark.parametrize("name", sorted(PHASE_READERS))
def test_reader_reads_its_phase(monkeypatch, name):
    """A phase reader sums its phase over the episodes, and ignores the
    span tally."""
    phase, want = PHASE_READERS[name]
    read = spec.metric_reader(name).read
    _tally(monkeypatch, {phase: (9.0, 3)})
    assert read(_run(phases={phase: 0.25, "run": 2.0})) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_without_its_span(monkeypatch, name):
    read = spec.metric_reader(name).read
    _tally(monkeypatch, {"other": (0.5, 3)})
    assert read(_run(phases={"run": 2.0})) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """An older program (no ``span_totals``, no ``world`` or ``wave``
    phase) leaves every reader but ``eval.share.sim`` silent, and none
    raises; the older batched engine's ``eval`` phase still reads."""
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry.timers",
                        types.ModuleType("repro_torch.telemetry.timers"))
    assert spans.totals() == {}
    older = _run(phases={"plan": 0.1, "stage": 0.1, "run": 2.0,
                         "eval": 0.25})
    for name in READERS:
        got = spec.metric_reader(name).read(older)
        assert (got is None) == (name != "eval.share.sim"), name


def test_new_entries_are_appended_readers():
    names = [m["name"] for m in BENCHMARK["per_layer"]]
    assert names[-len(APPENDED):] == APPENDED
    assert set(APPENDED) == set(READERS)
    for m in BENCHMARK["per_layer"][-len(APPENDED):]:
        assert m["source"] == "program_span"


# the tiny stand-ins (``conftest.py``) and the cells they stand for
REAL = {"cnn-tiny": "cnn-fleet-k100-batched",
        "grid-tiny": "cnn-k100-beta-grid-w15", "lm-tiny": "lm-fl-qwen05b-s512"}


@pytest.mark.parametrize("name", sorted(REAL))
def test_traced_tiny_cell_reports_its_span_metrics(run_tiny, name):
    """On the CPU profiler the program's spans run, so every span metric
    listed for the cell reads a positive number."""
    real = REAL[name]
    want = {m["name"] for m in BENCHMARK["per_layer"][-len(APPENDED):]
            if real in m["workloads"]}
    out = run_tiny(name, seed=11, trace=True)
    assert want and want <= set(out["metrics"])
    for m in want:
        assert out["metrics"][m]["value"] > 0, m
    if name != "lm-tiny":
        assert out["metrics"]["world.share.sim"]["value"] < 100.0
