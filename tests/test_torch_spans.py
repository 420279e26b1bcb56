"""The port's profiler ranges (``telemetry/timers.py``): ``record_function``
ranges ``repro.<name>`` on the profiler's clock around every phase of the
batched engine and the sweep tier, and around the spans of K2's wrapper
and the LM loop.

Under a CPU profiler each path emits its ranges, nested where the work
nests; with no profiler a span dispatches no op; and the results are
bitwise the same with the profiler on and off."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_threads import one_thread  # noqa: F401
from repro_torch.check.telemetry_off import OpSequence
from repro_torch.configs import get_config
from repro_torch.core.scenarios import run_scenario
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.telemetry.timers import PhaseTimers, span, span_totals

pytestmark = pytest.mark.usefixtures("one_thread")

ROUNDS, EVAL_EVERY = 6, 3
TRAIN_ROUNDS, L_ITERS = 3, 2


def _scenario(engine="batched"):
    return run_scenario("quick-k5", engine=engine, use_kernel=engine != "vmap",
                        rounds=ROUNDS, eval_every=EVAL_EVERY, device="cpu")


def _training():
    cfg = get_config("smollm-360m").reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    args = train.build_parser().parse_args(
        ["--reduced", "--rounds", str(TRAIN_ROUNDS), "--l-iters",
         str(L_ITERS), "--device", "cpu", "--use-kernel"])
    return train.run_training(cfg, model, args, log=lambda *a: None)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro.")]
    return out, ranges, span_totals()


def _names(ranges):
    out: dict = {}
    for n, _s, _e in ranges:
        out[n] = out.get(n, 0) + 1
    return out


def _inside(ranges, inner, outer):
    """Every ``inner`` range lies inside some ``outer`` range."""
    outs = [(s, e) for n, s, e in ranges if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for n, s, e in ranges if n == inner)


@pytest.fixture(scope="module")
def scenario_runs():
    """quick-k5 on the batched engine with K2, without and with a CPU
    profiler."""
    off = _scenario()
    on, ranges, totals = _profiled(_scenario)
    return off, on, ranges, totals


@pytest.fixture(scope="module")
def training_runs():
    off = _training()
    on, ranges, totals = _profiled(_training)
    return off, on, ranges, totals


def test_batched_scenario_ranges(scenario_runs):
    _, on, ranges, totals = scenario_runs
    n = _names(ranges)
    for name in ("world", "stage", "plan", "run", "eval", "wave", "k2"):
        assert n.get("repro." + name), name
    assert n["repro.world"] == n["repro.stage"] == n["repro.plan"] == 1
    assert n["repro.run"] == 1
    assert n["repro.eval"] == ROUNDS // EVAL_EVERY
    # one K2 wrapper call a merged round; waves, merges and evals run
    # inside the engine's event loop
    assert n["repro.k2"] == len(on.rounds) == ROUNDS
    for inner in ("wave", "k2", "eval"):
        assert _inside(ranges, "repro." + inner, "repro.run"), inner
    assert not _inside(ranges, "repro.world", "repro.run")
    # the tally holds the spans (K2's wrapper), not the phases, which
    # report.phases holds
    assert set(totals) == {"k2"}
    assert totals["k2"][1] == n["repro.k2"] and totals["k2"][0] > 0
    assert set(on.report.phases) == {
        k[len("repro."):] for k in n} - {"k2"}


def test_batched_scenario_phases(scenario_runs):
    """``world`` (run_scenario), ``stage`` (the host engines) and ``wave``
    (the batched engine's waves) join the batched path's phases; a serial
    run has every phase but ``plan`` and ``wave``."""
    off, on, _, _ = scenario_runs
    for res in (off, on):
        assert set(res.report.phases) == {"world", "stage", "plan", "run",
                                          "eval", "wave"}
        assert res.report.phases["wave"] <= res.report.phases["run"]
        assert all(v >= 0.0 for v in res.report.phases.values())
    serial = run_scenario("quick-k5", engine="serial", rounds=2,
                          eval_every=2, device="cpu")
    assert set(serial.report.phases) == {"world", "stage", "run", "eval"}


def test_batched_scenario_bitwise_with_profiler(scenario_runs):
    off, on, _, _ = scenario_runs
    assert [(r.round, r.vehicle, r.time) for r in off.rounds] == \
        [(r.round, r.vehicle, r.time) for r in on.rounds]
    assert off.acc_history == on.acc_history
    assert off.loss_history == on.loss_history
    for k in off.final_params:
        assert torch.equal(off.final_params[k], on.final_params[k]), k


def test_sweep_world_phase_and_ranges():
    """The sweep tier times its worlds' building as ``world`` and traces
    every phase."""
    res, ranges, _ = _profiled(lambda: _scenario("vmap"))
    assert {"world", "plan", "stage", "run", "eval"} <= set(
        res.report.phases)
    n = _names(ranges)
    for name in ("world", "plan", "stage", "run", "eval"):
        assert n.get("repro." + name) == 1, name


def test_training_ranges(training_runs):
    _, on, ranges, totals = training_runs
    n = _names(ranges)
    assert n["repro.data"] == 1
    assert n["repro.step.update"] == TRAIN_ROUNDS * L_ITERS
    assert n["repro.eval"] == len(on.heldout) == 1
    assert n["repro.k2"] == TRAIN_ROUNDS
    assert totals["step.update"][1] == TRAIN_ROUNDS * L_ITERS


def test_training_bitwise_with_profiler(training_runs):
    off, on, _, _ = training_runs
    assert off.vehicles == on.vehicles
    assert [float(x) for x in off.local_losses] == \
        [float(x) for x in on.local_losses]
    assert off.heldout == on.heldout
    for k in off.params:
        assert torch.equal(off.params[k], on.params[k]), k


@pytest.mark.parametrize("path", ["batched", "training"])
def test_no_profiler_no_op(path):
    """With no profiler recording, no span dispatches an op."""
    assert not torch.autograd._profiler_enabled()
    with OpSequence() as rec:
        if path == "batched":
            _scenario()
        else:
            _training()
    assert rec.ops
    assert not [op for op in rec.ops if op.startswith("profiler")]


def test_span_off_and_newest_session():
    """A span is a no-op context with no profiler; the tally holds the
    newest profiling session's spans only; a phase opens a range of its
    name, which the tally leaves out, and a phase run with no profiler
    ends a session as a span does."""
    with span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a"):
            np.zeros(1)
        with span("a"):
            pass
    assert set(span_totals()) == {"a"} and span_totals()["a"][1] == 2
    with span("between"):           # no profiler: the next session starts
        pass
    timers = PhaseTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.phase("plan"):
            with span("b"):
                pass
    assert set(span_totals()) == {"b"}
    assert set(timers.snapshot()) == {"plan"}
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "repro.plan" in names and "repro.b" in names
    with timers.phase("between"):   # a phase ends the session too
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("c"):
            pass
    assert set(span_totals()) == {"c"}
