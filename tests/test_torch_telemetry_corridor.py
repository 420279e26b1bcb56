"""Telemetry on the port's corridor engines (``corridor`` and the serial
handover loop) against ``repro``, on the CPU.

- Off is the run without metrics, bitwise, for None, False, "off" and a
  disabled spec; ``repro`` runs the same spellings; on leaves the models
  bitwise unchanged, and ``run_scenario`` stamps the scenario's name.
- The channels equal ``repro``'s f64 corridor replay: the ``[R, B]``
  histogram, the ``[M, R]`` occupancy, the handover flag and its per-RSU
  count exactly, the pop wait within rtol 1e-4 / atol 1e-3, on
  corridor-quick-r2-k8 (both engines) and highway-k40-handover cut to 24
  rounds of one local step (handovers happen).
- The dead-zone corridor cut to K 40: the fault counters equal ``repro``'s
  fault replay; the bandit corridor cut to K 40: the reward accumulators
  equal ``repro``'s selection replay.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core.scenarios as jsc
import repro.faults as jfaults
import repro.telemetry.replay as jreplay
import repro.telemetry.spec as jspec
import repro_torch.core.scenarios as tsc
from _torch_engines import GAP_TOL, OFF, digest
from repro.corridor.plan import plan_corridor as jplan_corridor
from repro_torch.telemetry import MetricsSpec
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

QUICK = "corridor-quick-r2-k8"
ENGINES = ["corridor", "serial"]


def _run(engine, name=QUICK, **kw):
    return tsc.run_scenario(name, engine=engine, eval_every=4,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def runs():
    """``runs(engine, metrics)``: one corridor-quick-r2-k8 run per engine
    and setting, made once for the module."""
    cache = {}

    def get(engine, metrics=None):
        key = (engine, repr(metrics))
        if key not in cache:
            cache[key] = _run(engine, metrics=metrics)
        return cache[key]
    return get


@pytest.mark.parametrize("engine", ENGINES)
def test_metrics_off_is_bitwise_the_run_without_metrics(runs, engine):
    base = runs(engine)
    assert base.report.engine == engine and base.report.scenario == QUICK
    for off in OFF:
        res = runs(engine, off)
        assert digest(res) == digest(base), off
        assert not res.report.metrics_on
        assert res.report.channels == {} and res.report.spec is None


@pytest.mark.parametrize("engine", ENGINES)
def test_off_spellings_run_on_repro_too(engine):
    for off in (False, jspec.MetricsSpec(enabled=False)):
        jres = jsc.run_scenario(QUICK, engine=engine, rounds=2,
                                eval_every=2, metrics=off)
        assert not jres.report.metrics_on and jres.report.channels == {}
        tres = _run(engine, rounds=2, metrics=False if off is False
                    else MetricsSpec(enabled=False))
        assert ([(r.vehicle, r.rsu) for r in tres.rounds]
                == [(r.vehicle, r.rsu) for r in jres.rounds])
        assert ((tres.report.engine, tres.report.scheme)
                == (jres.report.engine, jres.report.scheme))
    with pytest.raises(ValueError, match="unknown metrics setting"):
        _run(engine, metrics="sometimes")


@pytest.mark.parametrize("engine", ENGINES)
def test_metrics_on_leaves_the_models_unchanged(runs, engine):
    on = runs(engine, "on")
    assert digest(on) == digest(runs(engine))
    assert on.report.metrics_on and on.report.scenario == QUICK
    assert on.report.scheme == ("mafl+corridor" if engine == "corridor"
                                else "mafl+handover")


def assert_corridor_channels(res, name, **cut):
    """The run's channels against ``repro``'s f64 replay of its world."""
    sc = dataclasses.replace(jsc.get_scenario(name), **cut)
    faults = jfaults.scenario_faults(sc)
    rep = jreplay.replay_corridor_channels(
        sc.channel(), sc.n_rsus, 0, sc.rounds, entry=sc.corridor_entry,
        selection=sc.selection_spec(), reconcile_every=sc.reconcile_every,
        faults=faults, l_iters=sc.l_iters)
    spec = jspec.resolve_metrics("on", stale=rep["stale"],
                                 times=rep["times"], n_rsus=sc.n_rsus)
    ch = res.report.channels
    assert res.report.spec["edges"] == list(spec.edges)
    assert res.report.spec["n_rsus"] == sc.n_rsus
    assert np.array_equal(
        ch["stale_hist"],
        jspec.stale_histogram(spec.edges, rep["stale"], rsu=rep["up_rsu"],
                              n_rsus=sc.n_rsus))
    assert np.array_equal(ch["occupancy"], rep["occupancy"])
    assert np.array_equal(np.asarray(ch["handover"], bool), rep["handover"])
    assert np.array_equal(ch["handover_count"], rep["handover_count"])
    np.testing.assert_allclose(ch["gap"], rep["gap"], **GAP_TOL)
    assert len(ch["reward"]) == sc.rounds
    return sc, rep


@pytest.mark.parametrize("engine", ENGINES)
def test_channels_equal_repro_replay(runs, engine):
    on = runs(engine, "on")
    assert_corridor_channels(on, QUICK)
    if engine == "corridor":
        assert on.report.waves["total_trained"] == 8
    else:
        assert on.report.waves is None


def test_highway_handover_channel_counts():
    """A corridor world whose vehicles cross cell boundaries: 24 pops is
    the earliest highway-k40-handover hands over (the replay's first
    handover is pop 22)."""
    cut = dict(rounds=24, l_iters=1)
    on = _run("corridor", "highway-k40-handover", metrics="on", **cut)
    _, rep = assert_corridor_channels(on, "highway-k40-handover", **cut)
    assert int(rep["handover_count"].sum()) > 0


DEADZONE = "corridor-rush-hour-deadzone-r8-k4000"


def test_corridor_fault_counters_equal_repro_replay():
    cut = dict(K=40, n_train=1200, n_test=120)
    on = _run("corridor", DEADZONE, metrics="on", **cut)
    sc, _ = assert_corridor_channels(on, DEADZONE, **cut)
    exp = jfaults.replay_corridor_faults(
        sc.channel(), sc.n_rsus, 0, sc.rounds, jfaults.scenario_faults(sc),
        l_iters=sc.l_iters, entry=sc.corridor_entry,
        reconcile_every=sc.reconcile_every).counts_table(
            sc.l_iters).sum(0)
    assert np.array_equal(on.report.channels["fault_counts"], exp)
    assert exp[1] > 0 and exp[3] > 0
    assert on.report.faults["counts"] == on.extras["faults"]["counts"]


def test_corridor_bandit_accumulators_equal_repro():
    name = "corridor-r4-k400-bandit"
    cut = dict(K=40, selection_k=5, n_train=1200, n_test=120)
    on = _run("corridor", name, metrics="on", **cut)
    sc, _ = assert_corridor_channels(on, name, **cut)
    plan = jplan_corridor(sc.channel(), sc.n_rsus, 0, sc.rounds,
                          entry=sc.corridor_entry,
                          selection=sc.selection_spec(),
                          reconcile_every=sc.reconcile_every)
    exp_rs, exp_rc = plan.sel_bandit
    ch = on.report.channels
    assert np.array_equal(ch["reward_count"], exp_rc)
    np.testing.assert_allclose(ch["reward_sum"], exp_rs, rtol=1e-4,
                               atol=1e-3)
    assert on.report.selection == plan.sel.summary()
