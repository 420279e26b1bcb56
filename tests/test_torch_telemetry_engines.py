"""Telemetry on the port's single-RSU engines (``serial``, ``batched``,
``jit``) against ``repro``, on the CPU, on ``repro``'s telemetry-test world
(K 4, 8 rounds of one local step).

- Off is the run without metrics, bitwise (params, trace, accuracy), for
  every off spelling: None, False, "off" and a disabled spec; ``repro``
  runs the same spellings (``metrics=False`` raised on the port's host
  engines before this slice).
- On leaves the models bitwise unchanged.
- The channels equal ``repro``'s f64 replay: the histogram and the
  occupancy exactly, the pop wait within rtol 1e-4 / atol 1e-3 (f32 on the
  fleet engine), ``spec.edges`` bit for bit; the bf16 ring guard.
- Under faults (fleet-k1000-flaky cut to K 40) the fleet engine's fault
  counters equal ``repro``'s fault replay, and a perturbed device table
  trips the guard; under eps-bandit the reward accumulators equal
  ``repro``'s selection replay.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core.jit_engine as jjit
import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.data as jdata
import repro.faults as jfaults
import repro.selection as jsel
import repro.telemetry.replay as jreplay
import repro.telemetry.spec as jspec
import repro_torch.core.jit_engine as tjit
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.data as tdata
import repro_torch.selection as tsel
from repro.channel import ChannelParams as JParams
from repro_torch.channel import ChannelParams as TParams
from _torch_engines import GAP_TOL, OFF, digest
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROUNDS = 8
ENGINES = ["serial", "batched", "jit"]


def _world(data, params):
    tr_i, tr_l, te_i, te_l = data.synth_mnist(n_train=256, n_test=64,
                                              seed=0)
    p = dataclasses.replace(params(), K=4)
    veh = data.partition_vehicles(tr_i, tr_l, p, seed=0, scale=0.03)
    return veh, te_i, te_l, p


@pytest.fixture(scope="module")
def world():
    return _world(tdata, TParams)


def _run(world, engine, **kw):
    veh, te_i, te_l, p = world
    return tmafl.run_simulation(veh, te_i, te_l, scheme="mafl",
                                rounds=ROUNDS, l_iters=1, lr=0.05, params=p,
                                seed=0, eval_every=4, engine=engine,
                                batch_size=32, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(world):
    """``runs(engine, metrics)``: one run per engine and setting, made once
    for the module (``metrics=None`` is the run without metrics)."""
    cache = {}

    def get(engine, metrics=None):
        key = (engine, repr(metrics))
        if key not in cache:
            cache[key] = _run(world, engine, metrics=metrics)
        return cache[key]
    return get


@pytest.mark.parametrize("engine", ENGINES)
def test_metrics_off_is_bitwise_the_run_without_metrics(runs, engine):
    base = runs(engine)
    assert base.report.engine == engine and not base.report.metrics_on
    for off in OFF:
        res = runs(engine, off)
        assert digest(res) == digest(base), off
        assert not res.report.metrics_on
        assert res.report.channels == {} and res.report.spec is None


@pytest.mark.parametrize("engine", ENGINES)
def test_off_spellings_run_on_repro_too(runs, engine):
    """The spellings the port treats as off are ``repro``'s: both packages
    run them to the same trace with an empty report."""
    veh, te_i, te_l, p = _world(jdata, JParams)
    for off in (False, jspec.MetricsSpec(enabled=False)):
        jres = jmafl.run_simulation(veh, te_i, te_l, rounds=2, l_iters=1,
                                    params=p, eval_every=2, engine=engine,
                                    batch_size=32, metrics=off)
        assert not jres.report.metrics_on and jres.report.channels == {}
    tres = runs(engine, False)
    assert ([r.vehicle for r in tres.rounds[:2]]
            == [r.vehicle for r in jres.rounds])
    for bad in ("sometimes", 1):
        with pytest.raises(ValueError, match="unknown metrics setting"):
            jmafl.run_simulation(veh, te_i, te_l, rounds=2, params=p,
                                 engine=engine, metrics=bad)
        with pytest.raises(ValueError, match="unknown metrics setting"):
            runs(engine, bad)


@pytest.mark.parametrize("engine", ENGINES)
def test_metrics_on_leaves_the_models_unchanged(runs, engine):
    on = runs(engine, "on")
    assert digest(on) == digest(runs(engine))
    assert on.report.metrics_on and on.report.spec["enabled"]


def assert_fleet_channels(res, p, rounds, selection=None, faults=None,
                          l_iters=1):
    """The run's channels against ``repro``'s f64 replay of its world."""
    rep = jreplay.replay_fleet_channels(p, 0, rounds, selection=selection,
                                        faults=faults, l_iters=l_iters)
    spec = jspec.resolve_metrics("on", stale=rep["stale"],
                                 times=rep["times"])
    ch = res.report.channels
    assert res.report.spec["edges"] == list(spec.edges)
    assert np.array_equal(ch["stale_hist"],
                          jspec.stale_histogram(spec.edges, rep["stale"]))
    assert np.array_equal(ch["occupancy"], rep["occupancy"])
    np.testing.assert_allclose(ch["gap"], rep["gap"], **GAP_TOL)
    assert len(ch["reward"]) == rounds and np.all(ch["reward"] > 0)
    return rep


@pytest.mark.parametrize("engine", ENGINES)
def test_channels_equal_repro_replay(runs, engine):
    on = runs(engine, "on")
    assert_fleet_channels(on, dataclasses.replace(JParams(), K=4), ROUNDS)
    want = {"stale_hist", "occupancy", "gap", "reward"}
    assert set(on.report.channels) == want
    if engine == "jit":
        assert on.report.waves["total_trained"] == ROUNDS
    else:
        assert on.report.waves is None


def test_jit_bf16_ring_guard(world):
    on = _run(world, "jit", ring_dtype="bf16", metrics="on")
    ch = on.report.channels
    assert int(ch["ring_nonfinite"]) == 0
    assert float(ch["ring_max_abs"]) > 0.0
    assert on.report.spec["ring_guard"]
    assert_fleet_channels(on, dataclasses.replace(JParams(), K=4), ROUNDS)
    assert digest(on) == digest(_run(world, "jit", ring_dtype="bf16"))


FLAKY = dict(K=40, rounds=16, n_train=1200, n_test=120)


def _flaky(engine, **kw):
    return tsc.run_scenario("fleet-k1000-flaky", engine=engine,
                            eval_every=16, device="cpu", metrics="on",
                            **FLAKY, **kw)


def test_fleet_fault_counters_equal_repro_replay():
    """fleet-k1000-flaky cut to K 40 on the fleet engine: the device's
    i32[4] counters are the sum of ``repro``'s fault replay's counts
    table; the channels are its replay's too."""
    res = _flaky("jit")
    jw = dataclasses.replace(jsc.get_scenario("fleet-k1000-flaky"), **FLAKY)
    spec = jfaults.scenario_faults(jw)
    exp = jfaults.replay_fleet_faults(
        jw.channel(), 0, jw.rounds, spec,
        l_iters=jw.l_iters).counts_table(jw.l_iters).sum(0)
    assert np.array_equal(res.report.channels["fault_counts"], exp)
    assert exp[0] + exp[1] > 0 and exp[3] > 0
    assert res.report.spec["fault_counters"]
    assert res.report.faults["counts"] == res.extras["faults"]["counts"]
    assert_fleet_channels(res, jw.channel(), jw.rounds, faults=spec,
                          l_iters=jw.l_iters)


def test_fleet_fault_counter_guard_raises(monkeypatch):
    real = tjit.metrics_setup

    def perturbed(*a, **kw):
        mst, fault_tab, ring_stats, store = real(*a, **kw)
        fault_tab[0, 0] += 1
        return mst, fault_tab, ring_stats, store

    monkeypatch.setattr(tjit, "metrics_setup", perturbed)
    with pytest.raises(RuntimeError, match="fault counters diverged"):
        _flaky("jit")


BANDIT = dict(policy="eps-bandit", k=2, eps=0.3, resel_every=4)


def test_fleet_bandit_accumulators_equal_repro(world):
    """eps-bandit on the fleet engine: the f32 reward accumulators in the
    report equal ``repro``'s selection replay's (counts exactly, sums
    within the guard's band), and the selection summary is ``repro``'s
    plan's."""
    on = _run(world, "jit", metrics="on",
              selection=tsel.SelectionSpec(**BANDIT))
    p = dataclasses.replace(JParams(), K=4)
    plan = jjit.plan_fleet(p, 0, ROUNDS, jsel.SelectionSpec(**BANDIT))
    exp_rs, exp_rc = plan.sel_bandit
    ch = on.report.channels
    assert np.array_equal(ch["reward_count"], exp_rc)
    np.testing.assert_allclose(ch["reward_sum"], exp_rs, rtol=1e-4,
                               atol=1e-3)
    assert on.report.selection == plan.sel.summary()
    assert_fleet_channels(on, p, ROUNDS,
                          selection=jsel.SelectionSpec(**BANDIT))
