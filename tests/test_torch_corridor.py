"""The corridor engines on the CPU: the engine's ``ring_agg`` calls
against the plan's chunk count, the EMA reconcile's one ``weighted_agg``
call per reconcile, a selection policy by name, the fault worlds and the
raises.  The runs against ``repro`` are split by engine group into
``tests/test_torch_corridor_{serial,engine,rings}.py`` (shared worlds and
runs in ``tests/_torch_corridor.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core.scenarios as jsc
import repro_torch.core.scenarios as tsc
import repro_torch.corridor.engine as tengine
from _torch_corridor import QUICK
from repro_torch.corridor import run_corridor_simulation
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _count(monkeypatch, name):
    calls = []
    real = getattr(tengine.agg_ops, name)

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(tengine.agg_ops, name, spy)
    return calls


@pytest.mark.parametrize("kw, merges", [
    ({}, 0),
    ({"reconcile_mode": "ema", "reconcile_tau": 0.3}, 2),
], ids=["fedavg", "ema"])
def test_chains_and_reconciles_follow_the_plan(monkeypatch, kw, merges):
    """Every merge goes through ``ring_agg``, one call per chunk of the
    plan; the EMA reconcile is one ``weighted_agg`` call on the [R, P]
    stack per reconcile round, FedAvg none."""
    rings = _count(monkeypatch, "ring_agg")
    trees = _count(monkeypatch, "weighted_agg_tree")
    res = tsc.run_scenario(QUICK, rounds=8, eval_every=3, use_kernel=True,
                           device="cpu", record_cohorts=True, **kw)
    sc = tsc.get_scenario(QUICK)
    plan = tengine.plan_corridor(sc.channel(), sc.n_rsus, 0, 8)
    want = tengine.chain_launches(plan, (3, 6, 8), sc.reconcile_every)
    assert len(rings) == want and sum(a[1].shape[0] for a in rings) == 8
    assert len(trees) == merges
    for g, loc, *_ in trees:
        assert list(g) == ["G"] and g["G"].shape == (2, loc["G"].shape[1])
    assert [r for r, _ in res.acc_history] == [3, 6, 8]
    assert len(res.extras["cohort_snapshots"]) == 3
    assert res.extras["final_cohorts"]["conv1_w"].shape[0] == 2


@pytest.mark.parametrize("kw, err, match", [
    (dict(flat=False, ring_dtype="bf16"), ValueError, "flat fast path"),
    (dict(mesh=object()), NotImplementedError, "item 13"),
    (dict(metrics="sometimes"), ValueError, "unknown metrics setting"),
    (dict(faults="deadzone", reconcile_mode="ema"), ValueError,
     "fault injection"),
    (dict(scheme="fedbuff"), ValueError, "fedbuff"),
    (dict(reconcile_mode="median"), ValueError, "reconcile_mode"),
    (dict(ring_dtype="f16"), ValueError, "ring_dtype"),
])
def test_corridor_engine_rejects(kw, err, match):
    fields = {k: kw.pop(k) for k in ("scheme", "reconcile_mode",
                                     "ring_dtype") if k in kw}
    sc = dataclasses.replace(tsc.get_scenario(QUICK), rounds=2, **fields)
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(err, match=match):
        run_corridor_simulation(sc, veh, ti, tl, p, device="cpu", **kw)


def test_corridor_engine_runs_a_selection_policy():
    """The call that raised before selection was ported: eps-bandit by
    name needs its k, as in ``repro``; with k 1 it re-scores at the
    reconcile boundary and reports the plan's summary."""
    from repro_torch.selection import SelectionSpec
    sc = dataclasses.replace(tsc.get_scenario(QUICK), rounds=6)
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(ValueError, match="needs k"):
        run_corridor_simulation(sc, veh, ti, tl, p, device="cpu",
                                selection="eps-bandit")
    res = run_corridor_simulation(sc, veh, ti, tl, p, device="cpu",
                                  selection=SelectionSpec("eps-bandit", k=1))
    assert len(res.rounds) == 6
    summary = res.report.selection
    assert summary["policy"] == "eps-bandit"
    assert [b for b, _, _ in summary["decisions"]] == [4]
    assert sum(summary["admit0"]) == 2          # k = 1 on each of 2 RSUs


@pytest.mark.parametrize("name, engine, match", [
    (QUICK, "batched", "cannot run multi-RSU"),
    (QUICK, "jit", "cannot run multi-RSU"),
    ("quick-k5", "corridor", "needs a multi-RSU"),
])
def test_run_scenario_rejects_engine_topology_mismatch(name, engine, match):
    with pytest.raises(ValueError, match=match):
        tsc.run_scenario(name, engine=engine, rounds=2, device="cpu")


@pytest.mark.parametrize("engine", ["serial", "corridor"])
def test_fault_worlds_raise(engine):
    """The call that raised before faults were ported: the dead-zone
    corridor, cut to K 40 and 16 rounds, runs on both corridor engines
    and reports ``repro``'s own replay's fault summary."""
    from repro.faults import replay_corridor_faults
    name = "corridor-rush-hour-deadzone-r8-k4000"
    cut = dict(K=40, rounds=16, n_train=1200, n_test=120)
    jsc_ = dataclasses.replace(jsc.get_scenario(name), **cut)
    want = replay_corridor_faults(
        jsc_.channel(), jsc_.n_rsus, 0, jsc_.rounds, jsc_.faults,
        l_iters=jsc_.l_iters, entry=jsc_.corridor_entry,
        reconcile_every=jsc_.reconcile_every).summary(jsc_.l_iters)
    res = tsc.run_scenario(name, engine=engine, device="cpu",
                           eval_every=16, **cut)
    assert len(res.rounds) == 16
    assert res.extras["faults"] == want
    assert want["counts"]["blackout_rounds"] + want["counts"][
        "discarded_uploads"] > 0 or not all(want["admit0"])


def test_run_scenario_defaults_to_the_corridor_engine():
    res = tsc.run_scenario(QUICK, rounds=4, eval_every=4, device="cpu")
    assert res.scheme == "mafl+corridor"
    assert np.isfinite(res.final_accuracy())
