"""The port's corridor engine (``engine="corridor"``) under vehicle
selection against ``repro``'s, on the CPU, from one (JAX-drawn) init with
the kernel path on (``_torch_engines.py``); the serial handover loop's
cases are in ``test_torch_selection_handover.py``.

- corridor-quick-r2-k8 with weighted-topk and eps-bandit for 12 rounds:
  the same trace and ``report.selection``, times within the f32 band,
  params within ``PARAM_TOL``;
- the chains keep the plan's under selection, the EMA reconcile's
  ``ValueError``, parked vehicles, the bandit divergence guard, and the
  registry's bandit corridor cut to K 40."""
from __future__ import annotations

import dataclasses

import pytest

import repro_torch.core.scenarios as tsc
import repro_torch.corridor.engine as tengine
from _torch_engines import (QUICK, assert_corridor_conforms,  # noqa: F401
                            corridor_pair, init, perturbed,
                            registry_selection_pair)
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["corridor"])
@pytest.mark.parametrize("sel", [
    dict(selection="weighted-topk", selection_k=3),
    dict(selection="eps-bandit", selection_k=2, selection_eps=0.4),
], ids=["weighted-topk", "eps-bandit"])
def test_corridor_engines_conform_under_selection(init, engine, sel):
    jres, tres = corridor_pair(QUICK, engine, init, 4, rounds=12, **sel)
    assert_corridor_conforms(jres, tres, engine)
    decisions = tres.report.selection["decisions"]
    assert [b for b, _, _ in decisions] == [4, 8]
    if sel["selection"] == "eps-bandit":
        # parked vehicles re-enter at the reconcile boundaries
        assert any(newly for _, newly, _ in decisions)


def test_corridor_chain_launches_keep_the_plan_under_selection(monkeypatch):
    """Re-admissions fall on reconcile rounds, which split segments
    already: the corridor's chains are those of its plan, and a FedAvg
    world without selection keeps its count."""
    calls = []
    real = tengine.agg_ops.ring_agg
    monkeypatch.setattr(tengine.agg_ops, "ring_agg",
                        lambda *a: calls.append(a) or real(*a))
    sel = dict(selection="eps-bandit", selection_k=2, selection_eps=0.4)
    tsc.run_scenario(QUICK, rounds=12, eval_every=4, device="cpu", **sel)
    sc = dataclasses.replace(tsc.get_scenario(QUICK), **sel)
    p = sc.channel()
    plan = tengine.plan_corridor(p, 2, 0, 12, selection=sc.selection_spec(),
                                 reconcile_every=4)
    assert len(calls) == tengine.chain_launches(plan, (4, 8, 12), 4)
    assert sum(a[1].shape[0] for a in calls) == 12
    readmits = tengine.readmit_points(plan)
    assert readmits and set(readmits) <= {4, 8}
    assert tengine.readmit_points(tengine.plan_corridor(p, 2, 0, 12)) == {}


@pytest.mark.parametrize("engine", ["corridor"])
def test_selection_with_ema_reconcile_raises(engine):
    with pytest.raises(ValueError, match="ema"):
        tsc.run_scenario(QUICK, engine=engine, rounds=6,
                         reconcile_mode="ema", selection="weighted-topk",
                         selection_k=2, device="cpu")
    with pytest.raises(ValueError, match="ema"):
        tsc.run_scenario("corridor-r4-k400-bandit", engine=engine,
                         reconcile_mode="ema", device="cpu")


def test_admit_all_with_ema_reconcile_runs():
    res = tsc.run_scenario(QUICK, engine="corridor", rounds=6,
                           eval_every=6, reconcile_mode="ema",
                           selection="admit-all", device="cpu")
    assert all(res.report.selection["admit0"]) and len(res.rounds) == 6


def test_parked_vehicles_never_arrive_on_the_corridor():
    res = tsc.run_scenario(QUICK, rounds=12, eval_every=12, device="cpu",
                           selection="weighted-topk", selection_k=1)
    summary = res.report.selection
    masks = [summary["admit0"]] + [m for _, _, m in summary["decisions"]]
    ever = {v for m in masks for v, a in enumerate(m) if a}
    assert len(ever) < 8 and {r.vehicle for r in res.rounds} <= ever


@pytest.mark.parametrize("which, match", [
    ("counts", "arrival counts"), ("sums", "reward accumulators")])
@pytest.mark.parametrize("engine", ["corridor"])
def test_bandit_guard_raises_on_a_perturbed_expectation(monkeypatch, engine,
                                                        which, match):
    monkeypatch.setattr(tengine, "plan_corridor",
                        perturbed(tengine.plan_corridor, which))
    with pytest.raises(RuntimeError, match=match):
        tsc.run_scenario(QUICK, engine=engine, rounds=8,
                         selection="eps-bandit", selection_k=2,
                         device="cpu", eval_every=8)


@pytest.mark.parametrize("name, engine", [
    ("corridor-r4-k400-bandit", "corridor"),
])
def test_registry_selection_worlds_cut_to_k40(init, name, engine):
    """The registry's bandit corridor at its rounds with K cut to 40 and k
    5 per RSU (``SELECTION_CUTS``), so the policy still parks vehicles."""
    jres, tres = registry_selection_pair(init, name, engine)
    assert_corridor_conforms(jres, tres, engine)
