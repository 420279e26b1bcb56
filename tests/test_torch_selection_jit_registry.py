"""The port's fleet engine (``engine="jit"``) under vehicle selection, the
rest of ``test_torch_selection_jit.py``: parked vehicles never arrive, the
bandit divergence guard raises on a perturbed expectation and passes
unperturbed, and the registry's fleet selection worlds cut to K 40 match
``repro``'s fleet engine from one (JAX-drawn) init (``_torch_engines.py``;
fleet-k1000-topk within ``DEVICE_CUT_TOL``, which that file's wave test
pins)."""
from __future__ import annotations

import pytest

import repro_torch.core.jit_engine as tjit
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.selection as tsel
from _torch_engines import (DEVICE_CUT_TOL,  # noqa: F401
                            assert_corridor_conforms, init, perturbed,
                            registry_selection_pair, worlds)
from _torch_world import PARAM_TOL
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["jit"])
def test_parked_vehicles_never_arrive(worlds, engine):
    """weighted-topk k 2 never re-scores: the four parked vehicles hold no
    slot, no wave and no arrival."""
    veh, ti, tl, p = worlds[1]
    res = tmafl.run_simulation(
        veh, ti, tl, params=p, rounds=10, l_iters=1, lr=0.05,
        eval_every=10, engine=engine, device="cpu",
        selection=tsel.SelectionSpec("weighted-topk", k=2))
    admitted = {v for v, m in enumerate(res.report.selection["admit0"])
                if m}
    assert len(admitted) == 2
    assert {r.vehicle for r in res.rounds} == admitted


@pytest.mark.parametrize("which, match", [
    ("counts", "arrival counts"), ("sums", "reward accumulators")])
@pytest.mark.parametrize("engine", ["jit"])
def test_bandit_guard_raises_on_a_perturbed_expectation(monkeypatch, engine,
                                                        which, match):
    monkeypatch.setattr(tjit, "plan_fleet", perturbed(tjit.plan_fleet, which))
    with pytest.raises(RuntimeError, match=match):
        tsc.run_scenario("quick-k5", engine=engine, rounds=8,
                         selection="eps-bandit", selection_k=2,
                         selection_eps=0.3, resel_every=4, device="cpu",
                         eval_every=8)


def test_bandit_guard_passes_unperturbed():
    res = tsc.run_scenario("quick-k5", engine="jit", rounds=8, eval_every=8,
                           selection="eps-bandit", selection_k=2,
                           selection_eps=0.3, resel_every=4, device="cpu")
    assert [b for b, _, _ in res.report.selection["decisions"]] == [4]


@pytest.mark.parametrize("name, engine", [
    ("fleet-k1000-topk", "jit"), ("fleet-k1000-budget", "jit")])
def test_registry_selection_worlds_cut_to_k40(init, name, engine):
    """The registry's fleet selection worlds at their rounds with K cut to
    40 and the caps cut with it (``SELECTION_CUTS``)."""
    jres, tres = registry_selection_pair(init, name, engine)
    # rsu is None on both sides of a single-RSU world
    assert_corridor_conforms(
        jres, tres, engine,
        DEVICE_CUT_TOL if name == "fleet-k1000-topk" else PARAM_TOL)
