"""The port's serial handover loop under vehicle selection against
``repro``'s, on the CPU, from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``): corridor-quick-r2-k8 with weighted-topk and
eps-bandit for 12 rounds (the same trace and ``report.selection``, times
within rtol 1e-9, params within ``PARAM_TOL``), the EMA reconcile's
``ValueError``, and the registry's bandit corridor cut to K 40."""
from __future__ import annotations

import pytest

import repro_torch.core.scenarios as tsc
from _torch_engines import (QUICK, assert_corridor_conforms,  # noqa: F401
                            corridor_pair, init, registry_selection_pair)
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["serial"])
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


@pytest.mark.parametrize("engine", ["serial"])
def test_selection_with_ema_reconcile_raises(engine):
    with pytest.raises(ValueError, match="ema"):
        tsc.run_scenario(QUICK, engine=engine, rounds=6,
                         reconcile_mode="ema", selection="weighted-topk",
                         selection_k=2, device="cpu")
    with pytest.raises(ValueError, match="ema"):
        tsc.run_scenario("corridor-r4-k400-bandit", engine=engine,
                         reconcile_mode="ema", device="cpu")


@pytest.mark.parametrize("name, engine", [
    ("corridor-r4-k400-bandit", "serial"),
])
def test_registry_selection_worlds_cut_to_k40(init, name, engine):
    """The registry's bandit corridor at its rounds with K cut to 40 and k
    5 per RSU (``SELECTION_CUTS``), so the policy still parks vehicles."""
    jres, tres = registry_selection_pair(init, name, engine)
    assert_corridor_conforms(jres, tres, engine)
