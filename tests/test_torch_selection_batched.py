"""The port's batched engine under vehicle selection against ``repro``'s,
on the CPU, from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``).

- a K 6 world for the three specs of ``repro``'s own cross-engine
  selection test: the same trace, the same ``report.selection`` as
  ``repro``'s, and times and params within ``_torch_world.py``'s bands
  (times to rtol 1e-9);
- parked vehicles never arrive.

The registry's fleet selection worlds cut to K 40 on this engine are in
``test_torch_selection_batched_registry.py``."""
from __future__ import annotations

import pytest

import repro_torch.core.mafl as tmafl
import repro_torch.selection as tsel
from _torch_engines import (SPECS, init, selection_fleet_pair,  # noqa: F401
                            worlds)
from _torch_world import assert_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["batched"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["policy"])
def test_engines_conform_under_selection(init, worlds, spec, engine):
    jres, tres = selection_fleet_pair(worlds, init, engine, spec)
    assert tres.report.selection == jres.report.selection
    # the policy parked somebody (the world is bigger than k)
    assert not all(tres.report.selection["admit0"])
    assert_conforms(jres, tres)


@pytest.mark.parametrize("engine", ["batched"])
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
