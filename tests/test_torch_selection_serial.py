"""The port's serial engine under vehicle selection against ``repro``'s,
on the CPU, from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``): a K 6 world for the three specs of ``repro``'s own
cross-engine selection test, the same trace, the same ``report.selection``
as ``repro``'s, and times and params within ``_torch_world.py``'s bands
(times to rtol 1e-9)."""
from __future__ import annotations

import pytest

from _torch_engines import SPECS, init, selection_fleet_pair, worlds  # noqa: F401
from _torch_world import assert_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["serial"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["policy"])
def test_engines_conform_under_selection(init, worlds, spec, engine):
    jres, tres = selection_fleet_pair(worlds, init, engine, spec)
    assert tres.report.selection == jres.report.selection
    # the policy parked somebody (the world is bigger than k)
    assert not all(tres.report.selection["admit0"])
    assert_conforms(jres, tres)
