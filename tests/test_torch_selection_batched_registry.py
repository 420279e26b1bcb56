"""The registry's fleet selection worlds (fleet-k1000-topk and -budget)
at their rounds with K cut to 40 and the caps cut with it
(``SELECTION_CUTS``) on ``batched``, against ``repro``'s from one
(JAX-drawn) init with the kernel path on (``_torch_engines.py``): the same
trace and ``report.selection``, times to rtol 1e-9, params within
``PARAM_TOL``."""
from __future__ import annotations

import pytest

from _torch_engines import init, registry_selection_pair  # noqa: F401
from _torch_world import assert_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name, engine", [
    ("fleet-k1000-topk", "batched"), ("fleet-k1000-budget", "batched")])
def test_registry_selection_worlds_cut_to_k40(init, name, engine):
    """The registry's fleet selection worlds at their rounds with K cut to
    40 and the caps cut with it (``SELECTION_CUTS``), so the policies
    still park vehicles."""
    jres, tres = registry_selection_pair(init, name, engine)
    assert_conforms(jres, tres)
