"""The registry's two fleet fault worlds (fleet-k1000-flaky and
-throttled) cut to K 40 on their default engine, ``batched``, against
``repro``'s from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``): the same ``extras["faults"]`` and trace, times and
weights to rtol 1e-9, params within ``PARAM_TOL``, accuracy within 0.02
(``_torch_world.py``)."""
from __future__ import annotations

import pytest

from _torch_engines import faults_fleet_pair, init  # noqa: F401
from _torch_world import assert_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name", ["fleet-k1000-flaky",
                                  "fleet-k1000-throttled"])
def test_registry_worlds_cut_to_k40(init, name):
    """The registry fleet fault worlds cut to K 40 (rounds as registered)
    on their default engine, batched."""
    cut = dict(K=40, n_train=1200, n_test=120)
    jres, tres = faults_fleet_pair(name, "batched", init, 10, **cut)
    assert_conforms(jres, tres)
    assert tres.extras["faults"] == jres.extras["faults"]
    assert tres.extras["faults"]["counts"]["discarded_uploads"] > 0
