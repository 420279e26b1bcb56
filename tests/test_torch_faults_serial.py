"""The port's serial engine under fault injection against ``repro``'s, on
the CPU, from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``): paper-k10 with ``throttled`` cut to 10 rounds
(partial computation and the staleness cap both live; the test says why
10), the same ``extras["faults"]`` and trace as ``repro``'s, times and
weights to rtol 1e-9, params within ``PARAM_TOL``, accuracy within 0.02
(``_torch_world.py``); and faults off bitwise the run without faults."""
from __future__ import annotations

import pytest

from _torch_engines import (assert_faults_off,  # noqa: F401
                            faults_fleet_pair, init)
from _torch_world import assert_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["serial"])
def test_host_engines_under_partial_and_cap(init, engine):
    """paper-k10 with ``throttled`` for 10 rounds: four partial cycles and
    a cap-discarded arrival on both host engines.  Not more rounds: this
    world amplifies f32 rounding fast — on ``repro`` alone, scaling the
    init by (1 + 2^-22) moves the final params by 4.4e-5 at 12 rounds and
    3.1e-4 at 14, so past 10 rounds no run of either package stays within
    ``PARAM_TOL`` of another whose convolutions sum in another order."""
    jres, tres = faults_fleet_pair("paper-k10", engine, init, 5,
                                   rounds=10, faults="throttled")
    assert tres.extras["faults"] == jres.extras["faults"]
    counts = tres.extras["faults"]["counts"]
    assert counts["partial_rounds"] > 0 and counts["discarded_uploads"] > 0
    assert_conforms(jres, tres)


@pytest.mark.parametrize("name, engine", [("quick-k5", "serial")])
def test_faults_off_is_bitwise_the_run_without_faults(name, engine):
    """Every off spelling runs the path without faults: the same trace,
    bitwise the same params, no fault summary."""
    assert_faults_off(name, engine)
