"""The port's batched engine under fault injection against ``repro``'s, on
the CPU, from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``).

- ``extras["faults"]`` equals ``repro``'s exactly and the (round, vehicle)
  traces are identical; times and weights to rtol 1e-9, params within
  ``PARAM_TOL``, accuracy within 0.02 (``_torch_world.py``).
- Worlds: paper-k10 with ``throttled`` cut to 10 rounds (partial
  computation and the staleness cap both live; the test says why 10),
  fleet-k100 with ``flaky`` cut to 20 rounds and 2 local steps
  (``repro``'s own replay-conformance world: drops, a blackout, recovery
  sweeps, cap discards); the two registry fleet fault worlds cut to K 40
  are in ``test_torch_faults_batched_registry.py``.
- Faults off is bitwise the run without faults."""
from __future__ import annotations

import pytest

from _torch_engines import (assert_faults_off,  # noqa: F401
                            faults_fleet_pair, init)
from _torch_world import assert_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["batched"])
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


@pytest.mark.parametrize("engine", ["batched"])
def test_fleet_k100_flaky_conforms(init, engine):
    """``repro``'s own replay-conformance world (fleet-k100, flaky, 20
    rounds, 2 local steps): drops, a blackout, two recovery sweeps and
    cap discards, on the batched engine."""
    jres, tres = faults_fleet_pair("fleet-k100", engine, init, 10, rounds=20,
                                   l_iters=2, faults="flaky")
    summary = tres.extras["faults"]
    assert summary == jres.extras["faults"]
    assert summary["readmits"] and summary["counts"]["discarded_uploads"]
    assert_conforms(jres, tres)


@pytest.mark.parametrize("name, engine", [("quick-k5", "batched")])
def test_faults_off_is_bitwise_the_run_without_faults(name, engine):
    """Every off spelling runs the path without faults: the same trace,
    bitwise the same params, no fault summary."""
    assert_faults_off(name, engine)
