"""The port's corridor engine (``engine="corridor"``) under fault injection
against ``repro``'s, on the CPU, from one (JAX-drawn) init with the kernel
path on (``_torch_engines.py``): corridor-quick-r2-k8 with ``repro``'s
HEAVY spec for 24 rounds of 2 local steps and the registry's dead-zone
corridor cut to K 40 (``extras["faults"]`` equal to ``repro``'s, the same
(round, vehicle, rsu) trace, times within the f32 band, params within
``PARAM_TOL``), and faults off bitwise the run without faults.  The serial
handover loop's cases are in ``test_torch_faults_handover.py``."""
from __future__ import annotations

import pytest

from _torch_engines import (HEAVY, assert_corridor_conforms,  # noqa: F401
                            assert_faults_off, corridor_pair, init)
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("engine", ["corridor"])
def test_corridor_engines_under_heavy_churn(init, engine):
    """corridor-quick-r2-k8 with ``repro``'s HEAVY spec, 24 rounds of 2
    local steps: dropouts, blackouts, recoveries at the reconcile
    boundaries, partial cycles, cap discards and stragglers."""
    cut = dict(rounds=24, l_iters=2, faults="flaky",
               faults_overrides=tuple(HEAVY.items()))
    jres, tres = corridor_pair("corridor-quick-r2-k8", engine, init, 8,
                               **cut)
    summary = tres.extras["faults"]
    assert summary == jres.extras["faults"]
    c = summary["counts"]
    assert summary["readmits"] and c["partial_rounds"] and \
        c["discarded_uploads"] and summary["n_stragglers"]
    assert_corridor_conforms(jres, tres, engine)


@pytest.mark.parametrize("name", ["corridor-rush-hour-deadzone-r8-k4000"])
def test_registry_worlds_cut_to_k40(init, name):
    """The registry's dead-zone corridor cut to K 40 (rounds as
    registered) on its default engine, the corridor engine."""
    cut = dict(K=40, n_train=1200, n_test=120)
    jres, tres = corridor_pair(name, "corridor", init, 10, **cut)
    assert_corridor_conforms(jres, tres, "corridor")
    assert tres.extras["faults"] == jres.extras["faults"]
    assert tres.extras["faults"]["counts"]["discarded_uploads"] > 0


@pytest.mark.parametrize("name, engine", [("corridor-quick-r2-k8",
                                           "corridor")])
def test_faults_off_is_bitwise_the_run_without_faults(name, engine):
    """Every off spelling runs the path without faults: the same trace,
    bitwise the same params, no fault summary."""
    assert_faults_off(name, engine)
