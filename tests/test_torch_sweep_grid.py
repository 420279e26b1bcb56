"""The sweep's W = 4 grid (quick-k5, 2 betas x 2 seeds, 8 rounds) against
``repro``'s live ``run_sweep`` from the same (JAX-drawn) inits: the same
timeline groups, and every world within the fleet engine's bands
(``_torch_world.py``: trace exact, times rtol 2e-5 / atol 1e-3, params
``PARAM_TOL``, accuracy within 0.02).  The grid against the port's own
solo runs is in ``tests/test_torch_sweep_engine.py``."""
from __future__ import annotations

import repro.core.scenarios as jsc
import repro_torch.core.scenarios as tsc
from _torch_sweep import GRID, port_vmap_from_jax
from _torch_world import assert_fleet_conforms
import pytest
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_beta_seed_grid_matches_repro():
    jres = jsc.run_sweep(jsc.SweepSpec(**GRID))
    tres = port_vmap_from_jax(tsc.SweepSpec(**GRID).worlds(), eval_every=4)
    assert len(tres) == len(jres) == 4
    assert ([r.report.channels for r in tres]
            == [r.report.channels for r in jres])
    for j, t in zip(jres, tres):
        assert_fleet_conforms(j, t)
