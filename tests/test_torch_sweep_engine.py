"""The sweep engine (``engine="vmap"``) on the CPU: every world of a batch
against the port's own solo ``engine="jit"`` run (bitwise where its
timeline group is a singleton, the f32 band ``PARAM_TOL`` where it shares
one: its training is then one batched call whose convolutions sum in
another order) and against a live ``repro`` run from the same (JAX-drawn)
inits, to the fleet engine's bands (``_torch_world.py``): trace exact,
times rtol 2e-5 / atol 1e-3, params ``PARAM_TOL``, accuracy within 0.02.
The host side is in ``tests/test_torch_sweep.py``, the W = 4 grid against
``repro`` in ``tests/test_torch_sweep_grid.py``, the batches of singleton
groups in ``tests/test_torch_sweep_{selection,singletons}.py`` (shared
helpers in ``tests/_torch_sweep.py``)."""
from __future__ import annotations

import dataclasses

import pytest

import repro.core.scenarios as jsc
import repro_torch.core.scenarios as tsc
from _torch_sweep import GRID, assert_band, digest, port_vmap_from_jax
from _torch_world import assert_fleet_conforms
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_one_world_batch_is_the_solo_run_and_repros():
    """``run_scenario(engine="vmap")`` is a W = 1 batch: bitwise the port's
    solo ``jit`` run, and within the bands of ``repro``'s ``vmap``."""
    kw = dict(seed=1, eval_every=4, rounds=8)
    solo = tsc.run_scenario("quick-k5", engine="jit", device="cpu", **kw)
    vm = tsc.run_scenario("quick-k5", engine="vmap", device="cpu", **kw)
    assert digest(vm) == digest(solo)
    assert (vm.report.engine, vm.report.scenario, vm.report.channels) == (
        "vmap", "quick-k5", {"world_index": 0, "n_worlds": 1, "group": 0})
    assert set(vm.report.phases) >= {"plan", "stage", "run", "eval"}
    assert vm.report.waves == solo.report.waves
    jres = jsc.run_scenario("quick-k5", engine="vmap", **kw)
    sc = dataclasses.replace(tsc.get_scenario("quick-k5"), rounds=8)
    (tres,) = port_vmap_from_jax([(sc, 1)], eval_every=4)
    assert_fleet_conforms(jres, tres)
    assert tres.report.channels == jres.report.channels


def test_beta_seed_grid_matches_the_ports_solo_runs():
    """W = 4 (2 betas x 2 seeds, 8 rounds): each seed's two betas share a
    timeline group, as in ``repro`` (``tests/test_torch_sweep_grid.py``
    holds the groups and the worlds to ``repro``'s); every world against
    the port's ``run_sweep(engine="jit")``, in variant-major order, with
    ``progress`` after the run."""
    spec = tsc.SweepSpec(**GRID)
    progress = []
    vm = tsc.run_sweep(spec, device="cpu",
                       progress=lambda *a: progress.append(a))
    solo = tsc.run_sweep(spec, engine="jit", device="cpu")
    assert len(vm) == len(solo) == 4
    assert progress == [(w, rr, acc) for w, res in enumerate(vm)
                        for rr, acc in res.acc_history]
    groups = [r.report.channels["group"] for r in vm]
    assert groups[0] == groups[2] != groups[1] == groups[3]
    for w, (v, s) in enumerate(zip(vm, solo)):
        assert v.report.channels["world_index"] == w
        assert v.report.channels["n_worlds"] == 4
        assert v.report.scenario == "quick-k5"
        assert_band(v, s)


@pytest.mark.slow
def test_paper_k10_grid_matches_repro():
    """The Fig. 5-shaped grid on paper-k10 (2 betas x 2 seeds, cut to 8
    rounds of 2 local steps)."""
    kw = dict(scenario="paper-k10", seeds=(0, 1),
              variants=tuple((("channel_overrides", (("beta", b),)),)
                             for b in (0.1, 0.9)),
              overrides=(("rounds", 8), ("l_iters", 2)), eval_every=4)
    spec = tsc.SweepSpec(**kw)
    for v, s in zip(tsc.run_sweep(spec, device="cpu"),
                    tsc.run_sweep(spec, engine="jit", device="cpu")):
        assert_band(v, s)
    for j, t in zip(jsc.run_sweep(jsc.SweepSpec(**kw)),
                    port_vmap_from_jax(spec.worlds(), 4)):
        assert_fleet_conforms(j, t)


@pytest.mark.slow
def test_fleet_k100_grid_matches_repro():
    kw = dict(scenario="fleet-k100", seeds=(0, 1),
              overrides=(("rounds", 10), ("l_iters", 1)), eval_every=5)
    spec = tsc.SweepSpec(**kw)
    for v, s in zip(tsc.run_sweep(spec, device="cpu"),
                    tsc.run_sweep(spec, engine="jit", device="cpu")):
        assert digest(v) == digest(s)
    for j, t in zip(jsc.run_sweep(jsc.SweepSpec(**kw)),
                    port_vmap_from_jax(spec.worlds(), 5)):
        assert_fleet_conforms(j, t)
