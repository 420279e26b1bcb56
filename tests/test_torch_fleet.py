"""The device fleet engine (``engine="jit"``) on the CPU: its host plan
against ``repro.core.jit_engine.plan_fleet`` (exact), and whole runs
against ``repro``'s ``engine="jit"`` from the same (JAX-drawn) init, with
the kernel path on (the port's chains take the plain version on CPU
tensors; repro's the Pallas kernel in interpret mode).  Tolerances are
stated in ``_torch_world.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core.jit_engine as jjit
import repro_torch.core.jit_engine as tjit
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
from _torch_world import (FLEET_TIME_TOL, PARAM_TOL, assert_fleet_conforms,
                          jax_init, run_both)
from repro_torch.convert import params_from_jax
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PLAN_ARRAYS = ("veh", "cycle", "dl_round", "times", "train_delay",
               "upload_delay", "download_time")


@pytest.fixture(scope="module")
def init():
    return jax_init()


@pytest.mark.parametrize("name", ["fleet-k1000", "fleet-k10000",
                                  "platoon-burst-k500"])
def test_plan_fleet_equals_repro(name):
    sc = tsc.get_scenario(name)
    p = sc.channel()
    tp = tjit.plan_fleet(p, 0, sc.rounds, l_iters=sc.l_iters)
    jp = jjit.plan_fleet(p, 0, sc.rounds, l_iters=sc.l_iters)
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert tp.waves == jp.waves and tp.n_slots == jp.n_slots
    assert tp.q0.keys() == jp.q0.keys()
    for k in tp.q0:
        np.testing.assert_array_equal(tp.q0[k], jp.q0[k], err_msg=k)
    # one ring_agg chain per non-empty checkpoint interval at eval_every=10
    need = tjit.needed_rounds(tp, tjit.eval_rounds_of(sc.rounds, 10))
    chains = sum(len(tjit.chain_bounds(s, e, need)) for _, s, e in tp.waves)
    assert chains == {"fleet-k1000": 8, "fleet-k10000": 12,
                      "platoon-burst-k500": 19}[name]


@pytest.mark.parametrize("name, rounds, kw", [
    ("quick-k5", 6, {}),
    ("paper-k10", 8, {}),
    ("quick-k5", 6, {"ring_dtype": "bf16"}),
    ("quick-k5", 6, {"scheme": "afl"}),
    ("quick-k5", 6, {"scheme": "fedasync"}),
    ("quick-k5", 6, {"interpretation": "literal"}),
], ids=["quick-k5", "paper-k10", "quick-k5-bf16", "quick-k5-afl",
        "quick-k5-fedasync", "quick-k5-literal"])
def test_jit_matches_repro_jit(init, name, rounds, kw):
    jres, tres = run_both(name, init, rounds=rounds, engine="jit", **kw)
    assert len(tres.rounds) == rounds
    assert ((tres.report.engine, tres.report.waves, tres.report.metrics_on)
            == (jres.report.engine, jres.report.waves, False))
    assert_fleet_conforms(jres, tres, bf16=kw.get("ring_dtype") == "bf16")


def test_jit_matches_serial_in_the_port(init):
    """Same world, the port's fleet engine against its serial engine: the
    same (round, vehicle) trace, times in the f32 band, params to f32
    tolerance."""
    sc = tsc.get_scenario("quick-k5")
    veh, ti, tl, p = tsc.build_world(sc)
    kw = dict(scheme=sc.scheme, rounds=6, l_iters=sc.l_iters, lr=sc.lr,
              params=p, eval_every=3, device="cpu")
    ser = tmafl.run_simulation(veh, ti, tl, engine="serial",
                               init_params=params_from_jax(init, "cpu"), **kw)
    jit = tmafl.run_simulation(veh, ti, tl, engine="jit",
                               init_params=params_from_jax(init, "cpu"), **kw)
    assert ([(r.round, r.vehicle) for r in ser.rounds]
            == [(r.round, r.vehicle) for r in jit.rounds])
    np.testing.assert_allclose([r.time for r in jit.rounds],
                               [r.time for r in ser.rounds], **FLEET_TIME_TOL)
    for k in ser.final_params:
        np.testing.assert_allclose(jit.final_params[k].numpy(),
                                   ser.final_params[k].numpy(), err_msg=k,
                                   **PARAM_TOL)
    assert [r for r, _ in jit.acc_history] == [3, 6]


def test_chains_follow_the_plan(monkeypatch):
    """Every aggregation goes through ``ring_agg``, one call per non-empty
    checkpoint interval of the plan, with bf16 rows under a bf16 ring."""
    calls = []
    real = tjit.agg_ops.ring_agg

    def spy(g, locs, coeffs):
        calls.append((locs.shape[0], locs.dtype))
        return real(g, locs, coeffs)

    monkeypatch.setattr(tjit.agg_ops, "ring_agg", spy)
    res = tsc.run_scenario("quick-k5", rounds=7, eval_every=3,
                           ring_dtype="bf16", device="cpu")
    sc = tsc.get_scenario("quick-k5")
    plan = tjit.plan_fleet(sc.channel(), 0, 7)
    need = tjit.needed_rounds(plan, (3, 6, 7))
    bounds = [b for _, s, e in plan.waves
              for b in tjit.chain_bounds(s, e, need)]
    assert len(calls) == len(bounds) and sum(u for u, _ in calls) == 7
    assert {dt for _, dt in calls} == {torch.bfloat16}
    assert [r for r, _ in res.acc_history] == [3, 6, 7]
    assert all(torch.isfinite(v).all() for v in res.final_params.values())


def test_run_scenario_selects_jit_for_a_bf16_world(monkeypatch):
    seen = {}

    def fake(*a, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(tjit, "run_simulation_jit", fake)
    with pytest.raises(RuntimeError, match="stop"):
        tsc.run_scenario("quick-k5", ring_dtype="bf16", rounds=2,
                         device="cpu")
    assert seen["ring_dtype"] == "bf16" and seen["flat"] is True
    with pytest.raises(ValueError, match="flat fast path"):
        tsc.run_scenario("quick-k5", ring_dtype="bf16", engine="batched",
                         device="cpu")


@pytest.mark.parametrize("kw, err, match", [
    (dict(scheme="fedbuff"), ValueError, "fedbuff"),
    (dict(ring_dtype="f16"), ValueError, "ring_dtype"),
    (dict(flat=False, ring_dtype="bf16"), ValueError, "flat fast path"),
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(metrics="sometimes"), ValueError, "unknown metrics setting"),
    (dict(faults="no-such-profile"), KeyError, "unknown fault profile"),
])
def test_run_simulation_jit_rejects(kw, err, match):
    sc = tsc.get_scenario("quick-k5")
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(err, match=match):
        tjit.run_simulation_jit(veh, ti, tl, params=p, rounds=2,
                                device="cpu", **kw)


def test_run_simulation_jit_runs_a_selection_policy():
    """The call that raised before selection was ported: a policy name
    runs with its default spec and reports the plan's summary."""
    from repro_torch.selection import SelectionSpec
    sc = tsc.get_scenario("quick-k5")
    veh, ti, tl, p = tsc.build_world(sc)
    res = tjit.run_simulation_jit(veh, ti, tl, params=p, rounds=2,
                                  device="cpu", selection="admit-all")
    assert len(res.rounds) == 2
    assert res.report.selection == tjit.plan_fleet(
        p, 0, 2, SelectionSpec()).sel.summary()
    assert res.report.selection["admit0"] == [True] * 5
