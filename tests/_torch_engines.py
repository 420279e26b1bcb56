"""Shared by the port's engine tests that are split by engine group (host
engines, ``jit``, the corridor engines): ``test_torch_{selection,faults,
telemetry,pytree}_*.py``.  The worlds, the run pairs against ``repro`` from one
(JAX-drawn) init with the kernel path on, and the comparisons; tolerances
are ``_torch_world.py``'s.  A fixture imported from here into a test
module is that module's fixture."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.data as jdata
import repro.faults as jfaults
import repro.selection as jsel
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.data as tdata
import repro_torch.faults as tfaults
import repro_torch.selection as tsel
from _torch_world import (ACC_TOL, FLEET_TIME_TOL, FLEET_WEIGHT_TOL,
                          PARAM_TOL, jax_init)
from repro.channel import ChannelParams as JParams
from repro_torch.channel import ChannelParams as TParams
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.corridor import (run_corridor_simulation,
                                  run_handover_simulation)
from repro_torch.telemetry import MetricsSpec

QUICK = "corridor-quick-r2-k8"


@pytest.fixture(scope="module")
def init():
    """repro's CNN init as numpy leaves, drawn once per module."""
    return jax_init()


def digest(res):
    """Everything a run computes, bitwise: trace, params, accuracy."""
    return ([(r.round, r.vehicle, r.time, r.upload_delay, r.train_delay,
              r.weight, r.rsu) for r in res.rounds],
            {k: v.numpy().tobytes() for k, v in res.final_params.items()},
            res.acc_history, res.loss_history)


# ---------------------------------------------------------------------------
# corridor worlds (selection, faults)
# ---------------------------------------------------------------------------
def corridor_pair(name, engine, init, eval_every, **cut):
    """A corridor world cut by ``cut`` (Scenario fields) on ``engine`` in
    both packages; the port runs the world's own selection and faults."""
    jres = jsc.run_scenario(name, engine=engine, eval_every=eval_every,
                            use_kernel=True, **cut)
    sc = dataclasses.replace(tsc.get_scenario(name), **cut)
    veh, ti, tl, p = tsc.build_world(sc)
    run = (run_handover_simulation if engine == "serial"
           else run_corridor_simulation)
    tres = run(sc, veh, ti, tl, p, eval_every=eval_every, use_kernel=True,
               init_params=params_from_jax(init, "cpu"), device="cpu",
               faults=tfaults.scenario_faults(sc))
    return jres, tres


def assert_corridor_conforms(jres, tres, engine, param_tol=PARAM_TOL):
    """Same (round, vehicle, rsu) trace and selection summary; times and
    weights to rtol 1e-9 on the serial loop, the f32 band on a device
    engine; params within ``param_tol``, accuracy within 0.02."""
    assert ([(r.round, r.vehicle, r.rsu) for r in tres.rounds]
            == [(r.round, r.vehicle, r.rsu) for r in jres.rounds])
    assert tres.report.selection == jres.report.selection
    time_tol = dict(rtol=1e-9) if engine == "serial" else FLEET_TIME_TOL
    weight_tol = dict(rtol=1e-9) if engine == "serial" else FLEET_WEIGHT_TOL
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay],
            [a.time, a.upload_delay, a.train_delay], **time_tol)
        np.testing.assert_allclose(b.weight, a.weight, **weight_tol)
    tnp = params_to_numpy(tres.final_params)
    for k, v in jres.final_params.items():
        np.testing.assert_allclose(tnp[k], np.asarray(v), err_msg=k,
                                   **param_tol)
    assert [r for r, _ in jres.acc_history] == [r for r, _ in
                                                tres.acc_history]
    for (_, a), (_, b) in zip(jres.acc_history, tres.acc_history):
        assert abs(a - b) <= ACC_TOL and np.isfinite(b)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------
# fleet-k1000-topk cut to K 40 on the fleet engine: one upload (round 12's
# wave) crosses a ReLU kink.  One conv2 pre-activation of its first step is
# 7.9e-8 in f64; XLA's f32 conv gives +7.2e-8, torch's -2.4e-9, both within
# their usual 1e-6 of f64.  The upload then differs from repro's by 3.9e-5
# and the final params by 1.7e-4.  On the same inputs the port's wave step
# equals its own host step to 1.5e-8, so the fleet engine computes what the
# host engines compute; the batched engine, whose payloads are other f32
# roundings of the same models, stays within PARAM_TOL on this cut.
# test_fleet_waves_train_as_repro_on_the_same_inputs pins this reading.  The
# cut is held to repro's own engine-pair band for the real CNN
# (tests/test_engine_conformance.py, as in test_torch_corridor.py); every
# other cut keeps PARAM_TOL.
DEVICE_CUT_TOL = dict(rtol=0.0, atol=2e-3)
SPECS = [dict(policy="weighted-topk", k=3),
         dict(policy="budget", budget=0.008),
         dict(policy="eps-bandit", k=2, eps=0.3, resel_every=4)]
# the registry's selection worlds cut to K 40, with the caps cut with it
# (k 5 per RSU; 0.005 s of airtime per cycle), so the policies still park
# vehicles
SELECTION_CUTS = {"fleet-k1000-topk": dict(selection_k=5),
                  "fleet-k1000-budget": dict(selection_budget=0.005),
                  "corridor-r4-k400-bandit": dict(selection_k=5)}


@pytest.fixture(scope="module")
def worlds():
    """``repro``'s selection-test world (K 6) in both packages."""
    out = []
    for data, params in ((jdata, JParams), (tdata, TParams)):
        tr_i, tr_l, te_i, te_l = data.synth_mnist(n_train=600, n_test=120,
                                                  seed=0, noise=0.35)
        p = dataclasses.replace(params(), K=6)
        veh = data.partition_vehicles(tr_i, tr_l, p, seed=0, scale=0.012)
        out.append((veh, te_i, te_l, p))
    return out


def selection_fleet_pair(worlds, init, engine, spec, rounds=10):
    (jveh, jti, jtl, jp), (tveh, tti, ttl, tp) = worlds
    common = dict(scheme="mafl", rounds=rounds, l_iters=1, lr=0.05,
                  eval_every=5, seed=0, engine=engine, use_kernel=True)
    jres = jmafl.run_simulation(
        jveh, jti, jtl, params=jp, selection=jsel.SelectionSpec(**spec),
        init_params={k: jnp.asarray(v) for k, v in init.items()}, **common)
    tres = tmafl.run_simulation(
        tveh, tti, ttl, params=tp, selection=tsel.SelectionSpec(**spec),
        init_params=params_from_jax(init, "cpu"), device="cpu", **common)
    return jres, tres


def registry_selection_pair(init, name, engine):
    """A registry selection world cut to K 40 (``SELECTION_CUTS``), run
    through the entry point ``run_scenario`` calls, in both packages from
    one init."""
    overrides = dict(K=40, **SELECTION_CUTS[name])
    jsc_ = dataclasses.replace(jsc.get_scenario(name), **overrides)
    tsc_ = dataclasses.replace(tsc.get_scenario(name), **overrides)
    jveh, jti, jtl, jp = jsc.build_world(jsc_)
    tveh, tti, ttl, tp = tsc.build_world(tsc_)
    jinit = {k: jnp.asarray(v) for k, v in init.items()}
    tinit = params_from_jax(init, "cpu")
    if tsc_.n_rsus > 1:
        from repro.corridor.engine import run_corridor_simulation as jcor
        from repro.corridor.reference import run_handover_simulation as jser
        if engine == "serial":
            jres = jser(jsc_, jveh, jti, jtl, jp, eval_every=10,
                        use_kernel=True)
            tres = run_handover_simulation(
                tsc_, tveh, tti, ttl, tp, eval_every=10, use_kernel=True,
                selection=tsc_.selection_spec(), init_params=tinit,
                device="cpu")
        else:
            jres = jcor(jsc_, jveh, jti, jtl, jp, eval_every=10,
                        use_kernel=True)
            tres = run_corridor_simulation(
                tsc_, tveh, tti, ttl, tp, eval_every=10, use_kernel=True,
                selection=tsc_.selection_spec(), init_params=tinit,
                device="cpu")
        return jres, tres
    common = dict(scheme=tsc_.scheme, rounds=tsc_.rounds,
                  l_iters=tsc_.l_iters, lr=tsc_.lr, seed=0, eval_every=10,
                  engine=engine, use_kernel=True)
    jres = jmafl.run_simulation(jveh, jti, jtl, params=jp,
                                selection=jsc_.selection_spec(),
                                init_params=jinit, **common)
    tres = tmafl.run_simulation(tveh, tti, ttl, params=tp,
                                selection=tsc_.selection_spec(),
                                init_params=tinit, device="cpu", **common)
    summary = tres.report.selection
    assert summary == jres.report.selection
    assert not all(summary["admit0"])
    return jres, tres


def perturbed(planner, which):
    """``planner`` with its bandit expectation moved: one more arrival
    (``"counts"``) or a 1% larger reward sum (``"sums"``)."""
    def plan(*a, **kw):
        out = planner(*a, **kw)
        rs, rc = (x.copy() for x in out.sel_bandit)
        v = int(np.argmax(rc))
        if which == "counts":
            rc[v] += 1.0
        else:
            rs[v] = rs[v] * 1.01 + 1e-2
        out.sel_bandit = (rs, rc)
        return out
    return plan


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------
HEAVY = dict(p_dropout=0.25, p_blackout=0.15, blackout_mean=20.0,
             p_partial=0.5, straggler_frac=0.4, straggler_mult=3.0,
             staleness_cap=6, recheck_every=2)


def faults_fleet_pair(name, engine, init, eval_every, **cut):
    """One single-RSU world through ``repro``'s and the port's
    ``run_simulation`` on ``engine`` from one init, the world's own fault
    profile (with ``faults`` / ``faults_overrides`` in ``cut``)."""
    jw = dataclasses.replace(jsc.get_scenario(name), **cut)
    tw = dataclasses.replace(tsc.get_scenario(name), **cut)
    jveh, jti, jtl, jp = jsc.build_world(jw)
    tveh, tti, ttl, tp = tsc.build_world(tw)
    common = dict(scheme=tw.scheme, rounds=tw.rounds, l_iters=tw.l_iters,
                  lr=tw.lr, seed=0, eval_every=eval_every, engine=engine,
                  use_kernel=True)
    jres = jmafl.run_simulation(
        jveh, jti, jtl, params=jp, faults=jfaults.scenario_faults(jw),
        init_params={k: jnp.asarray(v) for k, v in init.items()}, **common)
    tres = tmafl.run_simulation(
        tveh, tti, ttl, params=tp, faults=tfaults.scenario_faults(tw),
        init_params=params_from_jax(init, "cpu"), device="cpu", **common)
    return jres, tres


def run_faults_off(name, engine, faults):
    """Six rounds of a world on the port with ``faults`` (an off spelling
    or None)."""
    sc = dataclasses.replace(tsc.get_scenario(name), rounds=6)
    veh, ti, tl, p = tsc.build_world(sc)
    if sc.n_rsus > 1:
        run = (run_handover_simulation if engine == "serial"
               else run_corridor_simulation)
        return run(sc, veh, ti, tl, p, eval_every=3, device="cpu",
                   faults=faults)
    return tmafl.run_simulation(veh, ti, tl, scheme=sc.scheme, rounds=6,
                                l_iters=sc.l_iters, lr=sc.lr, params=p,
                                eval_every=3, engine=engine, device="cpu",
                                faults=faults)


def assert_faults_off(name, engine):
    """Every faults-off spelling runs the path without faults: bitwise the
    same run, no fault summary."""
    base = digest(run_faults_off(name, engine, None))
    for off in ("off", tfaults.FaultSpec(straggler_frac=0.5)):
        res = run_faults_off(name, engine, off)
        assert digest(res) == base
        assert "faults" not in res.extras and res.report.faults is None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
# every spelling of metrics off, and the pop wait's band: f32 on the device
# engines, the divergence guard's tolerance (repro's own)
OFF = [None, False, "off", MetricsSpec(enabled=False)]
GAP_TOL = dict(rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the device engines' pytree programs (flat=False)
# ---------------------------------------------------------------------------
# The pytree tests cut each world's minibatch to 16 images (the runs they
# compare merge the same uploads whatever the batch) and run torch on one
# intra-op thread: with the suite's six pytest workers on eight cores,
# torch's default of one thread per core made each of their runs 20-45x
# slower than alone.
PYTREE_BATCH = 16


# repro's HEAVY fault spec with the staleness cap cut from 6 to 3, so that
# quick-k5's five vehicles see discards on the fleet engine; with 3 local
# steps 12 rounds give 5 dropped uploads, 3 partial rounds and 5 discards
CAPPED = tfaults.FaultSpec(**{**HEAVY, "staleness_cap": 3})


def fleet_run(name, flat, init=None, **kw):
    """A single-RSU world on the port's fleet engine, on the CPU, from
    ``repro``'s init (``init``) or the port's own, at ``PYTREE_BATCH``;
    ``kw`` are Scenario fields and run options (``selection``, ``faults``,
    ``metrics``, ``use_kernel``, ``interpretation``)."""
    run_kw = {k: kw.pop(k) for k in ("selection", "faults", "metrics",
                                     "use_kernel", "interpretation",
                                     "eval_every") if k in kw}
    sc = dataclasses.replace(tsc.get_scenario(name), **kw)
    veh, ti, tl, p = tsc.build_world(sc)
    return tmafl.run_simulation(
        veh, ti, tl, scheme=sc.scheme, rounds=sc.rounds,
        l_iters=sc.l_iters, lr=sc.lr, params=p, engine="jit", flat=flat,
        device="cpu", batch_size=PYTREE_BATCH,
        init_params=(None if init is None
                     else params_from_jax(init, "cpu")),
        **{"eval_every": 4, **run_kw})


def corridor_run(name, flat, init=None, package=None, **kw):
    """A multi-RSU world on the port's corridor engine (or, with
    ``package="repro"``, on ``repro``'s, from its own init, equal to
    ``init``), on the CPU, at ``PYTREE_BATCH``; ``kw`` as
    :func:`fleet_run`, plus ``record_cohorts``."""
    run_kw = {k: kw.pop(k) for k in ("selection", "faults", "metrics",
                                     "use_kernel", "interpretation",
                                     "eval_every", "record_cohorts")
              if k in kw}
    run_kw = {"eval_every": 4, "batch_size": PYTREE_BATCH, **run_kw}
    if package == "repro":
        from repro.corridor.engine import run_corridor_simulation as jrun
        sc = dataclasses.replace(jsc.get_scenario(name), **kw)
        return jrun(sc, *jsc.build_world(sc), flat=flat, **run_kw)
    sc = dataclasses.replace(tsc.get_scenario(name), **kw)
    veh, ti, tl, p = tsc.build_world(sc)
    return run_corridor_simulation(
        sc, veh, ti, tl, p, flat=flat, device="cpu",
        init_params=(None if init is None
                     else params_from_jax(init, "cpu")), **run_kw)


def leaves_equal(a: dict, b: dict) -> bool:
    """Two param dicts bit for bit."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in a)


def assert_pytree_is_flat(flat, tree, bitwise=True):
    """The pytree program against the port's flat program on one world:
    the same trace bit for bit (the slot queue is shared), params, every
    eval's accuracy and loss, the cohort stacks and the telemetry channels
    bitwise (both round each product and sum of a merge alone); under
    ``use_kernel`` (``bitwise=False``) K2's device form forms ``1 - (1 -
    alpha)`` where the flat chain uses ``alpha``, an f32 ulp of a mix
    coefficient, so params are held to ``PARAM_TOL`` and accuracy to
    ``ACC_TOL`` there."""
    fd, td = digest(flat), digest(tree)
    assert td[0] == fd[0]
    assert tree.report.selection == flat.report.selection
    assert tree.extras.get("faults") == flat.extras.get("faults")
    assert flat.report.channels.keys() == tree.report.channels.keys()
    for k, v in flat.report.channels.items():
        np.testing.assert_array_equal(tree.report.channels[k], v,
                                      err_msg=k)
    if bitwise:
        assert td[1:] == fd[1:]
        for key in ("final_cohorts",):
            if key in flat.extras:
                assert leaves_equal(flat.extras[key], tree.extras[key])
        for a, b in zip(flat.extras.get("cohort_snapshots", ()),
                        tree.extras.get("cohort_snapshots", ())):
            assert leaves_equal(a, b)
        return
    for k, v in flat.final_params.items():
        np.testing.assert_allclose(tree.final_params[k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)
    assert [r for r, _ in tree.acc_history] == [r for r, _ in
                                                flat.acc_history]
    for (_, a), (_, b) in zip(flat.acc_history, tree.acc_history):
        assert abs(a - b) <= ACC_TOL
