"""The port's five engines under vehicle selection against ``repro``'s same
engine, on the CPU, from one (JAX-drawn) init with the kernel path on.

- ``serial``, ``batched`` and ``jit`` on a K 6 world for the three specs
  of ``repro``'s own cross-engine selection test: the same trace, the same
  ``extras["selection"]`` as ``repro``'s ``report.selection``, and times
  and params within ``_torch_world.py``'s bands (host engines: times to
  rtol 1e-9; the fleet engine: the f32 band);
- a bandit world whose re-admission falls between two pops of one segment;
- ``corridor`` and ``serial`` on corridor-quick-r2-k8 with weighted-topk
  and eps-bandit for 12 rounds;
- the EMA reconcile's ``ValueError``, parked vehicles, the bandit
  divergence guard, and the registry's selection worlds cut to K 40."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn.functional as F

import repro.core.client as jclient
import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.data as jdata
import repro.models.cnn as jcnn
import repro.selection as jsel
import repro_torch.core.client as tclient
import repro_torch.core.jit_engine as tjit
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.corridor.engine as tengine
import repro_torch.data as tdata
import repro_torch.models.cnn as tcnn
import repro_torch.selection as tsel
from _torch_world import (ACC_TOL, FLEET_TIME_TOL, FLEET_WEIGHT_TOL,
                          PARAM_TOL, assert_conforms, assert_fleet_conforms,
                          jax_init)
from repro.channel import ChannelParams as JParams
from repro_torch.channel import ChannelParams as TParams
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.corridor import (run_corridor_simulation,
                                  run_handover_simulation)

QUICK = "corridor-quick-r2-k8"
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


@pytest.fixture(scope="module")
def init():
    return jax_init()


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


def _fleet_pair(worlds, init, engine, spec, rounds=10):
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


@pytest.mark.parametrize("engine", ["serial", "batched", "jit"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["policy"])
def test_engines_conform_under_selection(init, worlds, spec, engine):
    jres, tres = _fleet_pair(worlds, init, engine, spec)
    assert tres.extras["selection"] == jres.report.selection
    # the policy parked somebody (the world is bigger than k)
    assert not all(tres.extras["selection"]["admit0"])
    if engine == "jit":
        assert_fleet_conforms(jres, tres)
    else:
        assert_conforms(jres, tres)


def test_readmission_lands_between_two_pops_of_a_segment(init, worlds,
                                                         monkeypatch):
    """eps-bandit k 3 re-scored every 3 rounds: the re-admission of round 6
    falls inside the segment [3, 9).  It is written after pop 5 and before
    pop 6, and the run matches ``repro``'s fleet engine."""
    spec = dict(policy="eps-bandit", k=3, eps=0.3, resel_every=3)
    plan = tjit.plan_fleet(worlds[1][3], 0, 12, tsel.SelectionSpec(**spec))
    readmits = tjit.readmit_points(plan)
    inside = [b for b in readmits for _, s, e in plan.waves if s < b < e]
    assert inside == [6]
    log = []
    real_pop, real_readmit = tjit._SlotQueue.pop, tjit._SlotQueue.readmit

    def pop(self, mafl, r):
        log.append(("pop", r))
        return real_pop(self, mafl, r)

    def readmit(self, idx, t_b):
        log.append(("readmit", idx.tolist(), float(t_b)))
        return real_readmit(self, idx, t_b)

    monkeypatch.setattr(tjit._SlotQueue, "pop", pop)
    monkeypatch.setattr(tjit._SlotQueue, "readmit", readmit)
    jres, tres = _fleet_pair(worlds, init, "jit", spec, rounds=12)
    assert_fleet_conforms(jres, tres)
    assert tres.extras["selection"] == jres.report.selection
    for b, vs in readmits.items():
        k = log.index(("pop", b - 1))
        assert log[k + 1][:2] == ("readmit", vs)
        # at pop b-1's time
        np.testing.assert_allclose(log[k + 1][2], tres.rounds[b - 1].time,
                                   rtol=1e-6)
        assert log[k + 2] == ("pop", b)


def _corridor_pair(init, engine, sel, rounds=12, eval_every=4):
    jres = jsc.run_scenario(QUICK, engine=engine, eval_every=eval_every,
                            use_kernel=True, rounds=rounds, **sel)
    sc = dataclasses.replace(tsc.get_scenario(QUICK), rounds=rounds, **sel)
    veh, ti, tl, p = tsc.build_world(sc)
    run = (run_handover_simulation if engine == "serial"
           else run_corridor_simulation)
    tres = run(sc, veh, ti, tl, p, eval_every=eval_every, use_kernel=True,
               init_params=params_from_jax(init, "cpu"), device="cpu")
    return jres, tres


def _assert_corridor_conforms(jres, tres, engine, param_tol=PARAM_TOL):
    assert ([(r.round, r.vehicle, r.rsu) for r in tres.rounds]
            == [(r.round, r.vehicle, r.rsu) for r in jres.rounds])
    assert tres.extras["selection"] == jres.report.selection
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


@pytest.mark.parametrize("engine", ["corridor", "serial"])
@pytest.mark.parametrize("sel", [
    dict(selection="weighted-topk", selection_k=3),
    dict(selection="eps-bandit", selection_k=2, selection_eps=0.4),
], ids=["weighted-topk", "eps-bandit"])
def test_corridor_engines_conform_under_selection(init, engine, sel):
    jres, tres = _corridor_pair(init, engine, sel)
    _assert_corridor_conforms(jres, tres, engine)
    decisions = tres.extras["selection"]["decisions"]
    assert [b for b, _, _ in decisions] == [4, 8]
    if sel["selection"] == "eps-bandit":
        # parked vehicles re-enter at the reconcile boundaries
        assert any(newly for _, newly, _ in decisions)


def test_corridor_chain_launches_keep_the_plan_under_selection(monkeypatch):
    """Re-admissions fall on reconcile rounds, which split segments
    already: the corridor's chains are those of its plan, and a FedAvg
    world without selection keeps its count."""
    calls = []
    real = tengine.agg_ops.ring_agg
    monkeypatch.setattr(tengine.agg_ops, "ring_agg",
                        lambda *a: calls.append(a) or real(*a))
    sel = dict(selection="eps-bandit", selection_k=2, selection_eps=0.4)
    tsc.run_scenario(QUICK, rounds=12, eval_every=4, device="cpu", **sel)
    sc = dataclasses.replace(tsc.get_scenario(QUICK), **sel)
    p = sc.channel()
    plan = tengine.plan_corridor(p, 2, 0, 12, selection=sc.selection_spec(),
                                 reconcile_every=4)
    assert len(calls) == tengine.chain_launches(plan, (4, 8, 12), 4)
    assert sum(a[1].shape[0] for a in calls) == 12
    readmits = tengine.readmit_points(plan)
    assert readmits and set(readmits) <= {4, 8}
    assert tengine.readmit_points(tengine.plan_corridor(p, 2, 0, 12)) == {}


@pytest.mark.parametrize("engine", ["corridor", "serial"])
def test_selection_with_ema_reconcile_raises(engine):
    with pytest.raises(ValueError, match="ema"):
        tsc.run_scenario(QUICK, engine=engine, rounds=6,
                         reconcile_mode="ema", selection="weighted-topk",
                         selection_k=2, device="cpu")
    with pytest.raises(ValueError, match="ema"):
        tsc.run_scenario("corridor-r4-k400-bandit", engine=engine,
                         reconcile_mode="ema", device="cpu")


def test_admit_all_with_ema_reconcile_runs():
    res = tsc.run_scenario(QUICK, engine="corridor", rounds=6,
                           eval_every=6, reconcile_mode="ema",
                           selection="admit-all", device="cpu")
    assert all(res.extras["selection"]["admit0"]) and len(res.rounds) == 6


@pytest.mark.parametrize("engine", ["batched", "jit"])
def test_parked_vehicles_never_arrive(worlds, engine):
    """weighted-topk k 2 never re-scores: the four parked vehicles hold no
    slot, no wave and no arrival."""
    veh, ti, tl, p = worlds[1]
    res = tmafl.run_simulation(
        veh, ti, tl, params=p, rounds=10, l_iters=1, lr=0.05,
        eval_every=10, engine=engine, device="cpu",
        selection=tsel.SelectionSpec("weighted-topk", k=2))
    admitted = {v for v, m in enumerate(res.extras["selection"]["admit0"])
                if m}
    assert len(admitted) == 2
    assert {r.vehicle for r in res.rounds} == admitted


def test_parked_vehicles_never_arrive_on_the_corridor():
    res = tsc.run_scenario(QUICK, rounds=12, eval_every=12, device="cpu",
                           selection="weighted-topk", selection_k=1)
    summary = res.extras["selection"]
    masks = [summary["admit0"]] + [m for _, _, m in summary["decisions"]]
    ever = {v for m in masks for v, a in enumerate(m) if a}
    assert len(ever) < 8 and {r.vehicle for r in res.rounds} <= ever


def _perturbed(planner, which):
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


@pytest.mark.parametrize("which, match", [
    ("counts", "arrival counts"), ("sums", "reward accumulators")])
@pytest.mark.parametrize("engine", ["jit", "corridor"])
def test_bandit_guard_raises_on_a_perturbed_expectation(monkeypatch, engine,
                                                        which, match):
    if engine == "jit":
        monkeypatch.setattr(tjit, "plan_fleet",
                            _perturbed(tjit.plan_fleet, which))
        run = dict(scenario="quick-k5", engine="jit", rounds=8,
                   selection="eps-bandit", selection_k=2,
                   selection_eps=0.3, resel_every=4)
    else:
        monkeypatch.setattr(tengine, "plan_corridor",
                            _perturbed(tengine.plan_corridor, which))
        run = dict(scenario=QUICK, engine="corridor", rounds=8,
                   selection="eps-bandit", selection_k=2)
    with pytest.raises(RuntimeError, match=match):
        tsc.run_scenario(device="cpu", eval_every=8, **run)


def test_bandit_guard_passes_unperturbed():
    res = tsc.run_scenario("quick-k5", engine="jit", rounds=8, eval_every=8,
                           selection="eps-bandit", selection_k=2,
                           selection_eps=0.3, resel_every=4, device="cpu")
    assert [b for b, _, _ in res.extras["selection"]["decisions"]] == [4]


def _registry_pair(init, name, engine, **overrides):
    """A registry world cut by ``overrides``, run through the entry point
    ``run_scenario`` calls, in both packages from one init."""
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
    return jres, tres


@pytest.mark.parametrize("name, engine", [
    ("fleet-k1000-topk", "batched"), ("fleet-k1000-topk", "jit"),
    ("fleet-k1000-budget", "batched"), ("fleet-k1000-budget", "jit"),
    ("corridor-r4-k400-bandit", "corridor"),
    ("corridor-r4-k400-bandit", "serial"),
])
def test_registry_selection_worlds_cut_to_k40(init, name, engine):
    """The registry's selection worlds at their rounds with K cut to 40
    and the caps cut with it (k 5 per RSU; 0.005 s of airtime per cycle),
    so the policies still park vehicles."""
    cut = {"fleet-k1000-topk": dict(selection_k=5),
           "fleet-k1000-budget": dict(selection_budget=0.005),
           "corridor-r4-k400-bandit": dict(selection_k=5)}[name]
    jres, tres = _registry_pair(init, name, engine, K=40, **cut)
    summary = tres.extras["selection"]
    assert summary == jres.report.selection
    assert not all(summary["admit0"])
    if engine == "batched":
        assert_conforms(jres, tres)
    else:
        # rsu is None on both sides of a single-RSU world
        _assert_corridor_conforms(
            jres, tres, engine,
            DEVICE_CUT_TOL if (name, engine) == ("fleet-k1000-topk", "jit")
            else PARAM_TOL)


def _torch_pre_activations(p, im):
    """The CNN's three pre-ReLU activations of one step's batch, NHWC."""
    x = im.permute(0, 3, 1, 2)
    c1 = tcnn._conv_same(x, p["conv1_w"]) + p["conv1_b"][:, None, None]
    c2 = (tcnn._conv_same(tcnn._max_pool_2x2(F.relu(c1)), p["conv2_w"])
          + p["conv2_b"][:, None, None])
    x = tcnn._max_pool_2x2(F.relu(c2)).permute(0, 2, 3, 1)
    h = x.reshape(x.shape[0], -1) @ p["fc1_w"] + p["fc1_b"]
    return [c1.permute(0, 2, 3, 1).numpy(), c2.permute(0, 2, 3, 1).numpy(),
            h.numpy()]


def _jax_pre_activations(p, im):
    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    c1 = conv(im, p["conv1_w"]) + p["conv1_b"]
    c2 = conv(jcnn._max_pool_2x2(jax.nn.relu(c1)), p["conv2_w"]) + p["conv2_b"]
    x = jcnn._max_pool_2x2(jax.nn.relu(c2))
    h = x.reshape(x.shape[0], -1) @ p["fc1_w"] + p["fc1_b"]
    return [np.asarray(c1), np.asarray(c2), np.asarray(h)]


def _pool_winners(a):
    b, h, w, c = a.shape
    a = np.maximum(a, 0).reshape(b, h // 2, 2, w // 2, 2, c)
    return a.transpose(0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, c,
                                                  4).argmax(-1)


def _crosses_a_kink(tp, jp, im):
    """Whether torch's and XLA's forward of one batch put some value on
    different sides of a ReLU or a max-pool tie."""
    ta = _torch_pre_activations(tp, im)
    ja = _jax_pre_activations(jp, jnp.asarray(im.numpy()))
    if any(((a > 0) != (b > 0)).any() for a, b in zip(ta, ja)):
        return True
    return any((_pool_winners(a) != _pool_winners(b)).any()
               for a, b in zip(ta[:2], ja[:2]))


def test_fleet_waves_train_as_repro_on_the_same_inputs(init, monkeypatch):
    """The fleet engine's wave steps on fleet-k1000-topk cut to K 40, each
    upload held on its own inputs (payload, batches) against the port's
    host step and against repro's step.  Every upload equals the host step
    within PARAM_TOL; an upload off repro's step by more than PARAM_TOL
    has a forward that crosses a kink between torch's and XLA's f32
    rounding, and that is the one reading DEVICE_CUT_TOL rests on."""
    waves = []
    for name in ("_local_scan_shared", "_local_scan_vmap"):
        real = getattr(tclient, name)

        def record(pay, imgs, labs, lr, real=real, shared="shared" in name):
            out, loss = real(pay, imgs, labs, lr)
            waves.append((shared, pay, imgs, labs, lr, out))
            return out, loss
        monkeypatch.setattr(tclient, name, record)
    sc = dataclasses.replace(tsc.get_scenario("fleet-k1000-topk"), K=40,
                             selection_k=5)
    veh, ti, tl, p = tsc.build_world(sc)
    tmafl.run_simulation(
        veh, ti, tl, params=p, rounds=sc.rounds, l_iters=sc.l_iters,
        lr=sc.lr, seed=0, eval_every=10, engine="jit", use_kernel=True,
        selection=sc.selection_spec(), init_params=params_from_jax(init,
                                                                   "cpu"),
        device="cpu")
    n, off = 0, []
    for shared, pay, imgs, labs, lr, out in waves:
        for i in range(imgs.shape[0]):
            tp = pay if shared else {k: v[i] for k, v in pay.items()}
            got = {k: v[i].numpy() for k, v in out.items()}
            host, _ = tclient._local_scan(tp, imgs[i], labs[i], lr)
            jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
            ref, _ = jclient._local_scan_jit(jp, jnp.asarray(imgs[i].numpy()),
                                             jnp.asarray(labs[i].numpy()), lr)
            for k in got:
                np.testing.assert_allclose(got[k], host[k].numpy(),
                                           err_msg=k, **PARAM_TOL)
            if not all(np.allclose(got[k], np.asarray(ref[k]), **PARAM_TOL)
                       for k in got):
                assert imgs.shape[1] == 1, "a kink is read on the first step"
                off.append(_crosses_a_kink(tp, jp, imgs[i, 0]))
            n += 1
    assert n == sc.rounds
    # one upload leaves PARAM_TOL, through a kink; were there none, the
    # cut would go back to PARAM_TOL
    assert off == [True]
