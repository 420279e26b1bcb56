"""The port's five engines under fault injection against ``repro``'s same
engine, on the CPU, from one (JAX-drawn) init with the kernel path on.

- ``extras["faults"]`` equals ``repro``'s exactly on every engine and
  world, and the (round, vehicle[, rsu]) traces are identical;
- host engines (``serial``, ``batched``): times and weights to rtol 1e-9,
  params within ``PARAM_TOL``, accuracy within 0.02 (``_torch_world.py``);
- device engines (``jit``, ``corridor``): the f32 bands of
  ``_torch_world.py`` (``FLEET_TIME_TOL``: the golden suite's rtol 2e-5 /
  atol 1e-3), params within ``PARAM_TOL``, accuracy within 0.02.

Worlds: paper-k10 with ``throttled`` cut to 10 rounds (partial computation
and the staleness cap both live; the test says why 10), fleet-k100 with
``flaky`` cut to 20 rounds and 2 local steps (``repro``'s own
replay-conformance world: drops, a blackout, recovery sweeps, cap
discards), corridor-quick-r2-k8 with
``repro``'s HEAVY spec for 24 rounds of 2 local steps on both corridor
engines, and the three registry fault worlds cut to K 40 on their default
engine.  Also: ``_local_scan_partial`` against ``repro``'s partial scan on
the same numpy inputs, and faults off bitwise the run without faults."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.client as jclient
import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.faults as jfaults
import repro_torch.core.client as tclient
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.faults as tfaults
from _torch_world import (ACC_TOL, FLEET_TIME_TOL, FLEET_WEIGHT_TOL,
                          PARAM_TOL, assert_conforms, assert_fleet_conforms,
                          jax_init)
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.corridor import (run_corridor_simulation,
                                  run_handover_simulation)
from repro_torch.models.cnn import CNN_SHAPES

HEAVY = dict(p_dropout=0.25, p_blackout=0.15, blackout_mean=20.0,
             p_partial=0.5, straggler_frac=0.4, straggler_mult=3.0,
             staleness_cap=6, recheck_every=2)


@pytest.fixture(scope="module")
def init():
    return jax_init()


def _fleet_pair(name, engine, init, eval_every, **cut):
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


def _corridor_pair(name, engine, init, eval_every, **cut):
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


def _assert_corridor_conforms(jres, tres, engine):
    assert ([(r.round, r.vehicle, r.rsu) for r in tres.rounds]
            == [(r.round, r.vehicle, r.rsu) for r in jres.rounds])
    host = engine == "serial"
    for a, b in zip(jres.rounds, tres.rounds):
        got = [b.time, b.upload_delay, b.train_delay]
        want = [a.time, a.upload_delay, a.train_delay]
        if host:
            np.testing.assert_allclose(got + [b.weight], want + [a.weight],
                                       rtol=1e-9)
        else:
            np.testing.assert_allclose(got, want, **FLEET_TIME_TOL)
            np.testing.assert_allclose(b.weight, a.weight,
                                       **FLEET_WEIGHT_TOL)
    tnp = params_to_numpy(tres.final_params)
    for k, v in jres.final_params.items():
        np.testing.assert_allclose(tnp[k], np.asarray(v), err_msg=k,
                                   **PARAM_TOL)
    assert [r for r, _ in jres.acc_history] == [r for r, _ in
                                                tres.acc_history]
    for (_, a), (_, b) in zip(jres.acc_history, tres.acc_history):
        assert abs(a - b) <= ACC_TOL and np.isfinite(b)


# ---------------------------------------------------------------------------
# the partial local scan
# ---------------------------------------------------------------------------
def _scan_inputs(n, l_iters=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=(n,) + s) * 0.1).astype(np.float32)
              for k, s in CNN_SHAPES.items()}
    imgs = rng.normal(size=(n, l_iters, b, 28, 28, 1)).astype(np.float32)
    labs = rng.integers(0, 10, size=(n, l_iters, b)).astype(np.int32)
    return params, imgs, labs


def _close(tree, ref, **tol):
    for k, v in ref.items():
        np.testing.assert_allclose(tree[k].numpy(), np.asarray(v),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("n_ep", [1, 2, 3])
def test_local_scan_partial_matches_repro(n_ep):
    """Deadline semantics on ``repro``'s inputs, l_iters 3: the single
    scan against ``_local_scan_partial_jit``, the per-row and the shared
    vmaps against ``_local_scan_partial_vmap``; at ``n_ep == l_iters`` the
    port's partial scan is bitwise its own ``_local_scan``."""
    params, imgs, labs = _scan_inputs(3)
    lr = 0.05
    one = {k: v[0] for k, v in params.items()}
    jp, jl = jclient._local_scan_partial_jit(
        {k: jnp.asarray(v) for k, v in one.items()}, jnp.asarray(imgs[0]),
        jnp.asarray(labs[0]), lr, jnp.int32(n_ep))
    tone = {k: torch.from_numpy(v) for k, v in one.items()}
    timg, tlab = torch.from_numpy(imgs), torch.from_numpy(labs).long()
    tp, tl = tclient._local_scan_partial(tone, timg[0], tlab[0], lr,
                                         torch.tensor(n_ep))
    _close(tp, jp, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    if n_ep == 3:
        fp, fl = tclient._local_scan(tone, timg[0], tlab[0], lr)
        assert all(torch.equal(fp[k], tp[k]) for k in fp)
        assert torch.equal(fl, tl)

    eps = np.array([n_ep, 1, 3], np.int32)
    jv, jls = jclient._local_scan_partial_vmap(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(imgs),
        jnp.asarray(labs), lr, jnp.asarray(eps))
    tv, tls = tclient._local_scan_partial_vmap(
        {k: torch.from_numpy(v) for k, v in params.items()}, timg, tlab, lr,
        torch.from_numpy(eps))
    _close(tv, jv, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-5)
    # one payload broadcast to the wave: the shared form of the same scan
    shared = {k: np.broadcast_to(v[:1], v.shape) for k, v in params.items()}
    jv, _ = jclient._local_scan_partial_vmap(
        {k: jnp.asarray(v) for k, v in shared.items()}, jnp.asarray(imgs),
        jnp.asarray(labs), lr, jnp.asarray(eps))
    ts, _ = tclient._local_scan_partial_shared(tone, timg, tlab, lr,
                                               torch.from_numpy(eps))
    _close(ts, jv, rtol=1e-4, atol=2e-6)


# ---------------------------------------------------------------------------
# engines against repro
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["serial", "batched"])
def test_host_engines_under_partial_and_cap(init, engine):
    """paper-k10 with ``throttled`` for 10 rounds: four partial cycles and
    a cap-discarded arrival on both host engines.  Not more rounds: this
    world amplifies f32 rounding fast — on ``repro`` alone, scaling the
    init by (1 + 2^-22) moves the final params by 4.4e-5 at 12 rounds and
    3.1e-4 at 14, so past 10 rounds no run of either package stays within
    ``PARAM_TOL`` of another whose convolutions sum in another order."""
    jres, tres = _fleet_pair("paper-k10", engine, init, 5, rounds=10,
                             faults="throttled")
    assert tres.extras["faults"] == jres.extras["faults"]
    counts = tres.extras["faults"]["counts"]
    assert counts["partial_rounds"] > 0 and counts["discarded_uploads"] > 0
    assert_conforms(jres, tres)


@pytest.mark.parametrize("engine", ["batched", "jit"])
def test_fleet_k100_flaky_conforms(init, engine):
    """``repro``'s own replay-conformance world (fleet-k100, flaky, 20
    rounds, 2 local steps): drops, a blackout, two recovery sweeps and
    cap discards, on the batched and the fleet engine."""
    jres, tres = _fleet_pair("fleet-k100", engine, init, 10, rounds=20,
                             l_iters=2, faults="flaky")
    summary = tres.extras["faults"]
    assert summary == jres.extras["faults"]
    assert summary["readmits"] and summary["counts"]["discarded_uploads"]
    if engine == "jit":
        assert_fleet_conforms(jres, tres)
    else:
        assert_conforms(jres, tres)


@pytest.mark.parametrize("engine", ["corridor", "serial"])
def test_corridor_engines_under_heavy_churn(init, engine):
    """corridor-quick-r2-k8 with ``repro``'s HEAVY spec, 24 rounds of 2
    local steps: dropouts, blackouts, recoveries at the reconcile
    boundaries, partial cycles, cap discards and stragglers."""
    cut = dict(rounds=24, l_iters=2, faults="flaky",
               faults_overrides=tuple(HEAVY.items()))
    jres, tres = _corridor_pair("corridor-quick-r2-k8", engine, init, 8,
                                **cut)
    summary = tres.extras["faults"]
    assert summary == jres.extras["faults"]
    c = summary["counts"]
    assert summary["readmits"] and c["partial_rounds"] and \
        c["discarded_uploads"] and summary["n_stragglers"]
    _assert_corridor_conforms(jres, tres, engine)


@pytest.mark.parametrize("name", ["fleet-k1000-flaky", "fleet-k1000-throttled",
                                  "corridor-rush-hour-deadzone-r8-k4000"])
def test_registry_worlds_cut_to_k40(init, name):
    """The three registry fault worlds cut to K 40 (rounds as registered)
    on their default engine: batched for the fleets, the corridor engine
    for the dead-zone corridor."""
    cut = dict(K=40, n_train=1200, n_test=120)
    if tsc.get_scenario(name).n_rsus > 1:
        jres, tres = _corridor_pair(name, "corridor", init, 10, **cut)
        _assert_corridor_conforms(jres, tres, "corridor")
    else:
        jres, tres = _fleet_pair(name, "batched", init, 10, **cut)
        assert_conforms(jres, tres)
    assert tres.extras["faults"] == jres.extras["faults"]
    assert tres.extras["faults"]["counts"]["discarded_uploads"] > 0


# ---------------------------------------------------------------------------
# faults off
# ---------------------------------------------------------------------------
def _digest(res):
    return ([(r.round, r.vehicle, r.time, r.weight) for r in res.rounds],
            {k: v.numpy().tobytes() for k, v in res.final_params.items()},
            res.acc_history)


def _run_off(name, engine, faults):
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


@pytest.mark.parametrize("name, engine", [("quick-k5", "serial"),
                                          ("quick-k5", "batched"),
                                          ("quick-k5", "jit"),
                                          ("corridor-quick-r2-k8",
                                           "corridor"),
                                          ("corridor-quick-r2-k8",
                                           "serial")])
def test_faults_off_is_bitwise_the_run_without_faults(name, engine):
    """Every off spelling runs the path without faults: the same trace,
    bitwise the same params, no fault summary."""
    base = _digest(_run_off(name, engine, None))
    for off in ("off", tfaults.FaultSpec(straggler_frac=0.5)):
        res = _run_off(name, engine, off)
        assert _digest(res) == base
        assert "faults" not in res.extras and res.report is None
