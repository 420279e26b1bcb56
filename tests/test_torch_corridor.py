"""The corridor engines on the CPU against ``repro``, from the same
(JAX-drawn) init with the kernel path on (the port's wrappers take their
plain versions on CPU tensors; ``repro``'s run the Pallas kernels in
interpret mode):

- ``engine="serial"``, the handover loop, against ``repro``'s: the host
  engines' bands (``_torch_world.py``: identical (round, vehicle, rsu)
  trace, times and weights to rtol 1e-9, ``PARAM_TOL``, accuracy 0.02);
- ``engine="corridor"``, the device engine, against ``repro``'s: the fleet
  engine's f32 bands (``FLEET_TIME_TOL``, ``FLEET_WEIGHT_TOL``,
  ``PARAM_TOL``, ``BF16_PARAM_TOL`` with a bf16 ring);
- the two engines against each other inside the port, to ``repro``'s own
  bands for that pair (``tests/test_engine_conformance.py``: params atol
  2e-3 with the real CNN, accuracy 0.05);

and the engine's ``ring_agg`` calls against the plan's chunk count, the
EMA reconcile's one ``weighted_agg`` call per reconcile, and the raises."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.scenarios as jsc
import repro_torch.core.scenarios as tsc
import repro_torch.corridor.engine as tengine
from _torch_world import (ACC_TOL, BF16_PARAM_TOL, FLEET_TIME_TOL,
                          FLEET_WEIGHT_TOL, PARAM_TOL, jax_init)
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.corridor import (run_corridor_simulation,
                                  run_handover_simulation)

QUICK = "corridor-quick-r2-k8"
ENGINE_VS_SERIAL = dict(rtol=0.0, atol=2e-3)
ENGINE_VS_SERIAL_ACC = 0.05


@pytest.fixture(scope="module")
def init():
    return jax_init()


def _port(name, engine, init, use_kernel=True, **overrides):
    """One port run from ``repro``'s init, on the CPU."""
    eval_every = overrides.pop("eval_every")
    sc = dataclasses.replace(tsc.get_scenario(name), **overrides)
    veh, ti, tl, p = tsc.build_world(sc)
    run = (run_handover_simulation if engine == "serial"
           else run_corridor_simulation)
    return run(sc, veh, ti, tl, p, eval_every=eval_every,
               use_kernel=use_kernel,
               init_params=params_from_jax(init, "cpu"), device="cpu")


def _pair(name, engine, init, eval_every, **overrides):
    jres = jsc.run_scenario(name, engine=engine, eval_every=eval_every,
                            use_kernel=True, **overrides)
    sc = dataclasses.replace(tsc.get_scenario(name), **overrides)
    veh, ti, tl, p = tsc.build_world(sc)
    run = (run_handover_simulation if engine == "serial"
           else run_corridor_simulation)
    tres = run(sc, veh, ti, tl, p, eval_every=eval_every, use_kernel=True,
               init_params=params_from_jax(init, "cpu"), device="cpu")
    assert len(tres.rounds) == sc.rounds
    assert ([getattr(tres.report, f) for f in ("engine", "scheme", "rounds")]
            == [getattr(jres.report, f) for f in ("engine", "scheme",
                                                  "rounds")])
    return jres, tres


def _trace(res):
    return [(r.round, r.vehicle, r.rsu) for r in res.rounds]


def _assert_params(jparams, tparams, tol):
    tnp = params_to_numpy(tparams)
    for k, v in jparams.items():
        assert tparams[k].device.type == "cpu"
        np.testing.assert_allclose(tnp[k], np.asarray(v), err_msg=k, **tol)


def _assert_acc(a_hist, b_hist, tol):
    assert [r for r, _ in a_hist] == [r for r, _ in b_hist]
    for (_, a), (_, b) in zip(a_hist, b_hist):
        assert abs(a - b) <= tol and np.isfinite(b)


def test_serial_matches_repro_serial(init):
    jres, tres = _pair(QUICK, "serial", init, 3, rounds=6)
    assert tres.scheme == jres.scheme == "mafl+handover"
    assert _trace(tres) == _trace(jres)
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay, b.weight],
            [a.time, a.upload_delay, a.train_delay, a.weight], rtol=1e-9)
    _assert_params(jres.final_params, tres.final_params, PARAM_TOL)
    _assert_acc(jres.acc_history, tres.acc_history, ACC_TOL)


def _assert_engine_conforms(jres, tres, bf16=False):
    assert tres.scheme == jres.scheme
    assert _trace(tres) == _trace(jres)
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay],
            [a.time, a.upload_delay, a.train_delay], **FLEET_TIME_TOL)
        np.testing.assert_allclose(b.weight, a.weight, **FLEET_WEIGHT_TOL)
    tol = BF16_PARAM_TOL if bf16 else PARAM_TOL
    _assert_params(jres.final_params, tres.final_params, tol)
    # the [R, ...] cohort stack at the end, row for row
    jG, tG = jres.extras["final_cohorts"], tres.extras["final_cohorts"]
    _assert_params(jG, tG, tol)
    np.testing.assert_array_equal(tres.extras["up_rsu"],
                                  jres.extras["up_rsu"])
    assert tres.extras["eval_rounds"] == jres.extras["eval_rounds"]
    assert tres.extras["n_rsus"] == jres.extras["n_rsus"]
    _assert_acc(jres.acc_history, tres.acc_history, ACC_TOL)


@pytest.mark.parametrize("kw", [
    {},
    {"reconcile_mode": "ema", "reconcile_tau": 0.3},
    {"scheme": "afl"},
    {"scheme": "fedasync"},
    {"ring_dtype": "bf16"},
], ids=["fedavg", "ema", "afl", "fedasync", "bf16"])
def test_engine_matches_repro_engine(init, kw):
    jres, tres = _pair(QUICK, "corridor", init, 4, rounds=8, **kw)
    _assert_engine_conforms(jres, tres, bf16=kw.get("ring_dtype") == "bf16")


def test_engine_matches_repro_engine_on_the_highway(init):
    """highway-k40-handover cut to 12 rounds, one local step: handover
    across the four RSUs, a reconcile at round 8."""
    jres, tres = _pair("highway-k40-handover", "corridor", init, 6,
                       rounds=12, l_iters=1)
    assert len({r.rsu for r in tres.rounds}) > 1
    _assert_engine_conforms(jres, tres)


def _ring_reads(init, monkeypatch, kw):
    """Run corridor-quick-r2-k8 with ``kw`` on the port's corridor engine,
    checking that each ring row a wave reads is bitwise the row as it was
    stored, and that no row changes after the reads either (later chains
    and reconciles write the stack in place).  Returns the rows read and
    the run."""
    stored, reads, rings = {}, [], []
    real_seg, real_wave = tengine._chain_segment, tengine._train_wave

    def snap(ring):
        for r, row in ring.items():
            if r not in stored or stored[r][0] is not row:
                stored[r] = (row, row.clone())

    def seg(queue, G, locals_buf, ring, *a, **kw):
        rings.append(ring)
        snap(ring)
        out = real_seg(queue, G, locals_buf, ring, *a, **kw)
        snap(ring)
        return out

    def wave(layout, rows, locals_buf, pay_rounds, *a):
        snap(rows)
        for pr in pay_rounds:
            reads.append(int(pr))
            assert torch.equal(rows[int(pr)], stored[int(pr)][1]), pr
        return real_wave(layout, rows, locals_buf, pay_rounds, *a)

    monkeypatch.setattr(tengine, "_chain_segment", seg)
    monkeypatch.setattr(tengine, "_train_wave", wave)
    res = _port(QUICK, "corridor", init, eval_every=4, **kw)
    ring = rings[-1]
    assert all(stored[r][0] is row and torch.equal(row, stored[r][1])
               for r, row in ring.items())
    return set(reads), res


def test_ring_rows_stay_as_stored_and_match_repro(init, monkeypatch):
    """corridor-quick-r2-k8 for 16 rounds with the EMA reconcile: later
    waves read ring rows stored by chains on both RSUs and by the
    reconcile at round 4, while the cohort stack is written in place at
    every chain end.  Each row a wave reads is bitwise the row as it was
    stored, and stays so to the end of the run; the run matches
    ``repro``'s."""
    kw = dict(rounds=16, reconcile_mode="ema", reconcile_tau=0.3)
    reads, res = _ring_reads(init, monkeypatch, kw)
    # rows of both RSUs' chains (5 and 6 follow uploads to RSU 1) and the
    # reconciled row of round 4
    assert {1, 2, 3, 4, 5, 6, 10, 11} <= reads
    jres = jsc.run_scenario(QUICK, engine="corridor", eval_every=4,
                            use_kernel=True, **kw)
    _assert_engine_conforms(jres, res)


def test_ring_rows_stay_as_stored_on_a_selection_world(init, monkeypatch):
    """The same on a FedAvg world with eps-bandit selection: a vehicle
    re-admitted at reconcile round b reads ring row b (in f32 the stored
    row is the tensor itself), and the run matches ``repro``'s."""
    kw = dict(rounds=16, selection="eps-bandit", selection_k=2,
              selection_eps=0.4)
    reads, res = _ring_reads(init, monkeypatch, kw)
    decisions = res.report.selection["decisions"]
    assert {b for b, newly, _ in decisions if newly} & reads
    jres = jsc.run_scenario(QUICK, engine="corridor", eval_every=4,
                            use_kernel=True, **kw)
    _assert_engine_conforms(jres, res)
    assert res.report.selection == jres.report.selection


def test_engine_matches_serial_in_the_port(init):
    ser = _port(QUICK, "serial", init, rounds=6, eval_every=3)
    eng = _port(QUICK, "corridor", init, rounds=6, eval_every=3)
    assert _trace(eng) == _trace(ser)
    np.testing.assert_allclose([r.time for r in eng.rounds],
                               [r.time for r in ser.rounds], **FLEET_TIME_TOL)
    np.testing.assert_allclose([r.weight for r in eng.rounds],
                               [r.weight for r in ser.rounds],
                               **FLEET_WEIGHT_TOL)
    for k in ser.final_params:
        np.testing.assert_allclose(eng.final_params[k].numpy(),
                                   ser.final_params[k].numpy(), err_msg=k,
                                   **ENGINE_VS_SERIAL)
    _assert_acc(ser.acc_history, eng.acc_history, ENGINE_VS_SERIAL_ACC)


def _count(monkeypatch, name):
    calls = []
    real = getattr(tengine.agg_ops, name)

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(tengine.agg_ops, name, spy)
    return calls


@pytest.mark.parametrize("kw, merges", [
    ({}, 0),
    ({"reconcile_mode": "ema", "reconcile_tau": 0.3}, 2),
], ids=["fedavg", "ema"])
def test_chains_and_reconciles_follow_the_plan(monkeypatch, kw, merges):
    """Every merge goes through ``ring_agg``, one call per chunk of the
    plan; the EMA reconcile is one ``weighted_agg`` call on the [R, P]
    stack per reconcile round, FedAvg none."""
    rings = _count(monkeypatch, "ring_agg")
    trees = _count(monkeypatch, "weighted_agg_tree")
    res = tsc.run_scenario(QUICK, rounds=8, eval_every=3, use_kernel=True,
                           device="cpu", record_cohorts=True, **kw)
    sc = tsc.get_scenario(QUICK)
    plan = tengine.plan_corridor(sc.channel(), sc.n_rsus, 0, 8)
    want = tengine.chain_launches(plan, (3, 6, 8), sc.reconcile_every)
    assert len(rings) == want and sum(a[1].shape[0] for a in rings) == 8
    assert len(trees) == merges
    for g, loc, *_ in trees:
        assert list(g) == ["G"] and g["G"].shape == (2, loc["G"].shape[1])
    assert [r for r, _ in res.acc_history] == [3, 6, 8]
    assert len(res.extras["cohort_snapshots"]) == 3
    assert res.extras["final_cohorts"]["conv1_w"].shape[0] == 2


@pytest.mark.parametrize("kw, err, match", [
    (dict(flat=False), NotImplementedError, "item 15"),
    (dict(mesh=object()), NotImplementedError, "item 13"),
    (dict(metrics="sometimes"), ValueError, "unknown metrics setting"),
    (dict(faults="deadzone", reconcile_mode="ema"), ValueError,
     "fault injection"),
    (dict(scheme="fedbuff"), ValueError, "fedbuff"),
    (dict(reconcile_mode="median"), ValueError, "reconcile_mode"),
    (dict(ring_dtype="f16"), ValueError, "ring_dtype"),
])
def test_corridor_engine_rejects(kw, err, match):
    fields = {k: kw.pop(k) for k in ("scheme", "reconcile_mode",
                                     "ring_dtype") if k in kw}
    sc = dataclasses.replace(tsc.get_scenario(QUICK), rounds=2, **fields)
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(err, match=match):
        run_corridor_simulation(sc, veh, ti, tl, p, device="cpu", **kw)


def test_corridor_engine_runs_a_selection_policy():
    """The call that raised before selection was ported: eps-bandit by
    name needs its k, as in ``repro``; with k 1 it re-scores at the
    reconcile boundary and reports the plan's summary."""
    from repro_torch.selection import SelectionSpec
    sc = dataclasses.replace(tsc.get_scenario(QUICK), rounds=6)
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(ValueError, match="needs k"):
        run_corridor_simulation(sc, veh, ti, tl, p, device="cpu",
                                selection="eps-bandit")
    res = run_corridor_simulation(sc, veh, ti, tl, p, device="cpu",
                                  selection=SelectionSpec("eps-bandit", k=1))
    assert len(res.rounds) == 6
    summary = res.report.selection
    assert summary["policy"] == "eps-bandit"
    assert [b for b, _, _ in summary["decisions"]] == [4]
    assert sum(summary["admit0"]) == 2          # k = 1 on each of 2 RSUs


@pytest.mark.parametrize("name, engine, match", [
    (QUICK, "batched", "cannot run multi-RSU"),
    (QUICK, "jit", "cannot run multi-RSU"),
    ("quick-k5", "corridor", "needs a multi-RSU"),
])
def test_run_scenario_rejects_engine_topology_mismatch(name, engine, match):
    with pytest.raises(ValueError, match=match):
        tsc.run_scenario(name, engine=engine, rounds=2, device="cpu")


@pytest.mark.parametrize("engine", ["serial", "corridor"])
def test_fault_worlds_raise(engine):
    """The call that raised before faults were ported: the dead-zone
    corridor, cut to K 40 and 16 rounds, runs on both corridor engines
    and reports ``repro``'s own replay's fault summary."""
    from repro.faults import replay_corridor_faults
    name = "corridor-rush-hour-deadzone-r8-k4000"
    cut = dict(K=40, rounds=16, n_train=1200, n_test=120)
    jsc_ = dataclasses.replace(jsc.get_scenario(name), **cut)
    want = replay_corridor_faults(
        jsc_.channel(), jsc_.n_rsus, 0, jsc_.rounds, jsc_.faults,
        l_iters=jsc_.l_iters, entry=jsc_.corridor_entry,
        reconcile_every=jsc_.reconcile_every).summary(jsc_.l_iters)
    res = tsc.run_scenario(name, engine=engine, device="cpu",
                           eval_every=16, **cut)
    assert len(res.rounds) == 16
    assert res.extras["faults"] == want
    assert want["counts"]["blackout_rounds"] + want["counts"][
        "discarded_uploads"] > 0 or not all(want["admit0"])


def test_run_scenario_defaults_to_the_corridor_engine():
    res = tsc.run_scenario(QUICK, rounds=4, eval_every=4, device="cpu")
    assert res.scheme == "mafl+corridor"
    assert np.isfinite(res.final_accuracy())
