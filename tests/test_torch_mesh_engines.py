"""The simulator over ranks of a mesh on the CPU: one world of four gloo
ranks (``tests/_torch_dist.py``) runs the fleet engine over ``"data"``
axes of 2 and 4, the corridor over an ``"rsu"`` axis of 2 and over
``("rsu", "data")``, and the hierarchical reconcile over ``"pod"``; this
process runs the same worlds unsharded, in the port and in ``repro``,
while the ranks run.  A two-rank axis is one of two axes of 2 whose other
axis neither engine reads, so each pair of ranks along it runs the
two-rank program.

- Against ``repro`` (the north star's bands, ``_torch_world.py``): the
  (round, vehicle, rsu) trace exact, times and weights in the f32 band,
  params within ``PARAM_TOL``, accuracy within 0.02.  ``repro``'s own
  sharded fleet run fails under jax 0.9
  (``test_jit_mesh_shard_map_matches_unsharded``), and its contract is the
  unsharded run, so that is what the ranks are held to.
- Against the port's unsharded run: the trace and every time bitwise (the
  queue runs alike on every rank).  The corridor's params, consensus and
  cohort stacks bitwise over ``"rsu"``: with R 2 over 2 ranks each holds
  one row, whose mean is the row, and the pmean of two rows is the stack
  mean bit for bit.  Where a wave is split over ``"data"`` the params
  within 1e-5: a share of a wave trains through convolutions of another
  batch size, which may round an ulp apart (3.0e-8 measured).
- The wrappers' calls on every rank: ``ring_agg`` (K1) once a chain of the
  plan on the flat fleet program; ``weighted_agg_tree`` (K2) once a pop
  the rank merges plus once an EMA reconcile under ``use_kernel``.
- The hierarchical reconcile against ``repro``'s functions on the same
  numpy arrays: the pod mean is an f32 sum over the pods (gloo's order)
  then ``/ pods``, ``repro``'s a sequential f32 sum then ``/ n``: equal
  over 2 pods, within an ulp or two over 4 (rtol 1e-6); the EMA step and
  the kernel's plain version round their products apart by an ulp (atol
  1e-6, ``repro``'s own bar between its kernel and plain EMA).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.hierarchical as jh
import repro.core.scenarios as jsc
import repro_torch.core.jit_engine as tjit
import repro_torch.core.scenarios as tsc
from _torch_dist import (CORRIDOR_CUT, CORRIDOR_RUNS, FLEET_CUT, FLEET_ROUNDS,
                         QUICK, corridor_run, digest, fleet_run,
                         four_ranks_body, numpy_init, start)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import ACC_TOL, FLEET_TIME_TOL, FLEET_WEIGHT_TOL, PARAM_TOL
from repro.core.jit_engine import run_simulation_jit as jax_fleet
from repro.corridor.engine import run_corridor_simulation as jax_corridor
from repro_torch.corridor.plan import plan_corridor

pytestmark = pytest.mark.usefixtures("one_thread")

SPLIT_TOL = dict(rtol=0.0, atol=1e-5)
POD_TOL = dict(rtol=1e-6, atol=1e-7)
EMA_TOL = dict(rtol=0.0, atol=1e-6)


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def repro_fleet(init):
    sc = dataclasses.replace(jsc.get_scenario("fleet-k1000"), **FLEET_CUT)
    veh, ti, tl, p = jsc.build_world(sc)
    return jax_fleet(veh, ti, tl, scheme=sc.scheme, rounds=FLEET_ROUNDS,
                     l_iters=sc.l_iters, lr=sc.lr, params=p, eval_every=4,
                     init_params=_jax(init))


def repro_corridor(variant, init):
    """``variant`` through ``repro``'s unsharded pytree program, its merges
    and reconciles by its plain f32 ops (the kernel's interpret mode would
    only slow the test: the port's ranks are held to ``PARAM_TOL``)."""
    kw = dict(CORRIDOR_RUNS[variant], use_kernel=False)
    fields = {k: kw.pop(k) for k in ("reconcile_mode", "reconcile_tau")
              if k in kw}
    sc = dataclasses.replace(jsc.get_scenario(QUICK), **CORRIDOR_CUT,
                             **fields)
    veh, ti, tl, p = jsc.build_world(sc)
    return jax_corridor(sc, veh, ti, tl, p, eval_every=3, flat=False,
                        init_params=_jax(init), **kw)


def _leaves():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(one_thread, tmp_path_factory):
    """The ranks' results, the port's unsharded runs and ``repro``'s: the
    ranks run while this process runs the other two."""
    init = numpy_init()
    ranks = start(four_ranks_body, 4, tmp_path_factory.mktemp("ranks"),
                  init, _leaves())
    try:
        port = {"fleet": digest(fleet_run(init)),
                "fleet pytree": digest(fleet_run(init, flat=False,
                                                 use_kernel=True))}
        for v in CORRIDOR_RUNS:
            port["corridor", v] = digest(corridor_run(v, init))
        jax = {"fleet": repro_fleet(init),
               "corridor": repro_corridor("ema-kernel-cohorts", init)}
    finally:
        out = ranks()
    return out, port, jax


def _same_run(got, want, tol=None):
    """``got`` against the port's ``want``: trace, times and accuracy
    exact; params (and cohort stacks) bitwise, or within ``tol``."""
    assert got["trace"] == want["trace"]
    assert np.array_equal(got["times"], want["times"])
    trees = [(got["params"], want["params"])]
    if want["final_cohorts"] is not None:
        trees.append((got["final_cohorts"], want["final_cohorts"]))
    trees += list(zip(got["cohorts"], want["cohorts"], strict=True))
    for g, w in trees:
        for k, v in w.items():
            if tol is None:
                assert np.array_equal(g[k], v), k
            else:
                np.testing.assert_allclose(g[k], v, err_msg=k, **tol)
    if tol is None:
        assert got["acc"] == want["acc"] and got["loss"] == want["loss"]
    else:
        assert [r for r, _ in got["acc"]] == [r for r, _ in want["acc"]]


def _as_repro(got, jres, cohorts=False):
    """``got`` against ``repro``'s unsharded run, the north star's bands."""
    assert got["trace"] == [(r.round, r.vehicle, r.rsu) for r in jres.rounds]
    want = np.array([[r.time, r.upload_delay, r.train_delay, r.weight]
                     for r in jres.rounds])
    np.testing.assert_allclose(got["times"][:, :3], want[:, :3],
                               **FLEET_TIME_TOL)
    np.testing.assert_allclose(got["times"][:, 3], want[:, 3],
                               **FLEET_WEIGHT_TOL)
    for k, v in jres.final_params.items():
        np.testing.assert_allclose(got["params"][k], np.asarray(v),
                                   err_msg=k, **PARAM_TOL)
    assert [r for r, _ in got["acc"]] == [r for r, _ in jres.acc_history]
    for (_, a), (_, b) in zip(got["acc"], jres.acc_history):
        assert abs(a - b) <= ACC_TOL
    if cohorts:
        snaps = jres.extras["cohort_snapshots"]
        for g, w in zip(got["cohorts"], snaps, strict=True):
            for k, v in w.items():
                np.testing.assert_allclose(g[k], np.asarray(v), err_msg=k,
                                           **PARAM_TOL)


def _chains():
    """``ring_agg`` chains of the fleet-k1000 cut's plan."""
    sc = dataclasses.replace(tsc.get_scenario("fleet-k1000"), **FLEET_CUT)
    plan = tjit.plan_fleet(sc.channel(), 0, FLEET_ROUNDS,
                           l_iters=sc.l_iters)
    assert [len(T) for T, _, _ in plan.waves] == [12, 2]
    needed = tjit.needed_rounds(plan, tjit.eval_rounds_of(FLEET_ROUNDS, 4))
    return sum(len(tjit.chain_bounds(s, e, needed))
               for _, s, e in plan.waves)


def _owned_pops():
    """Pops per rank of an ``"rsu"`` axis of 2 on the cut corridor."""
    sc = dataclasses.replace(tsc.get_scenario(QUICK), **CORRIDOR_CUT)
    plan = plan_corridor(sc.channel(), sc.n_rsus, 0, sc.rounds)
    return [int(np.sum(plan.up_rsu == j)) for j in range(2)]


@pytest.mark.parametrize("tag", ["data 2", "data 4"])
def test_fleet_data_axis_matches_unsharded(runs, tag):
    """The flat fleet program over a ``"data"`` axis of 2 (both waves
    split) and of 4 (the wave of 12 splits, the wave of 2 trains whole on
    every rank): every rank returns the unsharded run (params within
    1e-5) and runs the plan's ``ring_agg`` chains."""
    ranks, port, _ = runs
    for out in ranks:
        _same_run(out["fleet", tag], port["fleet"], SPLIT_TOL)
        assert out["fleet", tag, "counts"] == {"ring_agg": _chains(),
                                               "weighted_agg_tree": 0}


def test_fleet_data_axis_matches_repro(runs):
    """The fleet-k1000 cut over ``"data"`` axes of 2 and 4, and its pytree
    program over 2, against ``repro``'s unsharded run."""
    ranks, _, jax = runs
    for out in ranks:
        for key in (("fleet", "data 2"), ("fleet", "data 4"),
                    ("fleet pytree", "data 2")):
            _as_repro(out[key], jax["fleet"])


def test_fleet_pytree_data_axis_merges_each_pop(runs):
    """The pytree program over a ``"data"`` axis of 2 under
    ``use_kernel``: one ``weighted_agg_tree`` call a pop on every rank, no
    chain, the unsharded run's result."""
    ranks, port, _ = runs
    for out in ranks:
        _same_run(out["fleet pytree", "data 2"], port["fleet pytree"],
                  SPLIT_TOL)
        assert out["fleet pytree", "data 2", "counts"] == {
            "ring_agg": 0, "weighted_agg_tree": FLEET_ROUNDS}


def test_corridor_rsu_axis_matches_unsharded(runs):
    """corridor-quick-r2-k8 with the EMA reconcile under ``use_kernel`` and
    ``record_cohorts`` over an ``"rsu"`` axis of 2: every rank returns the
    unsharded run bit for bit (the final and recorded cohort stacks
    gathered whole), and merges only the pops on its cohort, plus the
    reconcile of its rows."""
    ranks, port, _ = runs
    owned = _owned_pops()
    reconciles = (CORRIDOR_CUT["rounds"]
                  // tsc.get_scenario(QUICK).reconcile_every)
    for rank, out in enumerate(ranks):
        _same_run(out["corridor", "rsu 2"],
                  port["corridor", "ema-kernel-cohorts"])
        assert out["corridor", "rsu 2", "counts"] == {
            "ring_agg": 0, "weighted_agg_tree": owned[rank // 2]
            + reconciles}


def test_corridor_rsu_axis_matches_repro(runs):
    """The EMA reconcile under ``use_kernel`` with ``record_cohorts`` over
    an ``"rsu"`` axis of 2 against ``repro``'s unsharded pytree program:
    trace, times, params and every cohort snapshot in the north star's
    bands."""
    ranks, _, jax = runs
    for out in ranks:
        _as_repro(out["corridor", "rsu 2"], jax["corridor"], cohorts=True)
        assert len(out["corridor", "rsu 2"]["cohorts"]) == 2


def test_corridor_rsu_and_data_axes(runs):
    """A (2, 2) ``("rsu", "data")`` mesh, the FedAvg reconcile: cohorts
    over ``"rsu"``, waves over ``"data"``; every rank returns the
    unsharded run (params within 1e-5) and merges the pops of its cohort
    under ``use_kernel``."""
    ranks, port, _ = runs
    owned = _owned_pops()
    for rank, out in enumerate(ranks):
        _same_run(out["corridor", "rsu 2 data 2"], port["corridor", "kernel"],
                  SPLIT_TOL)
        assert out["corridor", "rsu 2 data 2", "counts"] == {
            "ring_agg": 0, "weighted_agg_tree": owned[rank // 2]}


def test_sharded_corridor_refusals(runs):
    """``repro``'s refusals: the flat program or the bf16 ring under an
    ``"rsu"``-sharded mesh, and an ``"rsu"`` axis that does not divide
    the RSUs (3 over 2 ranks; 2 over 4)."""
    ranks, _, _ = runs
    for out in ranks:
        r = out["refusals"]
        assert "flat fast path does not run under an 'rsu'-sharded" in r[
            "flat"]
        assert "ring_dtype='bf16' requires the flat fast path" in r["bf16"]
        assert ("mesh 'rsu' axis of size 2 cannot shard 3 RSU cohorts"
                in r["odd"])
        assert ("mesh 'rsu' axis of size 4 cannot shard 2 RSU cohorts"
                in r["rsu 4"])


def _reference(pods, tau):
    """``repro``'s host reconcile of the cohorts ``pods`` (one numpy tree
    each): the mean, then each cohort's EMA step toward it."""
    pods = [_jax(p) for p in pods]
    mean = jh.reconcile_models(pods)
    return [jh.ema_toward(p, mean, tau) if tau != 1.0 else mean
            for p in pods]


def _blocks(tree, n):
    return [{k: v for k, v in zip(tree, parts)}
            for parts in zip(*(np.split(v, n) for v in tree.values()))]


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("tau", [1.0, 0.5])
@pytest.mark.parametrize("tag", ["pod-data", "pod"])
def test_cross_pod_reconcile_matches_repro(runs, tag, tau, use_kernel):
    """Four ranks as a (2, 2) ``("pod", "data")`` mesh (each leaf's rows
    over both axes, the default shard spec: a pod's cohort is its two data
    shards) and as a (4,) ``"pod"`` mesh (a cohort a rank): every rank's
    shard equals the same rows of ``repro``'s reconcile of the cohorts."""
    leaves = _leaves()
    pods = 2 if tag == "pod-data" else 4
    want = _reference(_blocks(leaves, pods), tau)
    tol = POD_TOL if tau == 1.0 and not use_kernel else EMA_TOL
    for rank, out in enumerate(runs[0]):
        pod, shard = divmod(rank, 4 // pods)
        got = out[tag, tau, use_kernel]
        for k, v in want[pod].items():
            rows = np.split(np.asarray(v), 4 // pods)[shard]
            np.testing.assert_allclose(got[k], rows, err_msg=k, **tol)


def test_mesh_axes_are_row_major(runs):
    """``mesh_axis`` gives each rank its coordinate on each axis, row-major
    as ``jax.make_mesh`` lays devices out."""
    for rank, out in enumerate(runs[0]):
        assert out["pod-data", "axes"] == {"pod": (2, rank // 2),
                                           "data": (2, rank % 2)}
        assert out["pod", "axes"] == {"pod": (4, rank)}


def test_hierarchical_round_matches_repro(runs):
    """``make_hierarchical_round`` (beta 0.5, weight 0.8, reconcile every
    2): step 0 is the pod-local merge alone, step 1 the merge and then the
    cross-pod FedAvg; each against ``repro``'s functions on the cohorts."""
    leaves = _leaves()
    upload = {k: v[::-1].copy() for k, v in leaves.items()}
    merged = [jh.pod_local_mafl(_jax(g), _jax(u), 0.5, 0.8)
              for g, u in zip(_blocks(leaves, 2), _blocks(upload, 2))]
    mean = jh.reconcile_models(merged)
    for rank, out in enumerate(runs[0]):
        pod, shard = divmod(rank, 2)
        for k in leaves:
            local = np.split(np.asarray(merged[pod][k]), 2)[shard]
            np.testing.assert_allclose(out["round", 0][k], local,
                                       err_msg=k, **EMA_TOL)
            np.testing.assert_allclose(
                out["round", 1][k], np.split(np.asarray(mean[k]), 2)[shard],
                err_msg=k, **EMA_TOL)


def test_mesh_refusals_on_four_ranks(runs):
    """At world size 4: the production meshes (256 and 512 ranks) and the
    one-rank host mesh refuse the group; a shard spec naming an axis the
    mesh lacks, and a mesh without the pod axis, refuse the reconcile."""
    for out in runs[0]:
        r = out["mesh refusals"]
        assert "(16, 16) needs a process group of 256" in r["production"]
        assert "this one has 4" in r["production"]
        assert "(2, 16, 16) needs a process group of 512" in r["multi-pod"]
        assert "needs a process group of 1 ranks" in r["host"]
        assert "names axes ['data']" in r["spec"]
        assert "has no 'pod' axis" in r["axis"]
