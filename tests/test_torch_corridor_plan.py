"""The corridor's host side against ``repro``: ``plan_corridor`` (arrays,
waves, ``tables()``) exactly equal, ``rsu_chain_groups`` equal on every
segment the engine runs, the engine's launch count read off the plan, and
the cloud tier's ``reconcile_models`` / ``ema_toward`` on CNN-shaped
leaves to 1e-6."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (repro.corridor imports through repro.core)
import repro.core.hierarchical as jhier
import repro.core.scenarios as jsc
import repro.corridor.plan as jplan
import repro_torch.core.hierarchical as thier
import repro_torch.core.scenarios as tsc
import repro_torch.corridor.engine as tengine
import repro_torch.corridor.plan as tplan
from repro_torch.models.cnn import CNN_SHAPES

PLAN_ARRAYS = ("veh", "cycle", "dl_round", "up_rsu", "times", "train_delay",
               "upload_delay", "download_time", "row0")
WORLDS = ["corridor-quick-r2-k8", "highway-k40-handover", "corridor-r4-k400",
          "corridor-rush-hour-r8-k4000"]


def _plans(name):
    sc = tsc.get_scenario(name)
    kw = dict(entry=sc.corridor_entry, reconcile_every=sc.reconcile_every,
              l_iters=sc.l_iters)
    p = sc.channel()
    return (sc, tplan.plan_corridor(p, sc.n_rsus, 0, sc.rounds, **kw),
            jplan.plan_corridor(p, sc.n_rsus, 0, sc.rounds, **kw))


@pytest.mark.parametrize("name", WORLDS)
def test_plan_corridor_equals_repro(name):
    _, tp, jp = _plans(name)
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert tp.waves == jp.waves and tp.n_slots == jp.n_slots
    assert tp.n_rsus == jp.n_rsus
    assert tp.q0.keys() == jp.q0.keys()
    for k in tp.q0:
        np.testing.assert_array_equal(tp.q0[k], jp.q0[k], err_msg=k)
    tt, jt = tp.tables(), jp.tables()
    assert tt.keys() == jt.keys()
    for k in tt:
        assert tt[k].dtype == jt[k].dtype, k
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    assert tp.sel is tp.sel_bandit is tp.flt is None


@pytest.mark.parametrize("name", WORLDS)
def test_chain_groups_equal_repro_on_every_segment(name):
    """The engine's segments at eval_every=10: the same per-RSU chunks as
    ``repro``'s ``rsu_chain_groups``, and one launch per chunk."""
    sc, tp, jp = _plans(name)
    evals = tengine.eval_rounds_of(sc.rounds, 10)
    sched = tengine.corridor_schedule(tp, evals, sc.reconcile_every)
    need = tengine.needed_rounds(tp)
    chunks = 0
    for (T, segs), (jT, s, e) in zip(sched, jp.waves):
        assert T == jT and segs[0][0] == s and segs[-1][1] == e
        for a, b, groups in segs:
            assert groups == jplan.rsu_chain_groups(jp, a, b, need)
            assert b == e or b in evals or b % sc.reconcile_every == 0
            chunks += sum(len(c) for _, c in groups)
    assert chunks == tengine.chain_launches(tp, evals, sc.reconcile_every)
    assert sum(len(c) for _, segs in sched for _, _, g in segs
               for _, cs in g for c in cs) == sc.rounds


def test_plan_corridor_rejects_faults():
    """The call that raised before faults were ported: the plan carries
    ``repro``'s own fault plan (tables and summary equal) and the same pop
    order."""
    p = tsc.get_scenario("corridor-quick-r2-k8").channel()
    jp = jsc.get_scenario("corridor-quick-r2-k8").channel()
    kw = dict(faults="deadzone", reconcile_every=4, l_iters=2)
    got = tplan.plan_corridor(p, 2, 0, 24, **kw)
    want = jplan.plan_corridor(jp, 2, 0, 24, **kw)
    np.testing.assert_array_equal(got.veh, want.veh)
    assert got.flt.summary(2) == want.flt.summary(2)
    tw, jw = got.flt.tables(24), want.flt.tables(24)
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k], err_msg=k)


def _cohorts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s).astype(np.float32)
             for k, s in CNN_SHAPES.items()} for _ in range(n)]


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_reconcile_models_equals_repro(n):
    models = _cohorts(n)
    want = jhier.reconcile_models([_jax(m) for m in models])
    got = thier.reconcile_models([_torch(m) for m in models])
    for k in CNN_SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("tau", [0.3, 1.0])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ema_toward_equals_repro(tau, use_kernel):
    g, c = _cohorts(2, seed=1)
    want = jhier.ema_toward(_jax(g), _jax(c), tau, use_kernel=use_kernel)
    got = thier.ema_toward(_torch(g), _torch(c), tau, use_kernel=use_kernel)
    for k in CNN_SHAPES:
        assert got[k].dtype == torch.float32 and got[k].shape == g[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    if tau == 1.0:
        for k in CNN_SHAPES:
            np.testing.assert_array_equal(got[k].numpy(), c[k])
