"""``repro_torch.selection`` and ``repro_torch.faults``' composition
helpers against ``repro``'s, on the CPU, from one seed.

Selection decides which vehicle is admitted, so everything here is held to
equality, never to a tolerance: each policy's mask on the same
``SelectionContext`` (ties in score and cost, empty RSU groups, the
bandit's explore and exploit branches), the spec's validation errors,
``SelectionState`` replays (``plan().summary()``, ``tables(rounds)``, the
f64 bandit expectation) and the f64 planners' arrays on the registry's
three selection worlds at full size."""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest

import repro.channel as jchannel
import repro.core.jit_engine as jjit
import repro.core.scenarios as jsc
import repro.corridor.plan as jplan
import repro.faults as jfaults
import repro.selection as jsel
import repro_torch.channel as tchannel
import repro_torch.core.jit_engine as tjit
import repro_torch.core.scenarios as tsc
import repro_torch.corridor.plan as tplan
import repro_torch.faults as tfaults
import repro_torch.selection as tsel

SEEDS = range(6)


def _ctx(mod, seed, K, n_rsus, ties, empty_group, coverage):
    """The same decision context in ``mod`` (``repro.selection`` or the
    port's), features drawn with numpy from ``seed``.  ``ties`` draws
    features from two values each, so scores and costs tie; with
    ``empty_group`` the last RSU serves nobody."""
    rng = np.random.default_rng(seed)
    if ties:
        data = rng.choice([2250.0, 6000.0], K)
        compute = rng.choice([9e8, 1.05e9], K)
        residence = rng.choice([10.0, 20.0], K)
        cost = rng.choice([1e-3, 2e-3], K)
    else:
        data = rng.uniform(100.0, 5000.0, K)
        compute = rng.uniform(1e8, 2e9, K)
        residence = rng.uniform(1.0, 80.0, K)
        cost = rng.uniform(1e-3, 5e-3, K)
    in_cov = rng.random(K) < coverage
    serving = rng.integers(0, max(n_rsus - empty_group, 1), K)
    return mod.SelectionContext(
        t=0.0, data=data, compute=compute, residence=residence,
        upload_cost=cost, in_coverage=in_cov, serving=serving,
        n_rsus=n_rsus, rng=np.random.default_rng([seed, 1]))


def _bandit_state(mod, seed, K, ties):
    """Reward accumulators with never-tried arms (``rew_cnt`` 0) and, with
    ``ties``, equal means."""
    rng = np.random.default_rng([seed, 2])
    cnt = rng.integers(0, 3, K).astype(float)
    rew = (rng.choice([0.5, 1.0], K) if ties
           else rng.uniform(0.1, 1.5, K)) * cnt
    return mod.BanditState(rew.copy(), cnt.copy())


SPECS = [dict(policy="admit-all"),
         dict(policy="weighted-topk", k=3),
         dict(policy="budget", budget=4e-3),
         dict(policy="eps-bandit", k=2, eps=0.0),
         dict(policy="eps-bandit", k=2, eps=1.0),
         dict(policy="eps-bandit", k=3, eps=0.5)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(
    f"{v}" for v in s.values()))
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("n_rsus, empty_group", [(1, 0), (3, 0), (3, 1)],
                         ids=["r1", "r3", "r3-empty"])
def test_policy_masks_equal_repro(spec, ties, n_rsus, empty_group):
    for seed in SEEDS:
        K = 7 + 3 * seed
        coverage = 1.0 if seed % 2 == 0 else 0.7
        masks = []
        for mod in (jsel, tsel):
            pol = mod.make_policy(mod.SelectionSpec(**spec))
            state = (_bandit_state(mod, seed, K, ties)
                     if spec["policy"] == "eps-bandit" else None)
            ctx = _ctx(mod, seed, K, n_rsus, ties, empty_group, coverage)
            masks.append(pol.mask(ctx, state))
            # the rng was drawn as far on both sides
            masks.append(ctx.rng.random())
        assert masks[1] == masks[3]
        np.testing.assert_array_equal(masks[2], masks[0])
        assert masks[2].dtype == bool


def test_groups_and_observe_equal_repro():
    for seed in SEEDS:
        jctx = _ctx(jsel, seed, 12, 4, True, 1, 0.7)
        tctx = _ctx(tsel, seed, 12, 4, True, 1, 0.7)
        got = [(j, g.tolist()) for j, g in tctx.groups()]
        assert got == [(j, g.tolist()) for j, g in jctx.groups()]
        assert got[-1][1] == []                  # the empty RSU
        states = []
        for mod in (jsel, tsel):
            pol = mod.make_policy(mod.SelectionSpec("eps-bandit", k=2))
            st = pol.init_state(5)
            for v, r in [(0, 0.5), (3, 1.25), (0, 0.75)]:
                st = pol.observe(st, v, r)
            states.append(st)
        np.testing.assert_array_equal(states[1].rew_sum, states[0].rew_sum)
        np.testing.assert_array_equal(states[1].rew_cnt, states[0].rew_cnt)


BAD_SPECS = [dict(policy="nope"), dict(policy="weighted-topk"),
             dict(policy="weighted-topk", k=0), dict(policy="budget"),
             dict(policy="budget", budget=-1.0),
             dict(policy="eps-bandit", k=2, eps=1.5),
             dict(policy="eps-bandit", eps=0.2)]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=str)
def test_spec_validation_raises_as_repro(spec):
    with pytest.raises(ValueError) as want:
        jsel.SelectionSpec(**spec).validate()
    with pytest.raises(ValueError) as got:
        tsel.SelectionSpec(**spec).validate()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tsel.make_policy(tsel.SelectionSpec(**spec))


def test_spec_is_frozen_hashable_and_noop_as_repro():
    for policy in jsel.POLICIES:
        kw = dict(policy=policy, k=2, budget=1e-3, eps=0.2, resel_every=3)
        a, b = jsel.SelectionSpec(**kw), tsel.SelectionSpec(**kw)
        assert a.is_noop == b.is_noop and hash(b) == hash(
            tsel.SelectionSpec(**kw))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        with pytest.raises(dataclasses.FrozenInstanceError):
            b.k = 3
    assert tsel.POLICIES == jsel.POLICIES
    assert tsel.__all__ == jsel.__all__


def test_scenario_spec_reads_the_registry_as_repro():
    for name in jsc.list_scenarios():
        want = jsc.get_scenario(name).selection_spec()
        got = tsc.get_scenario(name).selection_spec()
        assert (got is None) == (want is None), name
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    spec = tsc.get_scenario("corridor-r4-k400-bandit").selection_spec()
    assert spec.policy == "eps-bandit" and spec.k == 25


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("selection, mode, raises", [
    (None, "ema", False), ("admit-all", "ema", False),
    ("admit-all", "fedavg", False),
    (dict(policy="weighted-topk", k=2), "fedavg", False),
    (dict(policy="weighted-topk", k=2), "ema", True),
    (dict(policy="eps-bandit", k=2), "ema", True),
    ("weighted-topk", "fedavg", True),       # a bare name has no k
])
def test_check_reconcile_mode_as_repro(selection, mode, raises):
    got, want = (_outcome(lambda mod=mod: mod.check_reconcile_mode(
        mod.SelectionSpec(**selection) if isinstance(selection, dict)
        else selection, mode)) for mod in (tsel, jsel))
    assert got == want and (got is not None) == raises


def _mobility(pkg, K, n_rsus):
    p = dataclasses.replace(pkg.ChannelParams(), K=K)
    mob = (pkg.Mobility(p) if n_rsus == 1
           else pkg.CorridorMobility(p, n_rsus))
    return p, mob


REPLAY_SPECS = [dict(policy="admit-all"),
                dict(policy="weighted-topk", k=2, resel_every=3),
                dict(policy="budget", budget=0.008, resel_every=4),
                dict(policy="eps-bandit", k=2, eps=0.3, resel_every=4),
                dict(policy="eps-bandit", k=1, eps=0.9, resel_every=2)]


@pytest.mark.parametrize("spec", REPLAY_SPECS, ids=lambda s: s["policy"])
@pytest.mark.parametrize("n_rsus", [1, 2])
def test_selection_state_replays_equal_repro(spec, n_rsus):
    """A K 6 world driven by one random arrival stream: the same masks,
    re-admissions, summary, tables and f64 bandit expectation."""
    rounds = 24
    out = []
    for mod, pkg in ((jsel, jchannel), (tsel, tchannel)):
        p, mob = _mobility(pkg, 6, n_rsus)
        st = mod.make_selection_state(mod.SelectionSpec(**spec), p, mob,
                                      seed=7, rounds=rounds)
        log = [st.initial_vehicles()]
        rng = np.random.default_rng(0)
        for total in range(1, rounds + 1):
            v = int(rng.integers(0, p.K))
            log.append(st.on_arrival(v, float(rng.uniform(0.5, 2.0)),
                                     float(rng.uniform(0.5, 2.0))))
            log.append(st.maybe_reselect(total, 1.7 * total))
        plan = st.plan()
        out.append((log, plan.summary(), plan.tables(rounds),
                    st.bandit_expectation(), plan.signature(),
                    plan.is_noop,
                    [plan.mask_for_round(r).tolist()
                     for r in range(rounds)]))
    (jlog, jsum, jtab, jexp, jsig, jnoop, jmasks), \
        (tlog, tsum, ttab, texp, tsig, tnoop, tmasks) = out
    assert tlog == jlog and tsum == jsum and tmasks == jmasks
    assert tnoop == jnoop and tsig[1:] == jsig[1:]
    assert ttab.keys() == jtab.keys()
    for k in jtab:
        np.testing.assert_array_equal(ttab[k], jtab[k])
        assert ttab[k].dtype == jtab[k].dtype
    assert (texp is None) == (jexp is None)
    if jexp is not None:
        for a, b in zip(texp, jexp):
            np.testing.assert_array_equal(a, b)


def test_bandit_without_epoch_raises_as_repro():
    for mod, pkg in ((jsel, jchannel), (tsel, tchannel)):
        p, mob = _mobility(pkg, 4, 1)
        with pytest.raises(ValueError, match="resel_every"):
            mod.SelectionState(mod.SelectionSpec("eps-bandit", k=2), p, mob,
                               seed=0, rounds=10)


def _assert_plans_equal(a, b, names):
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        if n == "q0":
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        elif n == "sel":
            assert y.summary() == x.summary()
            assert y.signature()[1:] == x.signature()[1:]
        elif n == "sel_bandit":
            assert (x is None) == (y is None)
            for u, v in zip(x or (), y or ()):
                np.testing.assert_array_equal(v, u)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=n)
            assert y.dtype == x.dtype, n
        else:
            assert y == x, n


FLEET_FIELDS = ("veh", "cycle", "dl_round", "times", "train_delay",
                "upload_delay", "download_time", "waves", "n_slots", "q0",
                "sel", "sel_bandit")


@pytest.mark.parametrize("name", ["fleet-k1000-topk", "fleet-k1000-budget"])
def test_plan_fleet_equals_repro_at_full_size(name):
    jsc_, tsc_ = jsc.get_scenario(name), tsc.get_scenario(name)
    want = jjit.plan_fleet(jsc_.channel(), 0, jsc_.rounds,
                           jsc_.selection_spec())
    got = tjit.plan_fleet(tsc_.channel(), 0, tsc_.rounds,
                          tsc_.selection_spec())
    _assert_plans_equal(want, got, FLEET_FIELDS)
    # the policy parks vehicles: +inf slots, never popped
    parked = ~np.asarray(got.sel.admit0)
    assert parked.any() and np.isinf(got.q0["time"][parked]).all()
    assert not parked[got.veh].any()
    np.testing.assert_array_equal(got.sel.tables(tsc_.rounds)["mask"],
                                  want.sel.tables(jsc_.rounds)["mask"])


def test_plan_fleet_with_readmissions_equals_repro():
    """A K 6 bandit world whose re-admission at round 6 falls inside a
    segment of the wave partition."""
    spec = dict(policy="eps-bandit", k=3, eps=0.3, resel_every=3)
    want = jjit.plan_fleet(dataclasses.replace(jchannel.ChannelParams(),
                                               K=6), 0, 12,
                           jsel.SelectionSpec(**spec))
    got = tjit.plan_fleet(dataclasses.replace(tchannel.ChannelParams(),
                                              K=6), 0, 12,
                          tsel.SelectionSpec(**spec))
    _assert_plans_equal(want, got, FLEET_FIELDS)
    readmits = tjit.readmit_points(got)
    assert readmits == jfaults.fold_readmits(want.sel, None)
    assert any(s < b < e for b in readmits for _, s, e in got.waves)


CORRIDOR_FIELDS = FLEET_FIELDS + ("up_rsu", "row0", "n_rsus")


def test_plan_corridor_equals_repro_at_full_size():
    name = "corridor-r4-k400-bandit"
    jsc_, tsc_ = jsc.get_scenario(name), tsc.get_scenario(name)
    want = jplan.plan_corridor(jsc_.channel(), 4, 0, 40,
                               selection=jsc_.selection_spec(),
                               reconcile_every=8)
    got = tplan.plan_corridor(tsc_.channel(), 4, 0, 40,
                              selection=tsc_.selection_spec(),
                              reconcile_every=8)
    _assert_plans_equal(want, got, CORRIDOR_FIELDS)
    tw, jw = got.tables(), want.tables()
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k], err_msg=k)
    # re-scored at every reconcile boundary before the last round
    assert [b for b, _, _ in got.sel.boundaries] == [8, 16, 24, 32]
    assert sum(len(n) for _, n, _ in got.sel.boundaries) > 0
    assert got.sel_bandit[1].sum() == 40


def test_composition_helpers_equal_repro():
    """``initial_vehicles``, ``arrival_step`` and ``fold_readmits`` with
    ``flt=None`` drive two selection states the same way."""
    spec = dict(policy="eps-bandit", k=2, eps=0.5, resel_every=3)
    out = []
    for mod, helpers, pkg in ((jsel, jfaults, jchannel),
                              (tsel, tfaults, tchannel)):
        p, mob = _mobility(pkg, 7, 1)
        st = mod.SelectionState(mod.SelectionSpec(**spec), p, mob, seed=3,
                                rounds=20)
        log = [helpers.initial_vehicles(st, None, p.K),
               helpers.initial_vehicles(None, None, 3)]
        rng = np.random.default_rng(1)
        for r in range(20):
            sched, readm = [], []
            helpers.arrival_step(
                st, None, r=r, vehicle=int(rng.integers(0, p.K)),
                time=float(r), upload_delay=float(rng.uniform(0.5, 2.0)),
                train_delay=float(rng.uniform(0.5, 2.0)), pending=3,
                schedule=sched.append, readmit=readm.append)
            log.append((sched, readm))
        log.append(helpers.fold_readmits(st.plan(), None))
        out.append(log)
    assert out[1] == out[0]
    assert set(tfaults.__all__) == set(jfaults.__all__)


def _drive_helpers(helpers, sel_mod, pkg, call):
    """One selection state and one fault state of K 7 (churn-heavy, so
    the gate parks vehicles at t = 0 and on re-schedule), handed to one of
    the composition helpers by ``call``; returns what it gave and both
    states' residue."""
    p, mob = _mobility(pkg, 7, 1)
    sel = sel_mod.SelectionState(
        sel_mod.SelectionSpec(policy="eps-bandit", k=4, eps=0.5,
                              resel_every=3), p, mob, seed=3, rounds=20)
    flt = helpers.make_fault_state(
        helpers.FaultSpec(p_dropout=0.3, p_blackout=0.3, blackout_mean=2.0,
                          p_partial=0.5, staleness_cap=4, recheck_every=4),
        p, seed=3, rounds=20, l_iters=3)
    out = call(helpers, sel, flt)
    return out, sel.plan().summary(), flt.plan().summary(3)


@pytest.mark.parametrize("call", [
    lambda h, sel, flt: h.initial_vehicles(sel, flt, 7),
    lambda h, sel, flt: [h.initial_vehicles(sel, flt, 7)] + [
        (h.arrival_step(sel, flt, r=r, vehicle=r % 7, time=float(r),
                        upload_delay=1.0, train_delay=1.5, pending=2,
                        schedule=log.append, readmit=log.append), log)[1]
        for r, log in zip(range(20), [[] for _ in range(20)])],
    lambda h, sel, flt: (h.initial_vehicles(sel, flt, 7), [
        h.arrival_step(sel, flt, r=r, vehicle=r % 7, time=float(r),
                       upload_delay=1.0, train_delay=1.5, pending=2,
                       schedule=lambda v: None) for r in range(20)],
        h.fold_readmits(sel.plan(), flt.plan()))[2],
], ids=["initial_vehicles", "arrival_step", "fold_readmits"])
def test_composition_helpers_raise_for_a_fault_state(call):
    """The calls that raised before faults were ported: each helper drives
    a fault state beside a selection state as ``repro``'s does, and both
    states end with ``repro``'s residue."""
    mine = _drive_helpers(tfaults, tsel, tchannel, call)
    ref = _drive_helpers(jfaults, jsel, jchannel, call)
    assert mine == ref
    assert mine[0]
