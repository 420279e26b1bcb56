"""Fault injection in the port, host side (``repro_torch.faults``): the spec,
the runtime, the f64 replays and the planners' fault plans against
``repro.faults`` on the same worlds, exactly (Python values and numpy arrays
equal), plus ``repro``'s property tests that need no telemetry, the EMA
guard and rule FLT001.  Every case is host-only numpy: the three registry
fault worlds run at their registered sizes (under 1 s each)."""
from __future__ import annotations

import dataclasses

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
from tests._hypothesis_compat import given, settings, st

# repro's churn-heavy spec (tests/test_faults.py): faults fire on short runs
HEAVY = dict(p_dropout=0.25, p_blackout=0.15, blackout_mean=20.0,
             p_partial=0.5, straggler_frac=0.4, straggler_mult=3.0,
             staleness_cap=6, recheck_every=2)
REGISTRY = ("fleet-k1000-flaky", "fleet-k1000-throttled",
            "corridor-rush-hour-deadzone-r8-k4000")
FLEET_FIELDS = ("veh", "cycle", "dl_round", "times", "train_delay",
                "upload_delay", "download_time", "waves", "n_slots")
CORRIDOR_FIELDS = FLEET_FIELDS + ("up_rsu", "row0", "n_rsus")


def assert_fault_plans_equal(got, want, rounds, l_iters):
    """A port FaultPlan equal to a repro one: summary, counter rows, the
    padded tables, and every field of the signature."""
    assert got.summary(l_iters) == want.summary(l_iters)
    np.testing.assert_array_equal(got.counts_table(l_iters),
                                  want.counts_table(l_iters))
    tg, tw = got.tables(rounds), want.tables(rounds)
    assert tg.keys() == tw.keys()
    for k in tw:
        np.testing.assert_array_equal(tg[k], tw[k], err_msg=k)
        assert tg[k].dtype == tw[k].dtype, k
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
    assert got.signature()[1:] == want.signature()[1:]
    assert got.readmit_lists() == want.readmit_lists()


def assert_plans_equal(got, want, names):
    for n in names:
        x, y = getattr(want, n), getattr(got, n)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=n)
            assert y.dtype == x.dtype, n
        else:
            assert y == x, n
    for k in want.q0:
        np.testing.assert_array_equal(got.q0[k], want.q0[k], err_msg=k)


def _spec(pkg, faults):
    return pkg.FaultSpec(**faults) if isinstance(faults, dict) else faults


def _fleet(name, faults=None, selection=None, **cut):
    """(port plan, repro plan, port replay, repro replay, rounds, l_iters)
    of one single-RSU world."""
    jw = dataclasses.replace(jsc.get_scenario(name), **cut)
    tw = dataclasses.replace(tsc.get_scenario(name), **cut)
    jf = _spec(jfaults, faults) if faults else jfaults.scenario_faults(jw)
    tf = _spec(tfaults, faults) if faults else tfaults.scenario_faults(tw)
    js = None if selection is None else jsel.SelectionSpec(**selection)
    ts = None if selection is None else tsel.SelectionSpec(**selection)
    M, L = tw.rounds, tw.l_iters
    return (tjit.plan_fleet(tw.channel(), 0, M, ts, faults=tf, l_iters=L),
            jjit.plan_fleet(jw.channel(), 0, M, js, faults=jf, l_iters=L),
            tfaults.replay_fleet_faults(tw.channel(), 0, M, tf, l_iters=L,
                                        selection=ts),
            jfaults.replay_fleet_faults(jw.channel(), 0, M, jf, l_iters=L,
                                        selection=js),
            M, L)


def _corridor(name, faults=None, **cut):
    jw = dataclasses.replace(jsc.get_scenario(name), **cut)
    tw = dataclasses.replace(tsc.get_scenario(name), **cut)
    jf = _spec(jfaults, faults) if faults else jfaults.scenario_faults(jw)
    tf = _spec(tfaults, faults) if faults else tfaults.scenario_faults(tw)
    M, L = tw.rounds, tw.l_iters
    kw = dict(entry=tw.corridor_entry, reconcile_every=tw.reconcile_every)
    return (tplan.plan_corridor(tw.channel(), tw.n_rsus, 0, M, faults=tf,
                                l_iters=L, **kw),
            jplan.plan_corridor(jw.channel(), jw.n_rsus, 0, M, faults=jf,
                                l_iters=L, **kw),
            tfaults.replay_corridor_faults(tw.channel(), tw.n_rsus, 0, M,
                                           tf, l_iters=L, **kw),
            jfaults.replay_corridor_faults(jw.channel(), jw.n_rsus, 0, M,
                                           jf, l_iters=L, **kw),
            M, L)


# ---------------------------------------------------------------------------
# spec resolution and scenario registry
# ---------------------------------------------------------------------------
def test_resolve_faults_collapses_falsy_and_noop():
    FaultSpec = tfaults.FaultSpec
    for falsy in (None, False, "off", "none", "", FaultSpec(),
                  FaultSpec(straggler_frac=0.5, straggler_mult=1.0)):
        assert tfaults.resolve_faults(falsy) is None
    assert tfaults.resolve_faults("flaky") == tfaults.named_profile("flaky")
    with pytest.raises(KeyError):
        tfaults.resolve_faults("no-such-profile")
    with pytest.raises(TypeError):
        tfaults.resolve_faults(42)
    with pytest.raises(ValueError):
        tfaults.resolve_faults(FaultSpec(p_dropout=1.5))
    assert not tfaults.faults_requested("off")
    assert tfaults.faults_requested("deadzone")


def test_fault_scenarios_registered():
    for name, profile in (("fleet-k1000-flaky", "flaky"),
                          ("corridor-rush-hour-deadzone-r8-k4000",
                           "deadzone"),
                          ("fleet-k1000-throttled", "throttled")):
        sc = tsc.get_scenario(name)
        assert sc.faults == profile
        assert tfaults.scenario_faults(sc) == tfaults.named_profile(profile)
    # a fault-free scenario resolves to no fault model
    assert tfaults.scenario_faults(tsc.get_scenario("fleet-k1000")) is None


@pytest.mark.parametrize("name", sorted(jfaults.PROFILES))
def test_profiles_and_capabilities_equal_repro(name):
    mine, ref = tfaults.named_profile(name), jfaults.named_profile(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in ("is_noop", "timeline_active", "has_partial", "has_cap"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    over = (("staleness_cap", 3), ("recheck_every", 5))
    sc = dataclasses.replace(tsc.get_scenario("quick-k5"), faults=name,
                             faults_overrides=over)
    jsc_ = dataclasses.replace(jsc.get_scenario("quick-k5"), faults=name,
                               faults_overrides=over)
    assert (dataclasses.asdict(tfaults.scenario_faults(sc))
            == dataclasses.asdict(jfaults.scenario_faults(jsc_)))


@pytest.mark.parametrize("bad", [dict(p_blackout=0.1),
                                 dict(straggler_mult=0.5),
                                 dict(staleness_cap=0),
                                 dict(recheck_every=-1),
                                 dict(p_partial=-0.1)])
def test_spec_validation_raises_as_repro(bad):
    with pytest.raises(ValueError) as mine:
        tfaults.FaultSpec(**bad).validate()
    with pytest.raises(ValueError) as ref:
        jfaults.FaultSpec(**bad).validate()
    assert str(mine.value) == str(ref.value)


def test_all_equals_repro():
    assert set(tfaults.__all__) == set(jfaults.__all__)


# ---------------------------------------------------------------------------
# planners and replays, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", REGISTRY)
def test_registry_worlds_plan_as_repro_at_full_size(name):
    """The three registry fault worlds at their registered size: the
    planner's fault plan, its replay's, and the rest of the plan equal
    ``repro``'s."""
    corridor = tsc.get_scenario(name).n_rsus > 1
    got, want, rgot, rwant, M, L = (_corridor if corridor else _fleet)(name)
    assert_fault_plans_equal(got.flt, want.flt, M, L)
    assert_fault_plans_equal(rgot, rwant, M, L)
    assert_fault_plans_equal(got.flt, rgot, M, L)
    assert_plans_equal(got, want, CORRIDOR_FIELDS if corridor
                       else FLEET_FIELDS)
    # the table of the slice's issue, seed 0: discards on every world
    assert got.flt.counts(L)["discarded_uploads"] > M // 2
    assert got.flt.counts(L)["partial_rounds"] == 0      # l_iters == 1


def test_registry_world_facts():
    """The registered worlds' fault facts, seed 0, from the port alone."""
    facts = {}
    for name in REGISTRY:
        corridor = tsc.get_scenario(name).n_rsus > 1
        plan = (_corridor if corridor else _fleet)(name)[0]
        s = plan.flt.summary(1)
        facts[name] = (tuple(s["counts"].values()),
                       sum(not a for a in s["admit0"]),
                       [(b, len(v)) for b, v in s["readmits"]],
                       s["n_stragglers"], sum(plan.flt.keep))
    assert facts == {
        "fleet-k1000-flaky": ((2, 1, 0, 17), 126, [(8, 87), (16, 2)], 0, 13),
        "fleet-k1000-throttled": ((0, 0, 0, 22), 0, [], 317, 8),
        "corridor-rush-hour-deadzone-r8-k4000": ((0, 2, 0, 24), 386,
                                                 [(8, 6)], 0, 16),
    }


@pytest.mark.parametrize("profile", ["flaky", "throttled"])
def test_paper_k10_plans_as_repro(profile):
    got, want, rgot, rwant, M, L = _fleet("paper-k10", profile)
    assert_fault_plans_equal(got.flt, want.flt, M, L)
    assert_fault_plans_equal(rgot, rwant, M, L)
    assert_plans_equal(got, want, FLEET_FIELDS)
    counts = got.flt.counts(L)
    if profile == "throttled":
        # partial computation and the cap both live at l_iters 5
        assert counts["partial_rounds"] == 15
        assert counts["discarded_uploads"] == 17
    else:
        assert [b for b, _ in got.flt.readmits] == [8, 16, 24, 32]


def test_composed_selection_and_faults_plan_as_repro():
    """fleet-k100 with weighted-topk and flaky: both admission layers fold
    into one admission table and one re-admission map, as in ``repro``."""
    sel = dict(policy="weighted-topk", k=30, resel_every=8)
    got, want, rgot, rwant, M, L = _fleet("fleet-k100", "flaky", sel,
                                          rounds=60)
    assert_fault_plans_equal(got.flt, want.flt, M, L)
    assert_fault_plans_equal(rgot, rwant, M, L)
    assert_plans_equal(got, want, FLEET_FIELDS)
    assert got.sel.summary() == want.sel.summary()
    mine = tjit.readmit_points(got)
    assert mine == jfaults.fold_readmits(want.sel, want.flt)
    # both layers contribute re-admissions
    assert got.flt.readmits and any(n for _, n, _ in got.sel.boundaries)
    adm = np.stack([got.sel.mask_for_round(r) for r in range(M)])
    np.testing.assert_array_equal(
        tfaults.fold_admission(adm, got.flt, got.veh),
        jfaults.fold_admission(adm, want.flt, want.veh))


def test_corridor_heavy_plans_as_repro():
    """corridor-quick-r2-k8 with ``repro``'s HEAVY spec, recovery sweeps at
    the reconcile boundaries."""
    got, want, rgot, rwant, M, L = _corridor("corridor-quick-r2-k8", HEAVY,
                                             rounds=24, l_iters=2)
    assert_fault_plans_equal(got.flt, want.flt, M, L)
    assert_fault_plans_equal(rgot, rwant, M, L)
    assert_plans_equal(got, want, CORRIDOR_FIELDS)
    assert got.flt.readmits


def test_faults_off_plans_carry_nothing():
    """Faults off builds no fault table: ``flt`` is None on both planners
    and the queue holds no admission table, keep or epoch column."""
    import torch
    p = dataclasses.replace(tchannel.ChannelParams(), K=6)
    for off in (None, "off", tfaults.FaultSpec()):
        plan = tjit.plan_fleet(p, 0, 10, faults=off, l_iters=2)
        assert plan.flt is None
        base = tjit.plan_fleet(p, 0, 10, l_iters=2)
        assert_plans_equal(plan, base, FLEET_FIELDS)
        gains = torch.ones(plan.n_slots, p.K)
        q = tjit._SlotQueue(p, plan, gains, torch.zeros(p.K), "cpu")
        assert q.adm is None and q.keep is None and q.epochs is None
        assert tplan.plan_corridor(p, 2, 0, 10, faults=off).flt is None
    # only what a profile turns on is built: throttled has no timeline
    plan = tjit.plan_fleet(p, 0, 10, faults="throttled", l_iters=2)
    q = tjit._SlotQueue(p, plan, torch.ones(plan.n_slots, p.K),
                        torch.zeros(p.K), "cpu")
    assert q.adm is None and q.keep is not None and q.epochs is not None
    plan = tjit.plan_fleet(p, 0, 10, faults="flaky", l_iters=2)
    q = tjit._SlotQueue(p, plan, torch.ones(plan.n_slots, p.K),
                        torch.zeros(p.K), "cpu")
    assert q.adm.shape == (10, 6) and q.epochs is None


# ---------------------------------------------------------------------------
# seed determinism and the sampler's properties (repro's own tests)
# ---------------------------------------------------------------------------
def test_replay_seed_determinism():
    p = dataclasses.replace(tchannel.ChannelParams(), K=20)
    spec = tfaults.FaultSpec(**HEAVY)
    a = tfaults.replay_fleet_faults(p, 3, 30, spec, l_iters=2)
    b = tfaults.replay_fleet_faults(p, 3, 30, spec, l_iters=2)
    assert a.signature() == b.signature()
    c = tfaults.replay_fleet_faults(p, 4, 30, spec, l_iters=2)
    assert c.signature() != a.signature()
    # FLT001 shape discipline: tables depend on (rounds, K), not the seed
    ta, tc = a.tables(30), c.tables(30)
    assert set(ta) == set(tc)
    for k in ta:
        assert ta[k].shape == tc[k].shape and ta[k].dtype == tc[k].dtype
    assert a.counts_table(2).shape == c.counts_table(2).shape == (30, 4)
    jp = dataclasses.replace(jchannel.ChannelParams(), K=20)
    assert_fault_plans_equal(a, jfaults.replay_fleet_faults(
        jp, 3, 30, jfaults.FaultSpec(**HEAVY), l_iters=2), 30, 2)


@settings(max_examples=8, deadline=None)
@given(st.floats(min_value=0.0, max_value=0.4))
def test_dropout_fraction_matches_spec_rate(p_drop):
    """Each pop draws its dropout independently at probability
    ``p_dropout``, so the recorded drop fraction concentrates around the
    spec rate (zero exactly at zero)."""
    spec = tfaults.FaultSpec(p_dropout=p_drop, recheck_every=4)
    p = dataclasses.replace(tchannel.ChannelParams(), K=50)
    plan = tfaults.replay_fleet_faults(p, 0, 400, spec, l_iters=1)
    if p_drop == 0.0:
        assert plan is None          # no-op spec collapses to faults-off
        return
    frac = float(np.mean(np.asarray(plan.cause) == 1))
    assert abs(frac - p_drop) < 0.12


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=1, max_value=5))
def test_partial_epoch_counts_bounded_by_configured(l_iters):
    spec = tfaults.FaultSpec(p_partial=0.6, recheck_every=4)
    p = dataclasses.replace(tchannel.ChannelParams(), K=20)
    plan = tfaults.replay_fleet_faults(p, 1, 120, spec, l_iters=l_iters)
    eps = np.asarray(plan.epochs)
    assert np.all((1 <= eps) & (eps <= l_iters))
    assert plan.counts(l_iters)["partial_rounds"] == \
        int(np.sum(eps < l_iters))
    # with partial disabled every cycle runs the full epoch count
    clean = tfaults.replay_fleet_faults(
        p, 1, 120, tfaults.FaultSpec(p_dropout=0.1, recheck_every=4),
        l_iters=l_iters)
    assert np.all(np.asarray(clean.epochs) == l_iters)


def test_dropped_vehicles_never_contribute_until_readmitted():
    """A suppressed re-schedule removes the vehicle from the event queue:
    it must not appear again in the pop sequence before a re-admission
    boundary brings it back.  The pop sequence is the fleet planner's
    (``repro`` reads it from its telemetry replay, which is the same
    timeline)."""
    p = dataclasses.replace(tchannel.ChannelParams(), K=30)
    rounds = 200
    spec = tfaults.FaultSpec(**HEAVY)
    plan = tfaults.replay_fleet_faults(p, 2, rounds, spec, l_iters=2)
    fleet = tjit.plan_fleet(p, 2, rounds, faults=spec, l_iters=2)
    assert fleet.flt == plan
    veh = fleet.veh
    suppressed = [r for r in range(rounds) if not plan.sched[r]]
    assert suppressed, "HEAVY spec produced no suppressions on 200 rounds"
    readmits = plan.readmit_lists()
    for r in suppressed:
        v = int(veh[r])
        later = np.nonzero(veh[r + 1:] == v)[0]
        if later.size == 0:
            continue                 # never came back before the end
        r2 = r + 1 + int(later[0])
        assert any(r < b <= r2 and v in vs
                   for b, vs in readmits.items()), (
            f"vehicle {v} suppressed at pop {r} reappeared at {r2} "
            "without a re-admission boundary in between")


# ---------------------------------------------------------------------------
# scope gates and rule FLT001
# ---------------------------------------------------------------------------
def test_ema_reconcile_rejects_timeline_faults():
    """Recovery re-admission needs an RSU-independent download model, so
    timeline-active faults are fedavg-only on corridor worlds."""
    check = tfaults.check_faults_reconcile
    with pytest.raises(ValueError, match="ema"):
        check(tfaults.named_profile("flaky"), "ema")
    # compute-only faults never touch the timeline: ema stays legal
    check(tfaults.named_profile("throttled"), "ema")
    check(tfaults.named_profile("flaky"), "fedavg")
    sc = dataclasses.replace(tsc.get_scenario("corridor-quick-r2-k8"),
                             reconcile_mode="ema", faults="flaky")
    for engine in ("corridor", "serial"):
        with pytest.raises(ValueError, match="ema"):
            tsc.run_scenario(sc, engine=engine, eval_every=sc.rounds,
                             device="cpu")


def test_flt001_flags_engine_imports_and_f32_in_fault_modules():
    from pathlib import Path

    from repro_torch.check.boundary import check_file, check_source
    bad = ("import torch\n"
           "from repro_torch.core.jit_engine import plan_fleet\n"
           "import numpy as np\n"
           "x = np.zeros(3, np.float32)\n")
    findings = check_source("src/repro_torch/faults/runtime.py", bad)
    rules = [f.rule for f in findings]
    assert rules.count("FLT001") == 3      # torch, engine import, f32 drop
    assert not {"PLN001", "PLN002"} & set(rules)
    # the real fault modules are clean under their own rule
    root = Path(__file__).resolve().parent.parent / "src/repro_torch/faults"
    for name in ("spec.py", "runtime.py", "replay.py", "__init__.py"):
        assert not [f for f in check_file(root / name) if not f.waived], name


def test_fault_probes_are_green_and_catch_a_seed_dependent_table():
    from repro_torch.check import plan_shapes
    assert plan_shapes.probe_faults_off() == []
    sigs = {0: {"tables[keep]": ((12,), "bool")},
            1: {"tables[keep]": ((11,), "bool")}}
    out = []
    plan_shapes._diff("FaultPlan.tables (fleet)", sigs, out,
                      "<probe:fault_tables>", rule="FLT001")
    assert [f.rule for f in out] == ["FLT001"]
