"""The sweep tier's host side and its kernel on the CPU (``repro_torch.
core.sweep``, ``SweepSpec``): the padded plan tables, their stacking and
the gain tables equal to ``repro``'s, the grid order, every raise with
``repro``'s exception type and text, K1's plain version over a world axis
bitwise the per-world chain, the world-axis launch geometry, and the
PLN003 probe of the stacked tables.  The engine runs are in
``tests/test_torch_sweep_engine.py``."""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.core.jit_engine as jjit
import repro.core.scenarios as jsc
import repro.core.sweep as jsweep
import repro.selection as jsel
import repro_torch.core.jit_engine as tjit
import repro_torch.core.scenarios as tsc
import repro_torch.core.sweep as tsweep
import repro_torch.selection as tsel
from repro_torch import kernels
from repro_torch.check import grid_race, plan_shapes
from repro_torch.kernels.weighted_agg import ops, ref
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SEL_SPECS = {"weighted-topk": dict(policy="weighted-topk", k=3,
                                   resel_every=4),
             "eps-bandit": dict(policy="eps-bandit", k=2, eps=0.3,
                                resel_every=4)}


def _plans(name, rounds, seed, sel):
    sc = tsc.get_scenario(name)
    p = sc.channel()
    tspec = None if sel is None else tsel.SelectionSpec(**SEL_SPECS[sel])
    jspec = None if sel is None else jsel.SelectionSpec(**SEL_SPECS[sel])
    return (tjit.plan_fleet(p, seed, rounds, tspec, l_iters=sc.l_iters),
            jjit.plan_fleet(jsc.get_scenario(name).channel(), seed, rounds,
                            jspec, l_iters=sc.l_iters))


@pytest.mark.parametrize("name, rounds, sel", [
    ("quick-k5", 10, None), ("paper-k10", 12, None),
    ("quick-k5", 12, "weighted-topk"), ("quick-k5", 12, "eps-bandit")])
@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_plan_tables_equal_repro(name, rounds, sel, seed):
    tp, jp = _plans(name, rounds, seed, sel)
    tt, jt = tp.tables(), jp.tables()
    assert list(tt) == list(jt)
    for k in jt:
        a, b = np.asarray(tt[k]), np.asarray(jt[k])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def _stack_cases():
    a = {"veh": np.zeros((8,), np.int32), "times": np.ones((8,), np.float32)}
    b = {k: v.copy() for k, v in a.items()}
    return {"ragged shape": [a, dict(b, times=np.ones((9,), np.float32))],
            "dtype": [a, dict(b, veh=np.zeros((8,), np.int64))],
            "fields": [a, {"veh": a["veh"]}],
            "empty": []}


@pytest.mark.parametrize("case", list(_stack_cases()))
def test_stack_plan_tables_rejects_as_repro(case):
    tables = _stack_cases()[case]
    assert (_raised(lambda: tsweep.stack_plan_tables(tables))
            == _raised(lambda: jsweep.stack_plan_tables(tables)))


def test_stack_plan_and_gain_tables_accept_as_repro():
    worlds = [("quick-k5", 0, None), ("quick-k5", 1, "weighted-topk"),
              ("quick-k5", 2, "eps-bandit")]
    pairs = [_plans(n, 12, s, sel) for n, s, sel in worlds]
    got = tsweep.stack_plan_tables([tp.tables() for tp, _ in pairs])
    want = jsweep.stack_plan_tables([jp.tables() for _, jp in pairs])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].shape[0] == 3
    ps = [tsc.get_scenario("quick-k5").channel()] * 3
    jps = [jsc.get_scenario("quick-k5").channel()] * 3
    seeds = [0, 1, 2]
    n_slots = [tp.n_slots for tp, _ in pairs]
    gains = tsweep.stack_gain_tables(ps, seeds, n_slots)
    assert gains.dtype == np.float32
    assert gains.shape == (3, max(n_slots), 5)
    np.testing.assert_array_equal(
        gains, jsweep.stack_gain_tables(jps, seeds, n_slots))


def test_sweepspec_worlds_are_repros_in_its_order():
    kw = dict(scenario="quick-k5", seeds=(0, 1, 2),
              variants=tuple((("channel_overrides", (("beta", b),)),)
                             for b in (0.2, 0.8)),
              overrides=(("rounds", 6),))
    got = tsc.SweepSpec(**kw).worlds()
    want = jsc.SweepSpec(**kw).worlds()
    assert len(got) == 6
    assert ([(dataclasses.asdict(sc), seed) for sc, seed in got]
            == [(dataclasses.asdict(sc), seed) for sc, seed in want])
    assert [seed for _, seed in got] == [0, 1, 2, 0, 1, 2]


def _spec(pkg, **kw):
    return pkg.SweepSpec(**{"scenario": "quick-k5", **kw})


def _variants(field, *vals):
    return tuple(((field, v),) for v in vals)


# every configuration the sweep tier refuses: (repro call, port call)
RAISES = {
    "metrics": lambda pkg, dev: pkg.run_scenario(
        "quick-k5", engine="vmap", metrics="on", **dev),
    "empty batch": lambda pkg, dev: (
        tsweep if pkg is tsc else jsweep).run_simulation_vmap([], **dev),
    "rounds": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, variants=_variants("rounds", 6, 8)), **dev),
    "fleet size": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, variants=_variants("K", 5, 6)), **dev),
    "scheme": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, variants=_variants("scheme", "mafl", "afl")), **dev),
    "ring dtype": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, variants=_variants("ring_dtype", "f32", "bf16")), **dev),
    "multi-RSU sweep": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, scenario="corridor-quick-r2-k8"), **dev),
    "multi-RSU run_scenario": lambda pkg, dev: pkg.run_scenario(
        "corridor-quick-r2-k8", engine="vmap", **dev),
    "fedbuff": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, overrides=(("scheme", "fedbuff"),)), **dev),
    "faults": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, scenario="fleet-k1000-flaky"), **dev),
    "unknown ring dtype": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, overrides=(("ring_dtype", "f16"),)), **dev),
    "varied alpha": lambda pkg, dev: pkg.run_sweep(_spec(
        pkg, variants=_variants("channel_overrides", (("alpha", 2.0),),
                                (("alpha", 3.0),))), **dev),
    "use_kernel": lambda pkg, dev: pkg.run_scenario(
        "quick-k5", engine="vmap", use_kernel=True, **dev),
    "mesh": lambda pkg, dev: pkg.run_scenario(
        "quick-k5", engine="vmap", mesh=object(), **dev),
    "record_cohorts": lambda pkg, dev: pkg.run_scenario(
        "quick-k5", engine="vmap", record_cohorts=True, **dev),
    "flat=False": lambda pkg, dev: pkg.run_scenario(
        "quick-k5", engine="vmap", flat=False, **dev),
    "run_sweep engine": lambda pkg, dev: pkg.run_sweep(
        _spec(pkg), engine="batched", **dev),
    "unknown engine": lambda pkg, dev: pkg.run_scenario(
        "quick-k5", engine="warp", **dev),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_unsupported_configurations_raise_as_repro(case):
    """The exception type and its whole text equal ``repro``'s: nothing
    runs a world, nothing falls back."""
    want = _raised(lambda: RAISES[case](jsc, {}))
    got = _raised(lambda: RAISES[case](tsc, {"device": "cpu"}))
    assert got == want
    assert got[0] == "ValueError"
    if case == "multi-RSU sweep":
        assert "single-RSU only" in got[1]


def test_no_unported_vmap_raise_remains():
    import inspect
    src = inspect.getsource(tsc)
    assert "unported(\"engine='vmap'\"" not in src
    res = tsc.run_scenario("quick-k5", engine="vmap", rounds=2,
                           eval_every=2, device="cpu")
    assert res.report.engine == "vmap" and len(res.rounds) == 2


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("W", [1, 3])
def test_ring_agg_world_axis_is_the_per_world_chain(dtype, W):
    """K1's plain version over a ``[W, U, P]`` view of a ``[W, M, P]``
    buffer (world stride ``M * P``, never copied) is bitwise each world's
    one-world chain, signed zeros and a (1, 0) step included; on CPU
    tensors nothing launches."""
    M, P, a, b = 7, 128 * 5, 2, 6
    rng = np.random.default_rng(W)
    g = torch.from_numpy(rng.standard_normal((W, P)).astype(np.float32))
    g[:, ::7] = -0.0
    buf = torch.from_numpy(rng.standard_normal((W, M, P)).astype(
        np.float32)).to(dtype)
    buf[:, :, ::7] = 0.0
    c = rng.uniform(0.5, 1.0, (W, b - a))
    coeffs = torch.from_numpy(np.stack([c, 1.0 - c], -1).astype(np.float32))
    coeffs[:, 0] = torch.tensor([1.0, 0.0])
    locs = buf[:, a:b]
    assert locs.stride(0) == M * P and (W == 1 or not locs.is_contiguous())
    kernels.reset_launches()
    out = ops.ring_agg(g, locs, coeffs)
    assert kernels.launch_counts()["ring_agg"] == 0
    assert out.shape == (W, P) and out.dtype == torch.float32
    assert torch.equal(_bits(out), _bits(ref.ring_agg(g, locs, coeffs)))
    for w in range(W):
        one = ops.ring_agg(g[w], locs[w], coeffs[w])
        assert torch.equal(_bits(out[w]), _bits(one)), w
    assert not torch.signbit(out[:, ::7]).any()


def test_ring_agg_world_axis_rejects():
    W, U, M, P = 3, 2, 5, 256
    g = torch.zeros(W, P)
    buf = torch.zeros(W, M, P)
    coeffs = torch.zeros(W, U, 2)
    overlapping = buf.view(-1)[:W * U * P].as_strided((W, U, P), (P, P, 1))
    for bad, match in [
            ((g, buf[:2, :U], coeffs), r"\[3, U, 256\]"),
            ((g, buf[:, :U], coeffs[:, :1]), r"\[3, 2, 2\]"),
            ((g, overlapping, coeffs), "world stride"),
            ((g, torch.zeros(W, P, U).transpose(1, 2), coeffs),
             "contiguous rows"),
            ((g[:, :128], buf[:, :U, :128], coeffs), "contiguous f32")]:
        with pytest.raises(ValueError, match=match):
            ops.ring_agg(*bad)


@pytest.mark.parametrize("P, dtype", [(1152, torch.float32),
                                      (422016, torch.float32),
                                      (422016, torch.bfloat16)])
@pytest.mark.parametrize("W", [1, 3, 15])
def test_ring_geometry_world_axis_is_parallel_safe(P, dtype, W):
    """The world axis is the grid's y: block (i, w) stores world w's run
    i, every element of ``[W, P]`` by exactly one block, and W = 1 is the
    one-world grid."""
    (geo,) = ops.ring_geometry(P, 2, dtype, W)
    (one,) = ops.ring_geometry(P, 2, dtype)
    assert geo.grid == ((one.grid[0],) if W == 1 else (one.grid[0], W))
    rep = grid_race.analyze_launches("weighted_agg.ring_agg_worlds",
                                     "ring_agg", [geo])
    assert rep.classification == "parallel-safe", rep
    spans = sorted(rng for blk in geo.blocks()
                   for rng in geo.outputs["out"].ranges(blk))
    assert spans[0][0] == 0 and spans[-1][1] == W * P
    assert all(p[1] == q[0] for p, q in zip(spans, spans[1:]))
    for blk in geo.blocks():
        (lo, hi), = geo.outputs["out"].ranges(blk)
        (lo1, hi1), = one.outputs["out"].ranges(blk[:1])
        w = blk[1] if len(blk) > 1 else 0
        assert (lo, hi) == (w * P + lo1, w * P + hi1)


def test_world_axis_case_registered_parallel_safe():
    rep = grid_race.get_report("weighted_agg.ring_agg_worlds")
    assert rep.classification == "parallel-safe" and rep.grid[1] == 3


def _pln003(findings, name):
    return [f for f in findings if f.rule == "PLN003" and name in f.message]


def test_plan_probe_holds_fleet_tables_and_their_stack():
    findings = plan_shapes.probe_plan_shapes()
    assert not [f for f in findings if f.rule == "PLN003"], findings


def test_plan_probe_flags_drifting_fleet_tables(monkeypatch):
    """A ``FleetPlan.tables`` whose shape changes from one plan to the next
    is flagged twice: its signature drifts across seeds, and
    ``stack_plan_tables`` refuses the selection plans' batch."""
    orig = tjit.FleetPlan.tables
    calls = itertools.count(1)
    monkeypatch.setattr(tjit.FleetPlan, "tables", lambda self: {
        **orig(self), "drift": np.zeros(next(calls), np.int32)})
    findings = plan_shapes.probe_plan_shapes()
    assert _pln003(findings, "FleetPlan.tables")
    stack = [f for f in findings if f.rule == "PLN003"
             and f.path == "<probe:stack_plan_tables>"]
    assert stack and "'drift' not stackable" in stack[0].message
