"""Tests of the port that need an NVIDIA Hopper card.  They skip without
one; on the card run them with

    python -m pytest -q -m cuda tests/test_torch_card.py

The file imports neither jax nor repro, so it runs where only PyTorch is
installed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.weighted_agg import ops, ref
from repro_torch.models.cnn import CNN_SHAPES

# mixing (1 - alpha, 1.0) and literal (beta, weight) scalar pairs
SCALARS = [(1.0 - 0.0734125, 1.0), (0.5, 0.8719), (0.3, 1.7)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _int_view(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version_on_card(cuda_device, tdt):
    """The hand kernel against its plain version, bitwise, on the card."""
    kernels.reset_launches()
    shapes = list(CNN_SHAPES.values()) + [(12345,), (77,)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in shapes:
        for off in (0, 1):                   # aligned and misaligned views
            n = int(np.prod(shape))
            g, l = (torch.randn(n + off, generator=gen, device=cuda_device)
                    .to(tdt)[off:].view(shape) for _ in range(2))
            for beta, weight in SCALARS:
                out = ops.weighted_agg(g, l, beta, weight)
                want = ref.weighted_agg(g, l, beta, weight)
                torch.cuda.synchronize()
                assert torch.equal(_int_view(out), _int_view(want)), (
                    shape, off, beta, weight)
    assert ops.KERNEL.launches == len(shapes) * 2 * len(SCALARS)


@pytest.mark.cuda
def test_kernel_path_runs_or_raises_on_card(cuda_device):
    """On a CUDA tensor the wrapper launches the kernel (counted) and
    rejects a non-contiguous input instead of taking the plain version."""
    kernels.reset_launches()
    g = torch.randn(64, 33, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.weighted_agg(g.t(), g.t(), 0.5, 1.0)
    assert ops.KERNEL.launches == 0
    ops.weighted_agg(g, g, 0.5, 1.0)
    assert kernels.launch_counts() == {
        "weighted_agg": 1, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.cuda
def test_slice_on_card_uses_the_kernel(cuda_device):
    """quick-k5 on the card: one launch per merge (the CNN's 8 leaves in
    one table)."""
    from repro_torch.core.scenarios import run_scenario
    kernels.reset_launches()
    res = run_scenario("quick-k5", rounds=4, use_kernel=True,
                       device=cuda_device)
    assert ops.KERNEL.launches == len(res.rounds) == 4
    assert all(v.is_cuda for v in res.final_params.values())


def _tree(shapes, dtype_of, off_of, gen, device):
    return [{k: torch.randn(int(np.prod(s)) + off_of(k), generator=gen,
                            device=device).to(dtype_of(k))[off_of(k):]
             .view(s) for k, s in shapes.items()} for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_set", ["cnn", "mixed", "misaligned",
                                      "smollm-360m"])
def test_tree_matches_plain_version_on_card(cuda_device, leaf_set):
    """Whole merges, bitwise against the plain version leaf by leaf: the
    CNN's leaves; mixed f32 / bf16 leaves with empty and one-element
    leaves; every leaf a misaligned view; smollm-360m's 290 leaves.
    Launches equal the chunks (112 non-empty leaves of a dtype each); the
    result is contiguous views of the input shapes and dtypes and the
    inputs are unchanged."""
    from repro_torch.check import grid_race
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    f32 = (lambda k: torch.float32)
    shapes = {**CNN_SHAPES, "empty": (0,), "one": (1,), "ragged": (12345,)}
    names = list(shapes)
    g, l = {
        "cnn": lambda: _tree(CNN_SHAPES, f32, lambda k: 0, gen, cuda_device),
        "mixed": lambda: _tree(
            shapes, lambda k: (torch.float32, torch.bfloat16)[
                names.index(k) % 2], lambda k: 0, gen, cuda_device),
        "misaligned": lambda: _tree(shapes, f32, lambda k: 1, gen,
                                    cuda_device),
        "smollm-360m": lambda: _tree(grid_race.smollm_leaf_shapes(), f32,
                                     lambda k: 0, gen, cuda_device),
    }[leaf_set]()
    small = leaf_set != "smollm-360m"
    before = {k: (g[k].clone(), l[k].clone()) for k in g} if small else {}
    want_launches = sum(
        ops.launches(sum(1 for v in g.values() if v.dtype == dt
                         and v.numel()))
        for dt in {v.dtype for v in g.values()})
    for beta, weight in SCALARS[:2 if small else 1]:
        kernels.reset_launches()
        out = ops.weighted_agg_tree(g, l, beta, weight)
        torch.cuda.synchronize()
        assert ops.KERNEL.launches == want_launches
        assert list(out) == list(g)
        for k, v in out.items():
            assert v.shape == g[k].shape and v.dtype == g[k].dtype
            assert v.is_contiguous() and v.data_ptr() % 16 == 0
            assert torch.equal(_int_view(v), _int_view(
                ref.weighted_agg(g[k], l[k], beta, weight))), k
    for k, (gb, lb) in before.items():
        assert torch.equal(_int_view(g[k]), _int_view(gb))
        assert torch.equal(_int_view(l[k]), _int_view(lb))


# K1 ring_agg: chain lengths the fleet engine gives it and beyond one
# shared-memory coefficient tile; the paper CNN's P, a P ragged against
# any power-of-two tile, a pack count the grid (a multiple of 132 blocks)
# does not divide, and fewer packs than blocks
RING_U = [0, 1, 2, 7, 9, 10, 30, 60, 1500]
RING_P = [422016, 128 * 300, 128 * 1031, 128]


def _ring_inputs(P, U, tdt, gen, device, neg_zero):
    g = torch.randn(P, generator=gen, device=device)
    locs = torch.randn(U, P, generator=gen, device=device).to(tdt)
    c = torch.rand(U, generator=gen, device=device) * 0.5 + 0.5
    coeffs = torch.stack([c, 1.0 - c], dim=1).contiguous()
    if neg_zero:
        g[::7] = -0.0
        if U:
            locs[:, ::7] = 0.0
            coeffs[0] = torch.tensor([1.0, 0.0], device=device)
    return g, locs, coeffs


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ring_agg_matches_plain_version_on_card(cuda_device, tdt):
    """K1 against its plain version, bitwise, with one launch per chain
    and none for an empty one."""
    kernels.reset_launches()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    chains = 0
    for P in RING_P:
        for U in RING_U:
            for neg_zero in (False, True):
                g, locs, coeffs = _ring_inputs(P, U, tdt, gen, cuda_device,
                                               neg_zero)
                out = ops.ring_agg(g, locs, coeffs)
                want = ref.ring_agg(g, locs, coeffs)
                torch.cuda.synchronize()
                assert out.dtype == torch.float32 and out.is_cuda
                assert torch.equal(_int_view(out), _int_view(want)), (
                    P, U, neg_zero)
                assert out.data_ptr() != g.data_ptr()
                chains += U > 0
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": chains, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.cuda
def test_ring_agg_wrapper_raises_on_card(cuda_device):
    """Non-contiguous, misshaped or misaligned inputs raise before any
    launch; nothing falls back to the plain version."""
    kernels.reset_launches()
    P, U = 128 * 4, 3
    g = torch.zeros(P, device=cuda_device)
    locs = torch.zeros(U, P, device=cuda_device)
    coeffs = torch.zeros(U, 2, device=cuda_device)
    buf = torch.zeros(P + 1, device=cuda_device)
    for bad in [(g, torch.zeros(P, U, device=cuda_device).t(), coeffs),
                (g, torch.zeros(U, P + 128, device=cuda_device), coeffs),
                (g, locs, torch.zeros(U, 3, device=cuda_device)),
                (g, locs, coeffs.cpu()),
                (buf[1:], locs, coeffs)]:
        with pytest.raises((ValueError, TypeError)):
            ops.ring_agg(*bad)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}
    ops.ring_agg(g, locs, coeffs)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 1, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


def _expected_chains(name, rounds, eval_every):
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario
    sc = get_scenario(name)
    plan = jit_engine.plan_fleet(sc.channel(), 0, rounds)
    need = jit_engine.needed_rounds(
        plan, jit_engine.eval_rounds_of(rounds, eval_every))
    return sum(len(jit_engine.chain_bounds(s, e, need))
               for _, s, e in plan.waves)


@pytest.mark.cuda
@pytest.mark.parametrize("ring_dtype", ["f32", "bf16"])
def test_fleet_engine_on_card_uses_only_ring_agg(cuda_device, ring_dtype):
    from repro_torch.core.scenarios import run_scenario
    kernels.reset_launches()
    res = run_scenario("quick-k5", engine="jit", rounds=6, eval_every=3,
                       use_kernel=True, ring_dtype=ring_dtype,
                       device=cuda_device)
    assert len(res.rounds) == 6
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": _expected_chains("quick-k5", 6, 3),
        "decode_attention": 0, "swa_attention": 0, "cross_entropy": 0}
    assert all(v.is_cuda and bool(torch.isfinite(v).all())
               for v in res.final_params.values())


@pytest.mark.cuda
def test_event_loop_never_waits_for_the_card(cuda_device, monkeypatch):
    """The event loop between waves (pops, chain coefficients, ring_agg
    chains) runs with CUDA synchronisation made an error."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import run_scenario
    real = jit_engine._event_segment
    segments = []

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segments.append(out[1][0].numel())
        return out

    # build and load the kernel outside the checked region
    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(jit_engine, "_event_segment", strict)
    res = run_scenario("quick-k5", engine="jit", rounds=8,
                       ring_dtype="bf16", device=cuda_device)
    assert sum(segments) == len(res.rounds) == 8 and len(segments) > 1


def _corridor_chains(name, rounds, eval_every):
    from repro_torch.core.jit_engine import eval_rounds_of
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.corridor import engine, plan_corridor
    sc = get_scenario(name)
    plan = plan_corridor(sc.channel(), sc.n_rsus, 0, rounds,
                         entry=sc.corridor_entry)
    return engine.chain_launches(plan, eval_rounds_of(rounds, eval_every),
                                 sc.reconcile_every)


@pytest.mark.cuda
@pytest.mark.parametrize("kw, merges", [
    ({}, 0), ({"ring_dtype": "bf16"}, 0),
    ({"reconcile_mode": "ema", "reconcile_tau": 0.3}, 2),
], ids=["fedavg", "bf16", "ema"])
def test_corridor_on_card_launches_the_plan(cuda_device, kw, merges):
    """corridor-quick-r2-k8: every merge a ring_agg chain, one per chunk
    of the plan; weighted_agg only for the EMA reconcile, once per
    reconcile (rounds 4 and 8)."""
    from repro_torch.core.scenarios import run_scenario
    kernels.reset_launches()
    res = run_scenario("corridor-quick-r2-k8", rounds=8, eval_every=3,
                       use_kernel=True, device=cuda_device, **kw)
    assert len(res.rounds) == 8 and res.scheme == "mafl+corridor"
    assert kernels.launch_counts() == {
        "weighted_agg": merges,
        "ring_agg": _corridor_chains("corridor-quick-r2-k8", 8, 3),
        "decode_attention": 0, "swa_attention": 0, "cross_entropy": 0}
    assert all(v.is_cuda and bool(torch.isfinite(v).all())
               for v in res.final_params.values())


@pytest.mark.cuda
def test_corridor_event_loop_never_waits_for_the_card(cuda_device,
                                                      monkeypatch):
    """The corridor's segments (pops, chain coefficients, ring_agg chains,
    in-place row writes) and its EMA reconciles run with CUDA
    synchronisation made an error."""
    from repro_torch.corridor import engine

    def strict(real, log):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log.append(out)
            return out
        return call

    segments, reconciles = [], []
    # build and load both kernels outside the checked region
    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    ops.weighted_agg(torch.zeros(4, device=cuda_device),
                     torch.zeros(4, device=cuda_device), 0.5, 1.0)
    monkeypatch.setattr(engine, "_chain_segment",
                        strict(engine._chain_segment, segments))
    monkeypatch.setattr(engine, "_reconcile",
                        strict(engine._reconcile, reconciles))
    from repro_torch.core.scenarios import run_scenario
    res = run_scenario("corridor-quick-r2-k8", rounds=8, eval_every=3,
                       use_kernel=True, reconcile_mode="ema",
                       reconcile_tau=0.3, device=cuda_device)
    assert sum(cols[0].numel() for cols in segments) == len(res.rounds) == 8
    assert len(segments) > 2 and len(reconciles) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("engine_name", ["corridor", "serial"])
def test_corridor_on_card_matches_cpu(cuda_device, engine_name):
    """corridor-quick-r2-k8, 8 rounds, one numpy init, card against CPU
    within chip_smoke.py's bands: the same (round, vehicle, rsu) trace,
    times to the f32 band, params to atol 1e-4 / rtol 1e-3, accuracy
    0.02."""
    import dataclasses
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core.scenarios import build_world, get_scenario
    from repro_torch.corridor import (run_corridor_simulation,
                                      run_handover_simulation)
    from repro_torch.models.cnn import CNN_SHAPES

    rng = np.random.default_rng(0)
    init = {k: (np.zeros(s, np.float32) if k.endswith("_b") else
                (rng.normal(size=s) / np.sqrt(np.prod(s[:-1])))
                .astype(np.float32)) for k, s in CNN_SHAPES.items()}
    sc = dataclasses.replace(get_scenario("corridor-quick-r2-k8"), rounds=8)
    veh, ti, tl, p = build_world(sc)
    run = (run_corridor_simulation if engine_name == "corridor"
           else run_handover_simulation)
    gpu, cpu = (run(sc, veh, ti, tl, p, eval_every=4, use_kernel=True,
                    init_params=params_from_jax(init, dev), device=dev)
                for dev in (cuda_device, "cpu"))
    assert ([(r.round, r.vehicle, r.rsu) for r in gpu.rounds]
            == [(r.round, r.vehicle, r.rsu) for r in cpu.rounds])
    np.testing.assert_allclose([r.time for r in gpu.rounds],
                               [r.time for r in cpu.rounds],
                               rtol=2e-5, atol=1e-3)
    pg, pc = params_to_numpy(gpu.final_params), params_to_numpy(
        cpu.final_params)
    for k in pg:
        np.testing.assert_allclose(pg[k], pc[k], atol=1e-4, rtol=1e-3,
                                   err_msg=k)
    for (_, a), (_, b) in zip(gpu.acc_history, cpu.acc_history):
        assert abs(a - b) <= 0.02


# vehicle selection on the card: quick-k5 with an eps-bandit re-scored
# every 3 rounds re-admits at rounds 3 and 6, each between two pops of one
# segment; corridor-quick-r2-k8's bandit re-admits at its reconciles
FLEET_BANDIT = dict(selection="eps-bandit", selection_k=2,
                    selection_eps=0.3, resel_every=3)
CORRIDOR_BANDIT = dict(selection="eps-bandit", selection_k=2,
                       selection_eps=0.4)


def _fleet_selection_plan(rounds, **sel):
    import dataclasses
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario
    sc = dataclasses.replace(get_scenario("quick-k5"), **sel)
    return jit_engine.plan_fleet(sc.channel(), 0, rounds,
                                 selection=sc.selection_spec())


@pytest.mark.cuda
def test_selection_event_loop_never_waits_for_the_card(cuda_device,
                                                       monkeypatch):
    """The fleet engine's segments, with the admission gate and the
    re-admissions between their pops, run with CUDA synchronisation made
    an error; the run's summary is its plan's."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import run_scenario
    real = jit_engine._event_segment
    segments = []

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segments.append((a[4], a[5], sorted(kw["readmits"])))
        return out

    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(jit_engine, "_event_segment", strict)
    res = run_scenario("quick-k5", engine="jit", rounds=12, eval_every=4,
                       device=cuda_device, **FLEET_BANDIT)
    plan = _fleet_selection_plan(12, **FLEET_BANDIT)
    assert res.report.selection == plan.sel.summary()
    assert [r.vehicle for r in res.rounds] == plan.veh.tolist()
    inside = [b for s, e, bs in segments for b in bs if s < b < e]
    assert inside == [3, 6]


@pytest.mark.cuda
def test_corridor_selection_loop_never_waits_for_the_card(cuda_device,
                                                          monkeypatch):
    """The corridor's segments, reconciles and re-admissions under the
    bandit run with CUDA synchronisation made an error."""
    from repro_torch.corridor import engine

    def strict(real, log):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log.append(out)
            return out
        return call

    segments, readmits = [], []
    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(engine, "_chain_segment",
                        strict(engine._chain_segment, segments))
    monkeypatch.setattr(engine._CorridorQueue, "readmit",
                        strict(engine._CorridorQueue.readmit, readmits))
    from repro_torch.core.scenarios import run_scenario
    res = run_scenario("corridor-quick-r2-k8", rounds=12, eval_every=4,
                       use_kernel=True, device=cuda_device,
                       **CORRIDOR_BANDIT)
    assert sum(cols[0].numel() for cols in segments) == len(res.rounds)
    assert len(readmits) == sum(
        1 for _, newly, _ in res.report.selection["decisions"] if newly)
    assert readmits


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["fleet", "corridor"])
def test_selection_on_card_launches_the_plan(cuda_device, world):
    """Every merge of a selection world a ring_agg chain of its plan, and
    no weighted_agg; the bandit guard passes on the card."""
    import dataclasses
    from repro_torch.core.jit_engine import eval_rounds_of
    from repro_torch.core.scenarios import get_scenario, run_scenario
    from repro_torch.corridor import engine, plan_corridor
    from repro_torch.core import jit_engine
    if world == "fleet":
        plan = _fleet_selection_plan(12, **FLEET_BANDIT)
        need = jit_engine.needed_rounds(plan, eval_rounds_of(12, 4))
        want = sum(len(jit_engine.chain_bounds(s, e, need))
                   for _, s, e in plan.waves)
        name, kw = "quick-k5", dict(engine="jit", **FLEET_BANDIT)
    else:
        sc = dataclasses.replace(get_scenario("corridor-quick-r2-k8"),
                                 **CORRIDOR_BANDIT)
        plan = plan_corridor(sc.channel(), 2, 0, 12,
                             selection=sc.selection_spec(),
                             reconcile_every=sc.reconcile_every)
        want = engine.chain_launches(plan, eval_rounds_of(12, 4),
                                     sc.reconcile_every)
        name, kw = "corridor-quick-r2-k8", CORRIDOR_BANDIT
    kernels.reset_launches()
    res = run_scenario(name, rounds=12, eval_every=4, use_kernel=True,
                       device=cuda_device, **kw)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": want, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}
    assert res.report.selection == plan.sel.summary()
    assert all(v.is_cuda and bool(torch.isfinite(v).all())
               for v in res.final_params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["fleet", "corridor"])
def test_bandit_guard_raises_on_card(cuda_device, monkeypatch, world):
    """A perturbed f64 expectation fails the device accumulators' guard."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import run_scenario
    from repro_torch.corridor import engine
    mod, attr = ((jit_engine, "plan_fleet") if world == "fleet"
                 else (engine, "plan_corridor"))
    real = getattr(mod, attr)

    def perturbed(*a, **kw):
        plan = real(*a, **kw)
        rs, rc = (x.copy() for x in plan.sel_bandit)
        rs[int(np.argmax(rc))] += 1e-2
        plan.sel_bandit = (rs, rc)
        return plan

    monkeypatch.setattr(mod, attr, perturbed)
    name, kw = (("quick-k5", dict(engine="jit", **FLEET_BANDIT))
                if world == "fleet"
                else ("corridor-quick-r2-k8", CORRIDOR_BANDIT))
    with pytest.raises(RuntimeError, match="reward accumulators"):
        run_scenario(name, rounds=8, eval_every=8, device=cuda_device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("engine_name", ["jit", "corridor", "serial"])
def test_selection_on_card_matches_cpu(cuda_device, engine_name):
    """Card against CPU from one numpy init: paper-k10 with weighted-topk
    k 5 for 8 rounds on the fleet engine, corridor-quick-r2-k8 with the
    bandit for 12 rounds on both corridor engines: the same summary and
    trace, times in the f32 band, params to atol 1e-4 / rtol 1e-3."""
    import dataclasses
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core.mafl import run_simulation
    from repro_torch.core.scenarios import build_world, get_scenario
    from repro_torch.corridor import (run_corridor_simulation,
                                      run_handover_simulation)
    from repro_torch.models.cnn import CNN_SHAPES
    from repro_torch.selection import SelectionSpec

    rng = np.random.default_rng(0)
    init = {k: (np.zeros(s, np.float32) if k.endswith("_b") else
                (rng.normal(size=s) / np.sqrt(np.prod(s[:-1])))
                .astype(np.float32)) for k, s in CNN_SHAPES.items()}
    if engine_name == "jit":
        sc = get_scenario("paper-k10")
        veh, ti, tl, p = build_world(sc)

        def run(dev):
            return run_simulation(
                veh, ti, tl, scheme=sc.scheme, rounds=8, l_iters=sc.l_iters,
                lr=sc.lr, params=p, eval_every=4, use_kernel=True,
                engine="jit", selection=SelectionSpec("weighted-topk", k=5),
                init_params=params_from_jax(init, dev), device=dev)
    else:
        sc = dataclasses.replace(get_scenario("corridor-quick-r2-k8"),
                                 rounds=12, **CORRIDOR_BANDIT)
        veh, ti, tl, p = build_world(sc)
        fn = (run_corridor_simulation if engine_name == "corridor"
              else run_handover_simulation)

        def run(dev):
            return fn(sc, veh, ti, tl, p, eval_every=4, use_kernel=True,
                      init_params=params_from_jax(init, dev), device=dev)
    gpu, cpu = run(cuda_device), run("cpu")
    assert gpu.report.selection == cpu.report.selection
    assert not all(cpu.report.selection["admit0"])
    assert ([(r.round, r.vehicle, r.rsu) for r in gpu.rounds]
            == [(r.round, r.vehicle, r.rsu) for r in cpu.rounds])
    np.testing.assert_allclose([r.time for r in gpu.rounds],
                               [r.time for r in cpu.rounds],
                               rtol=2e-5, atol=1e-3)
    pg, pc = params_to_numpy(gpu.final_params), params_to_numpy(
        cpu.final_params)
    for k in pg:
        np.testing.assert_allclose(pg[k], pc[k], atol=1e-4, rtol=1e-3,
                                   err_msg=k)
    for (_, a), (_, b) in zip(gpu.acc_history, cpu.acc_history):
        assert abs(a - b) <= 0.02


# K4 decode_attention and K5 swa_attention against their plain versions:
# f32 inputs from N(0, 1) within 2e-5 (the online softmax sums in another
# order than the dense plain version), bf16 within 3e-2 (the plain version
# rounds scores and weights to bf16, the kernel keeps them in f32)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _attn_max_err(out, want):
    assert out.dtype == want.dtype and out.shape == want.shape
    return (out.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 5, 8])
def test_decode_attention_matches_plain_version_on_card(cuda_device, tdt,
                                                        hd, G):
    """K4 at pos = 0, the kv tile's edges 63, 64, 65, S - 1 and a mixed
    per-row vector, with the live prefix split over many chunks (small
    batch), a few (the serve shape) and one (large batch)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    gen = torch.Generator(device=cuda_device).manual_seed(G * hd)
    kernels.reset_launches()
    calls = 0
    for B, S, Kv in [(2, 1000, 2), (8, 2048, 5), (512, 300, 5)]:
        q = torch.randn(B, G * Kv, hd, generator=gen,
                        device=cuda_device).to(tdt)
        k, v = (torch.randn(B, S, Kv, hd, generator=gen,
                            device=cuda_device).to(tdt) for _ in range(2))
        mixed = torch.randint(0, S, (B,), generator=gen, device=cuda_device,
                              dtype=torch.int32)
        for pos in (0, 63, 64, 65, S - 1, mixed):
            out = dops.decode_attention(q, k, v, pos)
            want = dref.decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            assert _attn_max_err(out, want) <= ATTN_TOL[tdt], (B, S, pos)
            calls += 1
    assert kernels.launch_counts()["decode_attention"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_attention_writes_its_declared_ranges_on_card(cuda_device,
                                                             tdt):
    """K4's chunk and combine launches into NaN-filled outputs write
    exactly what ``ops.geometry`` declares, whatever ``pos`` is: a block
    whose share is empty writes the neutral state."""
    import math
    from repro_torch.kernels.decode_attention import ops as dops
    B, S, H, Kv, hd = 3, 640, 6, 2, 64
    n = dops.split(B, S, Kv)
    chunk_geo, combine_geo = dops.geometry(B, S, H, Kv, hd)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(B, H, hd, generator=gen, device=cuda_device).to(tdt)
    k, v = (torch.randn(B, S, Kv, hd, generator=gen,
                        device=cuda_device).to(tdt) for _ in range(2))
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for pos in ([0, 0, 0], [S - 1] * 3, [64, 5, S - 2]):
        posv = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
        out = torch.full((B * H * hd,), float("nan"), device=cuda_device,
                         dtype=tdt)
        part = torch.full((dops.part_size(B, H, hd, n),), float("nan"),
                          device=cuda_device)
        fn = "decode_attention_f32" if tdt == torch.float32 \
            else "decode_attention_bf16"
        dops.KERNEL.launch(fn, cuda_device, out.data_ptr(), part.data_ptr(),
                           q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           posv.data_ptr(), B, S, H, Kv, hd, n,
                           1.0 / math.sqrt(hd), stream)
        torch.cuda.synchronize()
        assert np.array_equal(~torch.isnan(part).cpu().numpy(),
                              chunk_geo.written("part")), pos
        assert np.array_equal(~torch.isnan(out).cpu().numpy(),
                              combine_geo.written("out")), pos


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3])
def test_swa_attention_matches_plain_version_on_card(cuda_device, tdt, G):
    """K5 at window = S, windows under S (one not a multiple of the 64-row
    tile) and S not a multiple of the tile."""
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    gen = torch.Generator(device=cuda_device).manual_seed(G)
    kernels.reset_launches()
    calls = 0
    for B, S, Kv, hd in [(1, 256, 5, 64), (2, 200, 2, 128), (1, 33, 1, 64)]:
        q = torch.randn(B, S, G * Kv, hd, generator=gen,
                        device=cuda_device).to(tdt)
        k, v = (torch.randn(B, S, Kv, hd, generator=gen,
                            device=cuda_device).to(tdt) for _ in range(2))
        for window in (S, 64, 45, 1, 10 * S):
            out = sops.swa_attention(q, k, v, window)
            want = sref.swa_attention(q, k, v, window)
            torch.cuda.synchronize()
            assert _attn_max_err(out, want) <= ATTN_TOL[tdt], (B, S, window)
            calls += 1
    assert kernels.launch_counts()["swa_attention"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 5])
def test_swa_attention_bf16_tensor_cores_on_card(cuda_device, G, hd):
    """K5's bf16 kernel (tensor cores, the G heads of a kv head in one
    block) within 3e-2 of its plain version at S 33, 200 and 1024 and
    windows S, 64, 45 and 1."""
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    gen = torch.Generator(device=cuda_device).manual_seed(10 * G + hd)
    kernels.reset_launches()
    calls = 0
    for B, S, Kv in [(1, 33, 1), (2, 200, 2), (1, 1024, 5)]:
        q = torch.randn(B, S, G * Kv, hd, generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        k, v = (torch.randn(B, S, Kv, hd, generator=gen, device=cuda_device)
                .to(torch.bfloat16) for _ in range(2))
        for window in (S, 64, 45, 1):
            out = sops.swa_attention(q, k, v, window)
            want = sref.swa_attention(q, k, v, window)
            torch.cuda.synchronize()
            assert _attn_max_err(out, want) <= ATTN_TOL[torch.bfloat16], (
                B, S, window)
            calls += 1
    assert kernels.launch_counts()["swa_attention"] == calls


@pytest.mark.cuda
def test_attention_wrappers_reject_on_card(cuda_device):
    """A CPU/CUDA mix, an unsupported dtype or head dim and a
    non-contiguous input raise before any launch; nothing falls back to
    the plain version."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.swa_attention import ops as sops
    kernels.reset_launches()
    q = torch.zeros(2, 6, 64, device=cuda_device)
    k = torch.zeros(2, 32, 2, 64, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for bad in [(q, k.cpu(), k, pos), (q, k, k, pos.cpu()),
                (q.half(), k.half(), k.half(), pos),
                (q[:, :, :32], k[..., :32], k[..., :32], pos),
                (q, k.transpose(1, 2).contiguous().transpose(1, 2), k, pos),
                (torch.zeros(2, 18, 64, device=cuda_device), k, k, pos)]:
        with pytest.raises((ValueError, TypeError)):
            dops.decode_attention(*bad)
    qs = torch.zeros(1, 32, 6, 64, device=cuda_device)
    ks = torch.zeros(1, 32, 2, 64, device=cuda_device)
    for bad in [(qs, ks.cpu(), ks, 32), (qs.half(), ks.half(), ks.half(), 32),
                (qs.transpose(1, 2).contiguous().transpose(1, 2), ks, ks, 32),
                (qs[..., :32], ks[..., :32], ks[..., :32], 32)]:
        with pytest.raises((ValueError, TypeError)):
            sops.swa_attention(*bad)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.cuda
def test_reduced_serve_launches_only_the_attention_kernels(cuda_device):
    """A reduced smollm-360m server on the card: one ``swa_attention`` per
    layer per admitted request, one ``decode_attention`` per layer per
    tick, no other kernel, and the same tokens as on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import BatchedServer
    cfg = get_config("smollm-360m").reduced().variant(n_heads=6,
                                                      n_kv_heads=2)
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 70, 9)]
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        srv = BatchedServer(cfg, model.to(dev), n_slots=2, max_seq=96)
        reqs = [srv.submit(p, max_new=6) for p in prompts]
        kernels.reset_launches()
        ticks = srv.run_until_drained()
        counts = kernels.launch_counts()
        outs[dev.type] = [r.out for r in reqs]
        if dev.type == "cuda":
            assert counts == {"weighted_agg": 0, "ring_agg": 0,
                              "decode_attention": cfg.n_layers * ticks,
                              "swa_attention": cfg.n_layers * len(prompts),
                              "cross_entropy": 0}
        else:
            assert not any(counts.values())
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_decode_step_never_waits_for_the_card(cuda_device):
    """A decode step (cache writes at a pos vector, K4, the MLPs) runs with
    CUDA synchronisation made an error."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-360m").reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device=cuda_device)
    cache = T.init_cache(cfg, 3, 64, device=cuda_device)
    token = torch.zeros(3, 1, dtype=torch.int32, device=cuda_device)
    pos = torch.tensor([0, 5, 63], dtype=torch.int32, device=cuda_device)
    T.decode_step(cfg, model, token, cache, pos)     # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = T.decode_step(cfg, model, token, cache, pos)
        logits, _ = T.decode_step(cfg, model, token, cache, 7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


# the dense archs' serving (ring caches, QKV biases, frontends): card
# against CPU within chip_smoke.py's SERVE_CPU_TOL (f32 products summed in
# another order, a few ulps per layer on logits of size ~1)
ARCH_CPU_TOL = dict(atol=1e-3, rtol=1e-3)


# bf16 at mistral's heads: rows average over up to W keys, so the bar
# scales with each output row, as chip_smoke.py's ARCH_BF16_TOL: |out -
# want| <= 2e-2 x the row's RMS + 1.6e-2 x |want|, want in f32 on the same
# bf16 inputs, rounded to bf16
ARCH_BF16_TOL = {"row_rms": 2e-2, "rtol": 1.6e-2}


def _ring_attn_ok(out, want, tdt):
    """f32: ``ATTN_TOL``; bf16: ``ARCH_BF16_TOL``, scaled per row."""
    assert out.dtype == want.dtype and out.shape == want.shape
    if tdt == torch.float32:
        return _attn_max_err(out, want) <= ATTN_TOL[tdt]
    want = want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    bar = ARCH_BF16_TOL["row_rms"] * rms + ARCH_BF16_TOL["rtol"] * want.abs()
    return bool(((out.float() - want).abs() <= bar).all())


def _ring_bias(pos, W, mask_kind):
    """repro's decode mask over a ring of W slots, as an additive bias."""
    idx = torch.arange(W)
    slot = pos % W
    ok = (pos - (slot - idx) % W >= 0) if mask_kind == "swa" else idx <= slot
    return torch.where(ok, 0.0, -1e30).reshape(1, 1, 1, W)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_masks_at_mistral_geometry_on_card(cuda_device, tdt):
    """K5 with a true window (W 256 < S 640) and through the chunk reshape
    (chunks of 256 as rows of a B * 3 batch, the last padded), at
    mistral-nemo-12b's heads (32 / 8, hd 128), against the dense masked
    softmax of ``repro``'s bias."""
    from repro_torch.models import attention as A
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B, S, H, Kv, hd, W = 2, 640, 32, 8, 128, 256
    q = torch.randn(B, S, H, hd, generator=gen, device=cuda_device).to(tdt)
    k, v = (torch.randn(B, S, Kv, hd, generator=gen,
                        device=cuda_device).to(tdt) for _ in range(2))
    pos = torch.arange(S, device=cuda_device)
    kernels.reset_launches()
    for kind in ("swa", "chunk"):
        out = A._prefill_attention(q, k, v, kind, W)
        want = A._sdpa(q.float(), k.float(), v.float(),
                       A._causal_bias(pos, pos, kind, W)).to(tdt)
        torch.cuda.synchronize()
        assert _ring_attn_ok(out, want, tdt), kind
    assert kernels.launch_counts()["swa_attention"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_over_rings_on_card(cuda_device, tdt, G):
    """K4 over a ring of W 256 slots (hd 128) at ``pos'`` computed on the
    card (``min(pos, W - 1)`` for swa, ``pos % W`` for chunk), at positions
    before, at and past the wrap, against the masked softmax of
    ``repro``'s ring bias."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models import attention as A
    gen = torch.Generator(device=cuda_device).manual_seed(G)
    B, Kv, hd, W = 2, 8, 128, 256
    q = torch.randn(B, 1, G * Kv, hd, generator=gen,
                    device=cuda_device).to(tdt)
    k, v = (torch.randn(B, W, Kv, hd, generator=gen,
                        device=cuda_device).to(tdt) for _ in range(2))
    kernels.reset_launches()
    calls = 0
    for kind in ("swa", "chunk"):
        for p in (5, W - 1, W, W + 63, 3 * W + 7):
            pos = torch.tensor(p, dtype=torch.int32, device=cuda_device)
            live = pos.clamp(max=W - 1) if kind == "swa" else pos % W
            out = dops.decode_attention(q[:, 0], k, v, live)
            want = A._sdpa(q.float(), k.float(), v.float(),
                           _ring_bias(p, W, kind).to(cuda_device))
            torch.cuda.synchronize()
            assert _ring_attn_ok(out, want[:, 0].to(tdt), tdt), (kind, p)
            calls += 1
    assert kernels.launch_counts()["decode_attention"] == calls


def _arch_cfgs():
    from repro_torch.configs import get_config
    from repro_torch.configs.mistral_nemo_12b import sliding_window_variant
    mistral = get_config("mistral-nemo-12b").reduced()
    return {"swa": sliding_window_variant().reduced(),
            "chunk": mistral.variant(attn_chunk=64, global_attn_every=2,
                                     scan_period=2, n_layers=4),
            "qwen": get_config("qwen1.5-4b").reduced(),
            "musicgen": get_config("musicgen-large").reduced(),
            "internvl2": get_config("internvl2-2b").reduced()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["swa", "chunk", "qwen", "musicgen",
                                  "internvl2"])
def test_reduced_archs_on_card_match_cpu(cuda_device, case):
    """Prefill of 80 tokens (past the window of 64) and 16 teacher-forced
    decode steps, card against CPU from one CPU init: K5 once per layer
    per prefill, K4 once per layer per step."""
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import VisionFrontendStub
    cfg = _arch_cfgs()[case]
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for m in cpu.modules():               # non-zero QKV biases
        for name in ("bq", "bk", "bv"):
            b = getattr(m, name, None)
            if b is not None:
                b.copy_(torch.randn(b.shape, generator=torch.Generator()
                                    .manual_seed(1)) * 0.1)
    gpu = T.init_params(cfg, torch.Generator().manual_seed(0),
                        device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int64))
    fe = None
    if cfg.frontend == "vision":
        fe = VisionFrontendStub(cfg)(torch.Generator().manual_seed(2), 2)
    start = 80 + (cfg.n_frontend_tokens if fe is not None else 0)
    kernels.reset_launches()
    lc, cc = T.prefill(cfg, cpu, prompt, fe)
    lg, cg = T.prefill(cfg, gpu, prompt.to(cuda_device),
                       None if fe is None else fe.to(cuda_device))
    assert torch.allclose(lg.cpu(), lc, **ARCH_CPU_TOL)
    cc = T.grow_cache(cfg, cc, 2, start + 16)
    cg = T.grow_cache(cfg, cg, 2, start + 16)
    forced = torch.argmax(lc[:, -1:], -1)
    for i in range(16):
        lc, cc = T.decode_step(cfg, cpu, forced, cc, start + i)
        lg, cg = T.decode_step(cfg, gpu, forced.to(cuda_device), cg,
                               start + i)
        assert torch.allclose(lg.cpu(), lc, **ARCH_CPU_TOL), i
        forced = torch.argmax(lc, -1)
    counts = kernels.launch_counts()
    assert counts["swa_attention"] == cfg.n_layers
    assert counts["decode_attention"] == 16 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["swa", "chunk"])
def test_ring_decode_step_never_waits_for_the_card(cuda_device, case):
    """A decode step over ring caches (the slot and ``pos'`` computed on
    the card) runs with CUDA synchronisation made an error."""
    from repro_torch.models import transformer as T
    cfg = _arch_cfgs()[case]
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device=cuda_device)
    cache = T.init_cache(cfg, 2, 200, device=cuda_device)
    token = torch.zeros(2, 1, dtype=torch.int32, device=cuda_device)
    T.decode_step(cfg, model, token, cache, 0)       # builds the kernel
    on_card = torch.tensor(130, dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pos in (70, on_card):
            logits, _ = T.decode_step(cfg, model, token, cache, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


# K3 cross_entropy against its plain version: nll and lse within 1e-4 in
# f32 (repro's bar for its kernel, tests/test_kernels.py) and 3e-2 in bf16;
# rows of +-1e4 logits within 1e-3 (repro's bar for them: lse ~ 1e4, where
# one f32 ulp is 1e-3); the backward's d logits within 1e-6 of plain
# autograd in f32
CE_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
CE_EXTREME_TOL = 1e-3
CE_GRAD_TOL = 1e-6


def _ce_inputs(R, V, tdt, gen, device):
    x = (torch.randn(R, V, generator=gen, device=device) * 3).to(tdt)
    y = torch.randint(0, V, (R,), generator=gen, device=device)
    y[0] = 0
    y[-1] = V - 1
    return x, y


def _ce_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cross_entropy_matches_plain_version_on_card(cuda_device, tdt):
    """K3's (nll, lse) at small, ragged (V = 1111: rows not 16-byte
    aligned) and smollm-360m vocab widths, labels at 0, V - 1 and random,
    and rows of +-1e4 logits."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    from repro_torch.kernels.cross_entropy import ref as ce_ref
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    kernels.reset_launches()
    calls = 0
    for R in (1, 7, 512):
        for V in (512, 1111, 49152):
            x, y = _ce_inputs(R, V, tdt, gen, cuda_device)
            got = ce_ops.nll_and_lse(x, y)
            torch.cuda.synchronize()
            assert all(t.dtype == torch.float32 and t.shape == (R,)
                       for t in got)
            assert _ce_err(got, ce_ref.nll_and_lse(x, y)) <= CE_TOL[tdt], \
                (R, V)
            calls += 1
    for V in (512, 1111):
        x = torch.tensor([1e4, -1e4, 0.0, 5.0], device=cuda_device).repeat(
            8, V // 4 + 1)[:, :V].contiguous().to(tdt)
        y = torch.tensor([0, 1, 2, 3, V - 1, 0, 1, 2], device=cuda_device)
        got = ce_ops.nll_and_lse(x, y)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in got)
        assert _ce_err(got, ce_ref.nll_and_lse(x, y)) <= CE_EXTREME_TOL
        calls += 1
    assert kernels.launch_counts()["cross_entropy"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("R,V", [(7, 1111), (512, 49152)])
def test_cross_entropy_backward_matches_autograd_on_card(cuda_device, R, V):
    """d logits of the kernel-backed ``lm_loss`` against plain autograd of
    ``log_softmax`` on the same f32 logits."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    x, y = _ce_inputs(R, V, torch.float32, gen, cuda_device)
    grads = []
    for use_kernel in (True, False):
        xl = x.clone().requires_grad_()
        loss = ce_ops.lm_loss(xl[None], y[None], use_kernel=use_kernel)
        grads.append(torch.autograd.grad(loss, xl)[0])
    assert (grads[0] - grads[1]).abs().max().item() <= CE_GRAD_TOL


@pytest.mark.cuda
def test_cross_entropy_wrapper_rejects_on_card(cuda_device):
    """A CPU/CUDA mix, an unsupported dtype, a misshaped or
    non-contiguous input raise before any launch; nothing falls back to
    the plain version."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    kernels.reset_launches()
    x = torch.zeros(4, 64, device=cuda_device)
    y = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    for bad in [(x, y.cpu()), (x.half(), y), (x, y.float()), (x[0], y),
                (x, y[:3]), (torch.zeros(64, 4, device=cuda_device).t(), y),
                (x[:, :0], y)]:
        with pytest.raises((ValueError, TypeError)):
            ce_ops.nll_and_lse(*bad)
    assert kernels.launch_counts()["cross_entropy"] == 0
    ce_ops.nll_and_lse(x, y.long())
    assert kernels.launch_counts()["cross_entropy"] == 1


@pytest.mark.cuda
def test_train_step_never_waits_for_the_card(cuda_device):
    """A full-width-shaped train step (smollm-360m's widths cut to 2
    layers, B 8, S 64) and the loop's kernel merge run with CUDA
    synchronisation made an error; K3 launches once per step."""
    from repro_torch.configs import get_config
    from repro_torch.core.aggregation import mafl_update
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-360m").variant(n_layers=2)
    model = T.init_params(cfg, torch.Generator(device=cuda_device)
                          .manual_seed(0), device=cuda_device)
    step = make_train_step(cfg, lr=0.05)
    tokens = torch.randint(0, cfg.vocab_size, (8, 65), device=cuda_device)
    params, _ = step(model, T.param_dict(model), {"tokens": tokens})
    torch.cuda.synchronize()                     # kernels built and loaded
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, metrics = step(model, params, {"tokens": tokens})
        merged = mafl_update(T.param_dict(model), params, 0.5, 0.8719,
                             use_kernel=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launch_counts() == {
        "weighted_agg": ops.launches(len(params)), "ring_agg": 0,
        "decode_attention": 0, "swa_attention": 0, "cross_entropy": 1}
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(v).all()) for v in merged.values())


@pytest.mark.cuda
def test_reduced_training_on_card_matches_cpu(cuda_device):
    """``launch/train.py``'s loop on smollm-360m reduced, on the card and
    on the CPU from one init: the same vehicles, losses and final model
    within the f32 band of ``chip_smoke.py``'s card-vs-CPU check, K3 once
    per local step and held-out eval, K2 once per 112 leaves per merge."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    cfg = get_config("smollm-360m").reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    args = train.build_parser().parse_args(
        ["--reduced", "--rounds", "5", "--l-iters", "2", "--use-kernel"])
    runs = {}
    for dev, model in ((cuda_device, copy.deepcopy(cpu).to(cuda_device)),
                       (torch.device("cpu"), cpu)):
        kernels.reset_launches()
        runs[dev.type] = train.run_training(cfg, model, args,
                                            log=lambda *a: None)
        counts = kernels.launch_counts()
        if dev.type == "cuda":
            assert counts["cross_entropy"] == 5 * 2 + 1
            assert counts["weighted_agg"] == ops.launches(
                len(T.param_dict(model))) * 5
        else:
            assert not any(counts.values())
    g, c = runs["cuda"], runs["cpu"]
    assert g.vehicles == c.vehicles
    np.testing.assert_allclose([float(v) for v in g.local_losses],
                               [float(v) for v in c.local_losses], rtol=1e-4)
    for k, v in c.params.items():
        torch.testing.assert_close(g.params[k].cpu(), v, atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("R, U", [(2, 2), (512, 3), (4096, 7)])
def test_racy_sum_one_row_tile_matches_plain_version(cuda_device, R, U):
    """F1 with one row tile has one block per column: no race, and on
    integer-valued f32 inputs the sum is exact in any order."""
    from repro_torch.check.corpus import racy_kernel
    x = torch.from_numpy(np.random.default_rng(R).integers(
        -100, 100, (R, U)).astype(np.float32)).to(cuda_device)
    before = racy_kernel.KERNEL.launches
    got = racy_kernel.racy_sum(x, block_rows=R)
    torch.cuda.synchronize()
    assert racy_kernel.KERNEL.launches == before + 1
    assert racy_kernel.KERNEL not in kernels.KERNELS
    assert torch.equal(got, racy_kernel.plain_sum(x, block_rows=R))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_id", [
    "weighted_agg.weighted_agg", "weighted_agg.ring_agg",
    "weighted_agg.ring_agg_worlds",
    "cross_entropy.nll_and_lse", "decode_attention.decode_attention",
    "swa_attention.swa_attention", "swa_attention.swa_attention_bf16"])
def test_geometry_exports_match_python_grids(cuda_device, kernel_id):
    """Each ``.cu``'s ``<name>_geometry`` export gives the grids its
    ``ops.geometry`` declares, at the registered case and at every
    main-path shape."""
    from repro_torch.check import grid_race
    case = grid_race.KERNEL_CASES[kernel_id]
    shapes = [("case", case.args)] + grid_race.main_path_shapes()[kernel_id]
    for label, args in shapes:
        assert case.grids(*args) == [g.dim3 for g in case.launches(*args)], \
            label


@pytest.mark.cuda
def test_racy_sum_geometry_export_matches_python_grid(cuda_device):
    from repro_torch.check.corpus import racy_kernel
    for args in ((8, 2, 2), (2, 2, 2), (8192, 2, 2)):
        assert racy_kernel.cu_grids(*args) == [
            g.dim3 for g in racy_kernel.geometry(*args)]


# fault injection on the card: a churn-heavy spec that drops, blacks out,
# recovers, truncates and discards within a dozen quick-k5 rounds
FLEET_HEAVY = dict(faults="flaky", faults_overrides=(
    ("p_dropout", 0.25), ("p_blackout", 0.15), ("blackout_mean", 20.0),
    ("p_partial", 0.5), ("straggler_frac", 0.4), ("straggler_mult", 3.0),
    ("staleness_cap", 4), ("recheck_every", 3)))


@pytest.mark.cuda
def test_fault_event_loop_never_waits_for_the_card(cuda_device,
                                                   monkeypatch):
    """The fleet engine's segments under faults (the folded admission
    gate, recovery re-admissions between pops, the keep fold on the chain
    coefficients) run with CUDA synchronisation made an error; the waves
    take the partial trainer; the summary is the host replay's."""
    import dataclasses
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario, run_scenario
    from repro_torch.faults import replay_fleet_faults, scenario_faults
    real = jit_engine._event_segment
    segments = []

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segments.append(a[0].keep is not None and a[0].epochs is not None)
        return out

    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(jit_engine, "_event_segment", strict)
    res = run_scenario("quick-k5", engine="jit", rounds=12, eval_every=4,
                       device=cuda_device, **FLEET_HEAVY)
    sc = dataclasses.replace(get_scenario("quick-k5"), **FLEET_HEAVY)
    want = replay_fleet_faults(sc.channel(), 0, 12, scenario_faults(sc),
                               l_iters=sc.l_iters).summary(sc.l_iters)
    assert res.extras["faults"] == want and segments and all(segments)
    assert want["readmits"] and want["counts"]["partial_rounds"]


@pytest.mark.cuda
def test_fleet_k1000_flaky_on_card_matches_its_replay(cuda_device):
    """fleet-k1000-flaky at its registered size on the fleet engine: the
    summary is a host replay's, every merge a ring_agg chain of the plan
    (cap discards stay in their chains as no-ops), no weighted_agg."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario, run_scenario
    from repro_torch.faults import replay_fleet_faults, scenario_faults
    sc = get_scenario("fleet-k1000-flaky")
    spec = scenario_faults(sc)
    plan = jit_engine.plan_fleet(sc.channel(), 0, sc.rounds, faults=spec,
                                 l_iters=sc.l_iters)
    need = jit_engine.needed_rounds(
        plan, jit_engine.eval_rounds_of(sc.rounds, 10))
    want = sum(len(jit_engine.chain_bounds(s, e, need))
               for _, s, e in plan.waves)
    kernels.reset_launches()
    res = run_scenario("fleet-k1000-flaky", engine="jit", eval_every=10,
                       use_kernel=True, device=cuda_device)
    assert kernels.launch_counts()["ring_agg"] == want
    assert kernels.launch_counts()["weighted_agg"] == 0
    replay = replay_fleet_faults(sc.channel(), 0, sc.rounds, spec,
                                 l_iters=sc.l_iters)
    assert res.extras["faults"] == replay.summary(sc.l_iters)
    assert [r.vehicle for r in res.rounds] == plan.veh.tolist()
    assert all(v.is_cuda and bool(torch.isfinite(v).all())
               for v in res.final_params.values())


def _channels_equal_replay(res, name, rounds, **fields):
    """The run's channels against the port's own f64 replay: histogram,
    occupancy, handovers exactly, the pop wait within rtol 1e-4 / atol
    1e-3."""
    import dataclasses
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.faults import scenario_faults
    from repro_torch.telemetry.replay import (replay_corridor_channels,
                                              replay_fleet_channels)
    from repro_torch.telemetry.spec import resolve_metrics, stale_histogram
    sc = dataclasses.replace(get_scenario(name), **fields)
    kw = dict(selection=sc.selection_spec(), faults=scenario_faults(sc),
              l_iters=sc.l_iters)
    if sc.n_rsus > 1:
        rep = replay_corridor_channels(
            sc.channel(), sc.n_rsus, 0, rounds, entry=sc.corridor_entry,
            reconcile_every=sc.reconcile_every, **kw)
    else:
        rep = replay_fleet_channels(sc.channel(), 0, rounds, **kw)
    spec = resolve_metrics("on", stale=rep["stale"], times=rep["times"],
                           n_rsus=sc.n_rsus)
    ch = res.report.channels
    assert res.report.spec["edges"] == list(spec.edges)
    assert np.array_equal(ch["stale_hist"], stale_histogram(
        spec.edges, rep["stale"], rsu=rep.get("up_rsu"), n_rsus=sc.n_rsus))
    assert np.array_equal(ch["occupancy"], rep["occupancy"])
    np.testing.assert_allclose(ch["gap"], rep["gap"], rtol=1e-4, atol=1e-3)
    if sc.n_rsus > 1:
        assert np.array_equal(np.asarray(ch["handover"], bool),
                              rep["handover"])
        assert np.array_equal(ch["handover_count"], rep["handover_count"])


@pytest.mark.cuda
@pytest.mark.parametrize("engine_name", ["jit", "corridor"])
def test_metrics_event_loop_never_waits_for_the_card(cuda_device,
                                                     monkeypatch,
                                                     engine_name):
    """With metrics on, the device engines' segments (pops with the
    telemetry fold, chain coefficients, ring_agg chains) run with CUDA
    synchronisation made an error; the channels equal the f64 replay and
    the bf16 ring guard counts no non-finite row."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import run_scenario
    from repro_torch.corridor import engine
    module, fn = ((jit_engine, "_event_segment") if engine_name == "jit"
                  else (engine, "_chain_segment"))
    real = getattr(module, fn)
    segments = []

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segments.append(kw["mst"] is not None)
        return out

    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(module, fn, strict)
    name = "quick-k5" if engine_name == "jit" else "corridor-quick-r2-k8"
    res = run_scenario(name, engine=engine_name, rounds=8, eval_every=4,
                       ring_dtype="bf16", metrics="on", device=cuda_device)
    assert segments and all(segments)
    _channels_equal_replay(res, name, 8)
    assert int(res.report.channels["ring_nonfinite"]) == 0
    assert {"device_bytes_in_use", "device_peak_bytes_in_use",
            "device_bytes_limit"} <= set(res.report.memory)


@pytest.mark.cuda
def test_fleet_k1000_flaky_fault_counts_on_card(cuda_device):
    """fleet-k1000-flaky at its registered size on the fleet engine with
    metrics on: the device's fault counters pass the engine's guard and
    equal the host replay's counts; the launches, trace and params are the
    metrics-off run's."""
    from repro_torch.core.scenarios import get_scenario, run_scenario
    from repro_torch.faults import replay_fleet_faults, scenario_faults
    sc = get_scenario("fleet-k1000-flaky")
    runs = []
    for metrics in (None, "on"):
        kernels.reset_launches()
        res = run_scenario("fleet-k1000-flaky", engine="jit", eval_every=10,
                           use_kernel=True, device=cuda_device,
                           metrics=metrics)
        runs.append((res, kernels.launch_counts()))
    (off, c_off), (on, c_on) = runs
    assert c_on == c_off
    replay = replay_fleet_faults(sc.channel(), 0, sc.rounds,
                                 scenario_faults(sc), l_iters=sc.l_iters)
    want = replay.counts_table(sc.l_iters).sum(0)
    assert np.array_equal(on.report.channels["fault_counts"], want)
    assert want[3] > 0
    assert ([(r.vehicle, r.time) for r in on.rounds]
            == [(r.vehicle, r.time) for r in off.rounds])
    assert all(torch.allclose(on.final_params[k], off.final_params[k],
                              rtol=0.0, atol=1e-6) for k in off.final_params)
    _channels_equal_replay(on, "fleet-k1000-flaky", sc.rounds)


# the sweep tier: K1 with a world axis, and the sweep engine on the card
@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_ring_agg_world_axis_matches_per_world_launches(cuda_device, tdt,
                                                        W):
    """One world-axis launch over a ``[W, U, P]`` view of a ``[W, M, P]``
    buffer (world stride ``M * P``) is bitwise W one-world launches on the
    slices and the plain version, signed zeros and a (1, 0) step
    included."""
    gen = torch.Generator(device=cuda_device).manual_seed(W)
    for P, M, a, b in ((422016, 12, 2, 12), (128 * 1031, 5, 1, 4),
                       (128, 3, 0, 3)):
        U = b - a
        g = torch.randn(W, P, generator=gen, device=cuda_device)
        g[:, ::7] = -0.0
        buf = torch.randn(W, M, P, generator=gen, device=cuda_device).to(tdt)
        buf[:, :, ::7] = 0.0
        c = torch.rand(W, U, generator=gen, device=cuda_device) * 0.5 + 0.5
        coeffs = torch.stack([c, 1.0 - c], dim=2).contiguous()
        coeffs[:, 0] = torch.tensor([1.0, 0.0], device=cuda_device)
        locs = buf[:, a:b]
        kernels.reset_launches()
        out = ops.ring_agg(g, locs, coeffs)
        assert kernels.launch_counts()["ring_agg"] == 1
        want = ref.ring_agg(g, locs, coeffs)
        ones = [ops.ring_agg(g[w], locs[w], coeffs[w]) for w in range(W)]
        torch.cuda.synchronize()
        assert out.shape == (W, P) and out.dtype == torch.float32
        assert torch.equal(_int_view(out), _int_view(want)), (P, W)
        for w in range(W):
            assert torch.equal(_int_view(out[w]), _int_view(ones[w])), (P, w)
        assert not torch.signbit(out[:, ::7]).any()


def _quick_grid(**kw):
    from repro_torch.core.scenarios import SweepSpec
    return SweepSpec(scenario="quick-k5", seeds=(0, 1),
                     variants=tuple((("channel_overrides", (("beta", b),)),)
                                    for b in (0.3, 0.7)),
                     overrides=(("rounds", 8),), eval_every=4, **kw)


@pytest.mark.cuda
def test_sweep_event_loop_never_waits_for_the_card(cuda_device,
                                                   monkeypatch):
    """The sweep's segments (every world's pops, the per-world
    re-admissions, chain coefficients, one world-axis ring_agg chain) run
    with CUDA synchronisation made an error, selection worlds included."""
    import dataclasses
    from repro_torch.core import sweep
    from repro_torch.core.scenarios import get_scenario
    real = sweep._event_segment
    pops = []

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pops.append(out[1][0].shape)
        return out

    ops.ring_agg(*_ring_inputs(128, 1, torch.float32,
                               torch.Generator(device=cuda_device),
                               cuda_device, False))
    monkeypatch.setattr(sweep, "_event_segment", strict)
    base = dataclasses.replace(get_scenario("quick-k5"), rounds=12)
    worlds = [(base, 0), (dataclasses.replace(
        base, selection="eps-bandit", selection_k=2, selection_eps=0.3,
        resel_every=4), 1), (dataclasses.replace(
            base, selection="weighted-topk", selection_k=3,
            resel_every=4, channel_overrides=(("beta", 0.7),)), 0)]
    res = sweep.run_simulation_vmap(worlds, eval_every=6,
                                    device=cuda_device)
    assert sum(n for _, n in pops) == 12 and {w for w, _ in pops} == {3}
    assert len(pops) > 1 and all(len(r.rounds) == 12 for r in res)


@pytest.mark.cuda
def test_sweep_grid_on_card_matches_solo_runs(cuda_device):
    """quick-k5, 2 betas x 2 seeds (8 rounds) on the card: one ring_agg
    launch per union chain for all four worlds, each world's trace
    bitwise its solo ``jit`` run on the card, params within atol 1e-4 /
    rtol 1e-3 (each seed's betas share a timeline group, so they train
    as one batched call)."""
    from repro_torch.core import jit_engine, sweep
    from repro_torch.core.scenarios import run_sweep
    spec = _quick_grid()
    plans = [jit_engine.plan_fleet(sc.channel(), seed, 8)
             for sc, seed in spec.worlds()]
    want = len(sweep.chain_ends(plans, jit_engine.eval_rounds_of(8, 4)))
    kernels.reset_launches()
    vm = run_sweep(spec, device=cuda_device)
    assert kernels.launch_counts()["ring_agg"] == want
    solo = run_sweep(spec, engine="jit", device=cuda_device)
    for v, s in zip(vm, solo):
        assert ([(r.round, r.vehicle, r.time, r.upload_delay, r.weight)
                 for r in v.rounds]
                == [(r.round, r.vehicle, r.time, r.upload_delay, r.weight)
                    for r in s.rounds])
        for k in s.final_params:
            torch.testing.assert_close(v.final_params[k], s.final_params[k],
                                       atol=1e-4, rtol=1e-3)
        for (_, x), (_, y) in zip(v.acc_history, s.acc_history):
            assert abs(x - y) <= 0.02


@pytest.mark.cuda
def test_sweep_singletons_on_card_are_bitwise_solo(cuda_device):
    """Worlds alone in their timeline group on the card (per-world
    ``sigma2`` and ``v`` as ``[W, 1]`` columns; the bf16 ring): bitwise
    their solo ``jit`` runs on the card."""
    import dataclasses
    from repro_torch.core import sweep
    from repro_torch.core.scenarios import get_scenario, run_scenario
    base = dataclasses.replace(get_scenario("quick-k5"), rounds=8)
    for worlds in ([(dataclasses.replace(base, channel_overrides=(
                        ("sigma2", 2e-13),)), 0),
                    (dataclasses.replace(base, channel_overrides=(
                        ("v", 25.0),)), 1)],
                   [(dataclasses.replace(base, ring_dtype="bf16"), s)
                    for s in (0, 1)]):
        res = sweep.run_simulation_vmap(worlds, eval_every=4,
                                        device=cuda_device)
        for (sc, seed), v in zip(worlds, res):
            s = run_scenario(sc, engine="jit", seed=seed, eval_every=4,
                             device=cuda_device)
            assert ([(r.round, r.vehicle, r.time, r.upload_delay,
                      r.train_delay, r.weight) for r in v.rounds]
                    == [(r.round, r.vehicle, r.time, r.upload_delay,
                         r.train_delay, r.weight) for r in s.rounds])
            for k in s.final_params:
                assert torch.equal(v.final_params[k], s.final_params[k]), k
            assert v.acc_history == s.acc_history


# ---------------------------------------------------------------------------
# the device engines' pytree programs (flat=False) and K2's device form
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("leaf_set", ["cnn", "mixed"])
def test_weighted_agg_device_form_on_card(cuda_device, leaf_set):
    """K2 with its scalars on the card (beta, weight or both a one-element
    f32 tensor): bitwise its float form and its plain version on every
    leaf, one launch per chunk, as the float form launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    shapes = {**CNN_SHAPES, "empty": (0,), "one": (1,), "ragged": (12345,)}
    names = list(shapes)
    g, l = (_tree(CNN_SHAPES, lambda k: torch.float32, lambda k: 0, gen,
                  cuda_device) if leaf_set == "cnn" else
            _tree(shapes, lambda k: (torch.float32, torch.bfloat16)[
                names.index(k) % 2], lambda k: names.index(k) % 3 == 1,
                gen, cuda_device))
    chunks = sum(ops.launches(sum(1 for v in g.values() if v.dtype == dt
                                  and v.numel()))
                 for dt in {v.dtype for v in g.values()})
    for beta, weight in SCALARS:
        want = ops.weighted_agg_tree(g, l, beta, weight)
        b = torch.tensor(beta, device=cuda_device)
        w = torch.tensor([weight], device=cuda_device)
        for bb, ww in ((b, w), (b, weight), (beta, w)):
            kernels.reset_launches()
            out = ops.weighted_agg_tree(g, l, bb, ww)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["weighted_agg"] == chunks
            for k in g:
                assert torch.equal(_int_view(out[k]), _int_view(want[k])), k
                assert torch.equal(
                    _int_view(out[k]),
                    _int_view(ref.weighted_agg(g[k], l[k], bb, ww))), k


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["jit", "corridor"])
def test_pytree_loops_never_wait_for_the_card(cuda_device, monkeypatch,
                                              engine):
    """The pytree programs' pops and merges (K2's device form under
    ``use_kernel``, the keep fold, telemetry) and the corridor's
    reconciles run with CUDA synchronisation made an error."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import run_scenario
    from repro_torch.corridor import engine as cengine
    from repro_torch.faults import FaultSpec
    mod = jit_engine if engine == "jit" else cengine
    pops = []

    def strict(real):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            pops.append(out[0].numel() if isinstance(out, tuple) else 0)
            return out
        return call

    ops.weighted_agg(torch.zeros(4, device=cuda_device),
                     torch.zeros(4, device=cuda_device), 0.5, 1.0)
    monkeypatch.setattr(mod, "_pop_segment", strict(mod._pop_segment))
    if engine == "corridor":
        monkeypatch.setattr(mod, "_reconcile", strict(mod._reconcile))
    faults = FaultSpec(p_dropout=0.25, p_partial=0.5, staleness_cap=3,
                       recheck_every=2)
    name = "quick-k5" if engine == "jit" else "corridor-quick-r2-k8"
    kw = ({} if engine == "jit"
          else dict(reconcile_mode="ema", reconcile_tau=0.3))
    kernels.reset_launches()
    res = run_scenario(name, engine=engine, flat=False, rounds=12,
                       eval_every=4, use_kernel=True, metrics="on",
                       faults=faults if engine == "jit" else None,
                       l_iters=2, device=cuda_device, **kw)
    assert sum(pops) == len(res.rounds) == 12
    reconciles = 0 if engine == "jit" else 3
    assert kernels.launch_counts()["weighted_agg"] == 12 + reconciles
    assert kernels.launch_counts()["ring_agg"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name, kw", [
    ("quick-k5", {}),
    ("corridor-quick-r2-k8", dict(reconcile_mode="ema", reconcile_tau=0.3)),
], ids=["jit", "corridor-ema"])
def test_pytree_on_card_is_the_flat_program(cuda_device, name, kw):
    """16 rounds on the card, flat and pytree: the same trace bit for bit;
    params and accuracy bitwise without the kernel; under ``use_kernel``
    K2 launches once a pop (plus once a reconcile), K1 never, params
    within 1e-5 of the flat run (one f32 ulp of a mix coefficient)."""
    from repro_torch.core.scenarios import run_scenario
    engine = "jit" if name == "quick-k5" else "corridor"

    def run(flat, use_kernel):
        return run_scenario(name, engine=engine, flat=flat, rounds=16,
                            eval_every=4, use_kernel=use_kernel,
                            device=cuda_device, **kw)

    def trace(res):
        return [(r.round, r.vehicle, r.rsu, r.time, r.upload_delay,
                 r.train_delay, r.weight) for r in res.rounds]

    flat = run(True, False)
    tree = run(False, False)
    assert trace(tree) == trace(flat)
    for k in flat.final_params:
        assert torch.equal(_int_view(tree.final_params[k]),
                           _int_view(flat.final_params[k])), k
    assert tree.acc_history == flat.acc_history
    kernels.reset_launches()
    tk = run(False, True)
    reconciles = 0 if engine == "jit" else 4
    assert kernels.launch_counts()["weighted_agg"] == 16 + reconciles
    assert kernels.launch_counts()["ring_agg"] == 0
    assert trace(tk) == trace(flat)
    for k in flat.final_params:
        torch.testing.assert_close(tk.final_params[k], flat.final_params[k],
                                   rtol=0.0, atol=1e-5)


# ---------------------------------------------------------------------------
# MoE, MLA, the checkpoint policies and the optimizers on the card
# ---------------------------------------------------------------------------
# both sides f32: the card's and the CPU's products sum in other orders, a
# few ulps per layer on activations and logits of size ~0.1-1
MOE_CPU_TOL = dict(atol=1e-5, rtol=1e-5)
MOE_ARCHS = {"deepseek": "deepseek-v2-lite-16b",
             "scout": "llama4-scout-17b-a16e"}


def _to_card(module, dev):
    import copy
    return copy.deepcopy(module).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(MOE_ARCHS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_on_card_matches_cpu(cuda_device, arch, cf):
    """``moe_fwd`` (at ``capacity_factor`` 0.5 tokens drop) and
    ``moe_decode`` on the card against the CPU, from one CPU init."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCHS[arch]).reduced().variant(capacity_factor=cf)
    cpu = moe.MoE(cfg, device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = _to_card(cpu, cuda_device)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    for fn, inp in ((moe.moe_fwd, x), (moe.moe_decode, x[:, :1])):
        yc, ac = fn(cfg, cpu, inp)
        yg, ag = fn(cfg, gpu, inp.to(cuda_device))
        assert torch.allclose(yg.cpu(), yc, **MOE_CPU_TOL), fn.__name__
        assert torch.allclose(ag.cpu(), ac, rtol=1e-5), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_mla_on_card_matches_cpu(cuda_device, absorb):
    """``mla_fwd`` below and above the blocked threshold, then decode steps
    at a scalar and at per-sequence positions, card against CPU; the
    latent cache written on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    cfg = get_config("deepseek-v2-lite-16b").reduced().variant(
        mla_absorb=absorb)
    cpu = A.init_mla(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = _to_card(cpu, cuda_device)
    gen = torch.Generator().manual_seed(1)
    for S in (40, 1152):
        x = torch.randn(1, S, cfg.d_model, generator=gen) * 0.5
        pos = torch.arange(S, dtype=torch.int32)
        yc, _ = A.mla_fwd(cfg, cpu, x, pos)
        yg, _ = A.mla_fwd(cfg, gpu, x.to(cuda_device), pos.to(cuda_device))
        assert torch.allclose(yg.cpu(), yc, **MOE_CPU_TOL), S
    cc = A.init_mla_cache(cfg, 2, 24, torch.float32, "cpu")
    cg = A.init_mla_cache(cfg, 2, 24, torch.float32, cuda_device)
    for i in range(6):
        pos = torch.tensor([i, 2 * i], dtype=torch.int32) if i % 2 else i
        x = torch.randn(2, 1, cfg.d_model, generator=gen) * 0.5
        yc, cc = A.mla_decode(cfg, cpu, x, cc, pos)
        yg, cg = A.mla_decode(cfg, gpu, x.to(cuda_device), cg,
                              pos.to(cuda_device) if torch.is_tensor(pos)
                              else pos)
        assert torch.allclose(yg.cpu(), yc, **MOE_CPU_TOL), i
    for k in cc:
        assert torch.allclose(cg[k].cpu(), cc[k], **MOE_CPU_TOL), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(MOE_ARCHS))
def test_moe_archs_on_card_match_cpu(cuda_device, arch):
    """Reduced deepseek (MLA, no K4/K5 launch) and scout ([chunk 64,
    global]: K5 once a layer per prefill, K4 once a layer a step): prefill
    of 80 tokens and 16 teacher-forced steps, card against CPU, and the
    aux of a training forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(MOE_ARCHS[arch]).reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = _to_card(cpu, cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int64))
    kernels.reset_launches()
    lc, cc = T.prefill(cfg, cpu, prompt)
    lg, cg = T.prefill(cfg, gpu, prompt.to(cuda_device))
    assert torch.allclose(lg.cpu(), lc, **MOE_CPU_TOL)
    cc = T.grow_cache(cfg, cc, 2, 96)
    cg = T.grow_cache(cfg, cg, 2, 96)
    forced = torch.argmax(lc[:, -1:], -1)
    for i in range(16):
        lc, cc = T.decode_step(cfg, cpu, forced, cc, 80 + i)
        lg, cg = T.decode_step(cfg, gpu, forced.to(cuda_device), cg, 80 + i)
        assert torch.allclose(lg.cpu(), lc, **MOE_CPU_TOL), i
        forced = torch.argmax(lc, -1)
    counts = kernels.launch_counts()
    attn_layers = 0 if cfg.use_mla else cfg.n_layers
    assert counts["swa_attention"] == attn_layers
    assert counts["decode_attention"] == 16 * attn_layers
    (_, ac), (_, ag) = (T.forward(cfg, m, t) for m, t in (
        (cpu, prompt), (gpu, prompt.to(cuda_device))))
    assert torch.allclose(ag.cpu(), ac, rtol=1e-5)


@pytest.mark.cuda
def test_remat_policies_on_card(cuda_device):
    """One ``make_train_step`` of reduced deepseek under each checkpoint
    policy on the card: K3 once a step, the losses and new parameters
    those of ``full`` (index_add's atomics may reorder a sum: f32 band)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    base = get_config("deepseek-v2-lite-16b").reduced()
    model = T.init_params(base, torch.Generator(device=cuda_device)
                          .manual_seed(0), device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 49)).astype(np.int64)).to(cuda_device)
    runs = {}
    for name, kw in (("full", {}), ("dots", dict(remat_policy="dots")),
                     ("dots_nb", dict(remat_policy="dots_nb")),
                     ("remat_sublayer", dict(remat_sublayer=True)),
                     ("no_remat", dict(no_remat=True))):
        kernels.reset_launches()
        runs[name] = make_train_step(base.variant(**kw), lr=0.05)(
            model, T.param_dict(model), {"tokens": toks})
        assert kernels.launch_counts()["cross_entropy"] == 1, name
    want_p, want_m = runs["full"]
    for name, (p, m) in runs.items():
        assert torch.allclose(m["loss"], want_m["loss"], rtol=1e-6), name
        for k in p:
            assert torch.allclose(p[k], want_p[k], atol=1e-6), (name, k)


@pytest.mark.cuda
def test_optimizers_on_card_match_cpu(cuda_device):
    """adam under ``linear_warmup_cosine`` and momentum SGD, each after
    ``clip_by_global_norm``, three steps from one gradient: card against
    CPU, the step counter staying on the card."""
    import repro_torch.optim as O
    gen = torch.Generator().manual_seed(0)
    params = {f"w{i}": torch.randn(s, generator=gen)
              for i, s in enumerate(((64, 33), (1000,), (7, 5, 3)))}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in
             params.items()}
    for opt in (O.adam(O.linear_warmup_cosine(1e-2, 2, 10), weight_decay=0.1),
                O.momentum_sgd(0.05)):
        out = []
        for dev in ("cpu", cuda_device):
            p = {k: v.to(dev) for k, v in params.items()}
            g, _ = O.clip_by_global_norm({k: v.to(dev)
                                          for k, v in grads.items()}, 1.0)
            state = opt.init(p)
            for _ in range(3):
                u, state = opt.update(g, state, p)
                p = O.apply_updates(p, u)
            assert state["step"].device == torch.device(dev)
            out.append(p)
        for k in params:
            assert torch.allclose(out[1][k].cpu(), out[0][k], rtol=1e-6,
                                  atol=1e-7), k
