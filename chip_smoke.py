#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any failed check:

1. build: compile every kernel under ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a, one nvcc per source, all started together; print the
   card's name and power limit.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the shapes the main paths give it (``weighted_agg`` at every CNN leaf
   shape; ``ring_agg`` at U in {0, 1, 2, 7, 9, 10, 30, 60}, f32 and bf16
   uploads, P = 422,016 and 128*300, with -0.0 and a (1, 0) step), and
   time kernel, plain version and one library call against the card's
   bound.
3. host-engine path: ``run_scenario`` on paper-k10 (serial and batched, 40
   rounds) and fleet-k100 (batched, 120 rounds) with ``use_kernel=True``;
   every merge is ``weighted_agg`` (8 launches per merge).
4. fleet-engine path: ``run_scenario(engine="jit")`` on fleet-k1000 (30
   rounds, f32 ring), fleet-k10000 (60 rounds, bf16 ring) and
   platoon-burst-k500 (40 rounds); every merge is a ``ring_agg`` chain, one
   launch per chain of the plan, and ``weighted_agg`` launches none; each
   world's host set-up (world building, plan) is then timed alone.
   Launch counts are zeroed before and read after each timed run of 3-4.
5. card against host: paper-k10 for 8 rounds on the card and on the CPU
   from one numpy-made init, on the serial and on the fleet engine.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
PAPER_ROUNDS, FLEET_ROUNDS, HOST_ROUNDS = 40, 120, 8
# the fleet engine's worlds at their registered rounds, eval every 10
JIT_RUNS = (("fleet-k1000", 30), ("fleet-k10000", 60),
            ("platoon-burst-k500", 40))
EVAL_EVERY = 10
# ring_agg: chain lengths checked bitwise, and the timed chain
RING_U = (0, 1, 2, 7, 9, 10, 30, 60)
RING_P = (422016, 128 * 300)
RING_TIMED_U = 10
L2_BYTES = 50 * 2 ** 20
DEVICE = "cuda"
# card vs CPU after 8 paper-k10 rounds (40 SGD steps per vehicle chain):
# cuDNN and the CPU's convolutions sum in different orders, so each step
# differs by a few f32 ulps and SGD carries the differences forward.
# 1e-4 absolute on weights of size ~0.1-1 is far above that drift and far
# below any change a wrong kernel or layout would make (1e-2 and up).
HOST_ATOL, HOST_RTOL = 1e-4, 1e-3
ACC_TOL = 0.02                     # the golden suite's accuracy bar
# the fleet engine's event times are f32 device arithmetic (log2, pow,
# sqrt): the card's and the CPU's libraries may round them an ulp apart;
# the f32 band of repro's own jit conformance tests
JIT_TIME_TOL = dict(rtol=2e-5, atol=1e-3)


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=100, warmup=10):
    """Device time of one call of ``fn`` from CUDA events over ``iters``
    back-to-back calls (inputs stay in L2 between calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fn, sets):
    """A zero-argument call of ``fn`` that walks through the input
    ``sets`` in turn, so that back-to-back timed calls read inputs that are
    no longer in L2 (the sets together span more than twice its 50 MB)."""
    state = {"i": 0}

    def call():
        args = sets[state["i"] % len(sets)]
        state["i"] += 1
        return fn(*args)
    return call


def device_ms_per_call(fn, kernel_name, iters=50):
    """Device time of the kernels named ``kernel_name`` per call of ``fn``,
    from torch.profiler's CUDA activity (None if it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if kernel_name in e.key)
    return us / iters / 1e3 if us > 0 else None


def profile_run(name, engine, rounds, wall_ms):
    """One main-path run under torch.profiler: the kernels that take the
    most device time, and their sum over the wall time of the profiled
    run and of the unprofiled run (``wall_ms``; the profiler slows the
    host, so the first share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.scenarios import run_scenario

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_scenario(name, engine=engine, use_kernel=True, device=DEVICE,
                     rounds=rounds)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    if not rows:
        log(f"profile: {name}/{engine}: no device activity recorded "
            f"(device busy share not measured)")
        return
    log(f"profile: {name}/{engine} {rounds} rounds: device kernels "
        f"{dev_ms:.3f} ms; wall {prof_ms:.3f} ms profiled (busy share "
        f"{dev_ms / prof_ms:.4f}), {wall_ms:.3f} ms unprofiled (busy share "
        f"{dev_ms / wall_ms:.4f}); top kernels by device time:")
    for t, n, key in rows[:10]:
        log(f"profile:   {t:10.3f} ms {n:7d} x  {key[:90]}")


def bits(t):
    import torch
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def phase_kernels(dev):
    """Kernel against plain version, bitwise, at every CNN leaf shape plus
    a ragged length, a length under 128 and a misaligned view; then the
    timings of a full-model merge."""
    import torch
    from repro_torch.kernels.weighted_agg import ops, ref
    from repro_torch.models.cnn import CNN_SHAPES

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = list(CNN_SHAPES.values()) + [(12345,), (77,)]
    # mixing: (1 - alpha, 1.0); literal: (beta, weight)
    scalars = [(1.0 - 0.0734125, 1.0), (0.5, 0.8719)]
    max_err, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            for misaligned in (False, True):
                # misaligned: a contiguous view one element into its buffer
                off = 1 if misaligned else 0
                n = int(np.prod(shape))
                g, l = (torch.randn(n + off, generator=gen, device=dev)
                        .to(dtype)[off:].view(shape) for _ in range(2))
                for b, w in scalars:
                    out = ops.weighted_agg(g, l, b, w)
                    want = ref.weighted_agg(g, l, b, w)
                    torch.cuda.synchronize()
                    check(out.shape == want.shape and out.dtype == dtype,
                          f"weighted_agg shape/dtype {shape} {dtype}")
                    check(torch.equal(bits(out), bits(want)),
                          f"weighted_agg differs from its plain version "
                          f"at {shape} {dtype} misaligned={misaligned} "
                          f"scalars=({b}, {w})")
                    err = (out.float() - want.float()).abs().max().item()
                    max_err = max(max_err, err)
                    cases += 1
    log(f"kernels: weighted_agg bitwise equal to its plain version in "
        f"{cases} cases (f32 and bf16; every CNN leaf shape, n=12345, "
        f"n=77, aligned and misaligned; mixing and literal scalars); "
        f"max_abs_err={max_err}")

    # timings of one full-model merge (8 leaves) at the main path's shapes
    g = {k: torch.randn(s, generator=gen, device=dev)
         for k, s in CNN_SHAPES.items()}
    l = {k: torch.randn(s, generator=gen, device=dev)
         for k, s in CNN_SHAPES.items()}
    beta = 1.0 - 0.0734125
    n_params = sum(int(np.prod(s)) for s in CNN_SHAPES.values())
    runs = {
        "kernel": lambda: ops.weighted_agg_tree(g, l, beta, 1.0),
        "plain": lambda: {k: ref.weighted_agg(g[k], l[k], beta, 1.0)
                          for k in g},
        "library": lambda: {k: torch.lerp(g[k], l[k], 1.0 - beta)
                            for k in g},
    }
    samples = {k: [] for k in runs}
    for rep in range(6):                         # in turns, order alternating
        order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
        for name in order:
            samples[name].append(time_ms(runs[name]))
    ms = {k: float(np.median(v)) for k, v in samples.items()}
    bytes_moved = 3 * 4 * n_params              # read g, read l, write out
    flops = 3 * n_params                         # 2 multiplies + 1 add
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    log(f"kernels: full-model merge (P={n_params}, 8 leaves, f32): "
        f"kernel {ms['kernel']:.6f} ms, plain {ms['plain']:.6f} ms, "
        f"torch.lerp {ms['library']:.6f} ms, bound {bound_ms:.6f} ms "
        f"({bytes_moved} bytes at 3.35 TB/s); samples {samples}")
    busy = device_ms_per_call(runs["kernel"], "weighted_agg_kernel")
    log(f"kernels: weighted_agg device time per full-model merge (sum of "
        f"its 8 launches, torch.profiler): "
        f"{'not measured' if busy is None else f'{busy:.6f} ms'}")
    return {
        "name": "weighted_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg/kernel.py:35",
        "max_abs_err": max_err, "ms": ms["kernel"],
        "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": ms["library"],
    }


def ring_inputs(P, U, dtype, gen, dev, neg_zero=False):
    import torch
    g = torch.randn(P, generator=gen, device=dev)
    locs = torch.randn(U, P, generator=gen, device=dev).to(dtype)
    c = torch.rand(U, generator=gen, device=dev) * 0.5 + 0.5
    coeffs = torch.stack([c, 1.0 - c], dim=1).contiguous()
    if neg_zero:
        g[::7] = -0.0
        if U:
            locs[:, ::7] = 0.0
            coeffs[0] = torch.tensor([1.0, 0.0], device=dev)
    return g, locs, coeffs


def phase_ring_kernel(dev):
    """K1 ring_agg against its plain version, bitwise, over the listed
    chain lengths, dtypes and P; then the timings of one U = 10 chain at
    the paper CNN's P in f32 and bf16."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.weighted_agg import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    kernels.reset_launches()
    max_err, cases, chains = 0.0, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for P in RING_P:
            for U in RING_U:
                for neg_zero in (False, True):
                    g, locs, coeffs = ring_inputs(P, U, dtype, gen, dev,
                                                  neg_zero)
                    out = ops.ring_agg(g, locs, coeffs)
                    want = ref.ring_agg(g, locs, coeffs)
                    torch.cuda.synchronize()
                    check(out.dtype == torch.float32 and out.shape == (P,),
                          f"ring_agg shape/dtype P={P} U={U} {dtype}")
                    check(torch.equal(bits(out), bits(want)),
                          f"ring_agg differs from its plain version at P={P} "
                          f"U={U} {dtype} neg_zero={neg_zero}")
                    if neg_zero and U:
                        check(not torch.signbit(out[::7]).any(),
                              "ring_agg: a (1, 0) step keeps -0.0")
                    max_err = max(max_err, (out - want).abs().max().item())
                    cases += 1
                    chains += U > 0
    launched = kernels.launch_counts()["ring_agg"]
    check(launched == chains,
          f"ring_agg launched {launched} times for {chains} chains (U = 0 "
          "must not launch)")
    log(f"kernels: ring_agg bitwise equal to its plain version in {cases} "
        f"cases (U in {RING_U}, f32 and bf16 uploads, P in {RING_P}, with "
        f"and without -0.0 and a (1, 0) step); {launched} launches for "
        f"{chains} non-empty chains; max_abs_err={max_err}")

    P, U = RING_P[0], RING_TIMED_U
    timings = {}
    for dtype, s in ((torch.float32, 4), (torch.bfloat16, 2)):
        bytes_moved = (8 + U * s) * P + 8 * U    # g, U rows, out, coeffs
        n_sets = int(np.ceil(2 * L2_BYTES / bytes_moved))
        sets = [ring_inputs(P, U, dtype, gen, dev) for _ in range(n_sets)]
        runs = {"kernel": rotating(ops.ring_agg, sets),
                "plain": rotating(ref.ring_agg, sets)}
        if dtype == torch.float32:
            # the yardstick: the chain's closed form as one gemv; the port
            # never calls it (it reassociates the f32 arithmetic)
            lib_sets = []
            for g, locs, coeffs in sets:
                w = ops.prefix_weights(coeffs.cpu())
                lib_sets.append((g, locs.t(), torch.tensor(
                    w[1:], dtype=torch.float32, device=dev), float(w[0])))
            runs["library"] = rotating(
                lambda g, lt, w, b: torch.addmv(g, lt, w, beta=b), lib_sets)
            # the same function: equal up to the f32 reassociation
            diff = (runs["library"]() - runs["kernel"]()).abs().max().item()
            check(diff <= 1e-4, f"addmv yardstick differs by {diff}")
        samples = {k: [] for k in runs}
        for rep in range(6):                     # in turns, order alternating
            order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
            for name in order:
                samples[name].append(time_ms(runs[name]))
        ms = {k: float(np.median(v)) for k, v in samples.items()}
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = 3 * U * P / FP32_FLOP_PER_S * 1e3
        busy = device_ms_per_call(rotating(ops.ring_agg, sets),
                                  "ring_agg_kernel")
        tag = "f32" if dtype == torch.float32 else "bf16"
        lib = (f"addmv {ms['library']:.6f} ms" if "library" in ms
               else "addmv not timed (f32 only)")
        log(f"kernels: ring_agg U={U} P={P} {tag} uploads "
            f"({n_sets} input sets, {bytes_moved} bytes per chain): kernel "
            f"{ms['kernel']:.6f} ms, plain {ms['plain']:.6f} ms, {lib}")
        log(f"kernels:   bound {max(bound_bytes, bound_ops):.6f} ms "
            f"(bytes {bound_bytes:.6f}, operations {bound_ops:.6f}); device "
            f"time per chain (torch.profiler) "
            f"{'not measured' if busy is None else f'{busy:.6f} ms'}; "
            f"samples {samples}")
        timings[tag] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": ms.get("library"), "device_ms": busy}
    entry = {
        "name": "ring_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg/kernel.py:113",
        "max_abs_err": max_err, **timings["f32"],
        "shape": f"U={U} P={P} f32 uploads", "bf16": timings["bf16"],
    }
    return entry


def run_main(name, engine, rounds):
    """One main-path run; returns (result, ms/round, launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.scenarios import run_scenario

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(name, engine=engine, use_kernel=True, device=DEVICE,
                       rounds=rounds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()["weighted_agg"]
    merges = len(res.rounds)
    check(merges == rounds, f"{name}/{engine}: {merges} of {rounds} rounds")
    check(launches == 8 * merges,
          f"{name}/{engine}: {launches} weighted_agg launches for {merges} "
          f"merges (expected 8 per merge)")
    for k, v in res.final_params.items():
        check(v.device.type == DEVICE and bool(torch.isfinite(v).all()),
              f"{name}/{engine}: final {k} not finite on the card")
    accs = [a for _, a in res.acc_history]
    check(all(np.isfinite(accs)) and 0.0 <= accs[-1] <= 1.0,
          f"{name}/{engine}: accuracy history {accs}")
    ms_round = dt / rounds * 1e3
    log(f"main: {name} engine={engine} rounds={rounds}: "
        f"{ms_round:.3f} ms/round ({dt:.3f} s), final accuracy "
        f"{res.final_accuracy():.5f}, weighted_agg launches {launches} "
        f"= 8 x {merges} merges")
    return res, ms_round, launches


def phase_main():
    from repro_torch.core.scenarios import run_scenario
    # warm-up (untimed, launches not counted): cuDNN/cuBLAS handles, lazy
    # module loading, and the vmapped chunk path (fleet-k100's first wave
    # holds 16+ consumed uploads)
    t0 = time.perf_counter()
    run_scenario("paper-k10", engine="serial", use_kernel=True,
                 device=DEVICE, rounds=3)
    run_scenario("fleet-k100", engine="batched", use_kernel=True,
                 device=DEVICE, rounds=20)
    log(f"main: warm-up {time.perf_counter() - t0:.3f} s")
    serial, serial_ms, n1 = run_main("paper-k10", "serial", PAPER_ROUNDS)
    batched, _, n2 = run_main("paper-k10", "batched", PAPER_ROUNDS)
    trace = [(r.round, r.vehicle, r.time) for r in serial.rounds]
    check(trace == [(r.round, r.vehicle, r.time) for r in batched.rounds],
          "paper-k10 serial and batched traces differ")
    diff = max((serial.final_params[k] - batched.final_params[k])
               .abs().max().item() for k in serial.final_params)
    log(f"main: paper-k10 serial and batched traces identical; final "
        f"params max |serial - batched| = {diff}")
    _, fleet_ms, n3 = run_main("fleet-k100", "batched", FLEET_ROUNDS)
    profile_run("paper-k10", "serial", PAPER_ROUNDS,
                serial_ms * PAPER_ROUNDS)
    profile_run("fleet-k100", "batched", FLEET_ROUNDS,
                fleet_ms * FLEET_ROUNDS)
    return n1 + n2 + n3


def expected_chains(name, rounds):
    """ring_agg launches of one run: the non-empty checkpoint intervals of
    the port's own plan and ``needed`` set."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario
    sc = get_scenario(name)
    plan = jit_engine.plan_fleet(sc.channel(), 0, rounds,
                                 l_iters=sc.l_iters)
    need = jit_engine.needed_rounds(
        plan, jit_engine.eval_rounds_of(rounds, EVAL_EVERY))
    return sum(len(jit_engine.chain_bounds(s, e, need))
               for _, s, e in plan.waves)


def run_fleet(name, rounds):
    """One fleet-engine run; returns (ms/round, ring_agg launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import (build_world, get_scenario,
                                            run_scenario)

    want = expected_chains(name, rounds)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(name, engine="jit", use_kernel=True, device=DEVICE,
                       rounds=rounds, eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(len(res.rounds) == rounds,
          f"{name}/jit: {len(res.rounds)} of {rounds} rounds")
    check(counts["ring_agg"] == want,
          f"{name}/jit: {counts['ring_agg']} ring_agg launches for the "
          f"plan's {want} chains")
    check(counts["weighted_agg"] == 0,
          f"{name}/jit: {counts['weighted_agg']} weighted_agg launches")
    for k, v in res.final_params.items():
        check(v.device.type == DEVICE and bool(torch.isfinite(v).all()),
              f"{name}/jit: final {k} not finite on the card")
    accs = [a for _, a in res.acc_history]
    check(all(np.isfinite(accs)) and 0.0 <= accs[-1] <= 1.0,
          f"{name}/jit: accuracy history {accs}")
    ms_round = dt / rounds * 1e3
    # the run's host set-up, timed alone: world building (one data shard
    # per vehicle) and the f64 plan
    t0 = time.perf_counter()
    _, _, _, p = build_world(get_scenario(name))
    t1 = time.perf_counter()
    jit_engine.plan_fleet(p, 0, rounds)
    t2 = time.perf_counter()
    log(f"fleet: {name} engine=jit rounds={rounds}: {ms_round:.3f} "
        f"ms/round ({dt:.3f} s), final accuracy {res.final_accuracy():.5f}, "
        f"ring_agg launches {counts['ring_agg']} = the plan's chains, "
        f"weighted_agg launches 0")
    log(f"fleet:   set-up timed alone: build_world {t1 - t0:.3f} s, "
        f"plan_fleet {t2 - t1:.3f} s; the rest of the run (staging, device "
        f"loop, evals) {dt - (t2 - t0):.3f} s")
    return ms_round, counts["ring_agg"]


def phase_fleet():
    from repro_torch.core.scenarios import run_scenario
    total, ms = 0, {}
    for name, rounds in JIT_RUNS:
        t0 = time.perf_counter()                 # warm-up, untimed
        run_scenario(name, engine="jit", use_kernel=True, device=DEVICE,
                     rounds=rounds, eval_every=EVAL_EVERY)
        log(f"fleet: {name} warm-up {time.perf_counter() - t0:.3f} s")
        ms[name], n = run_fleet(name, rounds)
        total += n
    profile_run("fleet-k10000", "jit", 60, ms["fleet-k10000"] * 60)
    return total


def numpy_init(seed=0):
    """The paper CNN's init distributions, drawn with numpy."""
    from repro_torch.models.cnn import CNN_SHAPES
    rng = np.random.default_rng(seed)
    tree = {}
    for k, s in CNN_SHAPES.items():
        if k.endswith("_b"):
            tree[k] = np.zeros(s, np.float32)
        else:
            fan_in = int(np.prod(s[:-1]))
            tree[k] = (rng.normal(size=s) / np.sqrt(fan_in)).astype(
                np.float32)
    return tree


def phase_host(engine):
    """paper-k10 for 8 rounds on the card and on the CPU, same init."""
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core.mafl import run_simulation
    from repro_torch.core.scenarios import build_world, get_scenario

    sc = get_scenario("paper-k10")
    veh, te_i, te_l, p = build_world(sc)
    init = numpy_init()
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        out[dev] = run_simulation(
            veh, te_i, te_l, scheme=sc.scheme, rounds=HOST_ROUNDS,
            l_iters=sc.l_iters, lr=sc.lr, params=p, eval_every=2,
            use_kernel=True, init_params=params_from_jax(init, dev),
            engine=engine, device=dev)
        log(f"host: paper-k10 {engine} {HOST_ROUNDS} rounds on {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    gpu, cpu = out[DEVICE], out["cpu"]
    check([(r.round, r.vehicle) for r in gpu.rounds]
          == [(r.round, r.vehicle) for r in cpu.rounds],
          f"{engine}: card and CPU (round, vehicle) traces differ")
    tg = np.array([r.time for r in gpu.rounds])
    tc = np.array([r.time for r in cpu.rounds])
    if engine == "jit":
        # f32 event times computed by the card's and the CPU's libm
        check(np.allclose(tg, tc, **JIT_TIME_TOL),
              f"jit: card and CPU event times differ: {tg} vs {tc}")
    else:
        check(np.array_equal(tg, tc), "card and CPU event times differ")
    pg, pc = params_to_numpy(gpu.final_params), params_to_numpy(
        cpu.final_params)
    worst = 0.0
    for k in pg:
        err = float(np.abs(pg[k] - pc[k]).max())
        worst = max(worst, err)
        check(np.allclose(pg[k], pc[k], atol=HOST_ATOL, rtol=HOST_RTOL),
              f"{engine}: card vs CPU final {k}: max |diff| {err}")
    acc_diff = max(abs(a - b) for (_, a), (_, b)
                   in zip(gpu.acc_history, cpu.acc_history))
    check(acc_diff <= ACC_TOL,
          f"{engine}: card vs CPU accuracy differs by {acc_diff}")
    log(f"host: {engine}: card and CPU traces identical ((round, vehicle); "
        f"event times max |diff| {float(np.abs(tg - tc).max())}); final "
        f"params max |diff| {worst} (atol {HOST_ATOL}, rtol {HOST_RTOL}); "
        f"accuracy max |diff| {acc_diff}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels.build import build_all
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    libs = build_all()
    built = ", ".join(f"{s} -> {p.relative_to(ROOT)}"
                      for s, p in libs.items())
    log(f"build: {built} in {time.perf_counter() - t0:.3f} s")
    log(card_line())

    k2 = phase_kernels(dev)
    k1 = phase_ring_kernel(dev)
    k2["launches"] = phase_main()
    k1["launches"] = phase_fleet()
    phase_host("serial")
    phase_host("jit")

    log(json.dumps({"kernels": [k2, k1]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
