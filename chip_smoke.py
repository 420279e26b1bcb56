#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any failed check:

1. build: compile every kernel under ``src/repro_torch/kernels/csrc`` and
   the race analyzer's fixture ``src/repro_torch/check/corpus/
   racy_sum.cu`` with nvcc for sm_90a, one nvcc per source, all started
   together; print the card's name and power limit.
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
6. attention kernels: ``decode_attention`` (K4) at G in {1, 3, 4}, hd in
   {64, 128}, pos = 0, S - 1 and a mixed per-row vector, and
   ``swa_attention`` (K5) at window = S, windows under S, a window that is
   not a multiple of the 64-row tile and S not a multiple of it, G in
   {1, 3}; f32 and bf16, each held to its plain version (2e-5 in f32,
   3e-2 in bf16); then kernel, plain version and
   ``scaled_dot_product_attention`` timed at the serve path's shapes and
   at smollm-360m's decode_32k / 1024-token prefill geometry.
7. serve path: full-width smollm-360m (32 layers, f32, the port's torch
   init) behind a ``BatchedServer`` of 8 slots and max_seq 2048 serves 16
   requests (numpy prompts of 64-1024 tokens, 64 new tokens each);
   ``decode_attention`` launches 32 per tick and ``swa_attention`` 32 per
   admitted request; a second run under torch.profiler gives the device
   busy share.
8. serve, card against host: the same config cut to 4 layers, one CPU
   init, two of the prompts: prefill and 16 teacher-forced decode steps on
   both, logits within atol 1e-3 / rtol 1e-3.
9. cross-entropy kernel: ``cross_entropy`` (K3) at R in {1, 7, 512, 4096}
   and V in {512, 1111, 49152, 131072}, f32 and bf16, labels at 0, V - 1
   and random, plus rows of +-1e4 logits: (nll, lse) within 1e-4 (f32) /
   3e-2 (bf16) / 1e-3 (+-1e4 rows) of the plain version, and the
   backward's d logits within 1e-6 of plain autograd; then kernel, plain
   version and ``F.cross_entropy`` timed at the training path's shapes.
10. training path: ``launch/train.py``'s MAFL loop on full-width
    smollm-360m (the port's torch init, f32) with ``--use-kernel`` and the
    defaults (batch 8, seq-len 64, 4 local steps, lr 0.05) for 10 rounds;
    ``cross_entropy`` launches once per local step and held-out eval,
    ``weighted_agg`` once per parameter leaf (290) per merge; every printed
    loss finite; a second run under torch.profiler gives the busy share.
11. train step: ``make_train_step`` at full width, B 8, S 512 (4096 rows
    into K3): one warm-up and 5 timed steps.
12. training, card against host: the same config cut to 4 layers, one CPU
    init, 2 rounds of 2 local steps on both: the same vehicles, losses
    within rtol 1e-4, final params within atol 1e-4 / rtol 1e-3.
13. check (after phase 12, before the profiler readings): the analyzer entry
    point ``python -m repro_torch.check src/repro_torch --strict
    --format=json`` in this process, every probe included: exit 0, no live
    finding, every production kernel parallel-safe.  Each kernel's Python
    launch geometry (``ops.geometry``) against its ``.cu``'s
    ``<name>_geometry`` export at its registered case and at every
    main-path shape; each kernel launched at its case shape into
    NaN-filled, guarded outputs writes exactly its declared ranges.  F1
    (``check/corpus/racy_sum.cu``, built with the others): equal to its
    plain version at one row tile (grid (1, U), integer-valued inputs);
    its lost updates at the analyzer's grid (4, 2) and at grid (4096, 2)
    printed, not asserted; timed against its plain version and
    ``x.sum(0)``; launched 0 times on the main paths.

Every torch.profiler reading (kernels' device times, the main paths'
busy shares) is taken last, after all host-clock and CUDA-event timings:
a finished profiler trace slows every later launch (``PROFILED``).

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


def device_ms_per_call(fn, kernel_names, iters=50):
    """Device time of the kernels whose names contain one of
    ``kernel_names`` (a string or a tuple of strings) per call of ``fn``,
    from torch.profiler's CUDA activity (None if it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if isinstance(kernel_names, str):
        kernel_names = (kernel_names,)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if any(n in e.key for n in kernel_names))
    return us / iters / 1e3 if us > 0 else None


def profile_call(label, fn, wall_ms):
    """``fn()`` under torch.profiler: the kernels that take the most device
    time, and their sum over the wall time of the profiled call and of an
    unprofiled one (``wall_ms``; the profiler slows the host, so the first
    share is a lower bound).  Returns the device ms (None if the profiler
    recorded no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    launched = sum(r[1] for r in rows)
    if not rows:
        log(f"profile: {label}: no device activity recorded "
            f"(device busy share not measured)")
        return None
    log(f"profile: {label}: device kernels {dev_ms:.3f} ms in {launched} "
        f"launches; wall {prof_ms:.3f} ms profiled (busy share "
        f"{dev_ms / prof_ms:.4f}), {wall_ms:.3f} ms unprofiled (busy share "
        f"{dev_ms / wall_ms:.4f}); top kernels by device time:")
    for t, n, key in rows[:10]:
        log(f"profile:   {t:10.3f} ms {n:7d} x  {key[:90]}")
    return dev_ms


def profile_run(name, engine, rounds, wall_ms):
    """One main-path run of the simulator under torch.profiler (queued)."""
    from repro_torch.core.scenarios import run_scenario
    profile_later(f"{name}/{engine} {rounds} rounds",
                  lambda: run_scenario(name, engine=engine, use_kernel=True,
                                       device=DEVICE, rounds=rounds),
                  wall_ms)


# A finished torch.profiler trace leaves the card's launch path slower for
# the rest of the process (on an H100 80GB HBM3 at 700 W, ``launch_us``
# read 10.2 us per tiny launch before the queue below and 16.9 us after
# it).  So every profiler reading is queued here and taken after all
# host-clock and CUDA-event timings of the run.
PROFILED = []


def launch_us(dev, n=20000):
    """Host time per launch of a tiny kernel (an in-place add on 16
    floats) over ``n`` back-to-back launches, synchronised around them."""
    import torch
    x = torch.zeros(16, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def profile_later(label, fn, wall_ms):
    PROFILED.append(lambda: profile_call(label, fn, wall_ms))


def device_time_later(label, row, fn, kernel_names, iters=50):
    """Queue the profiler's device time per call of ``fn``'s kernels: it
    is logged and stored in ``row["device_ms"]`` when the queue runs."""
    row["device_ms"] = None

    def measure():
        busy = device_ms_per_call(fn, kernel_names, iters)
        row["device_ms"] = busy
        log(f"device time: {label}: "
            f"{'not measured' if busy is None else f'{busy:.6f} ms'} per "
            f"call (torch.profiler)")
    PROFILED.append(measure)


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
    record = {
        "name": "weighted_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg/kernel.py:48",
        "max_abs_err": max_err, "ms": ms["kernel"],
        "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": ms["library"],
    }
    device_time_later("weighted_agg per full-model merge (its 8 launches)",
                      record, runs["kernel"], "weighted_agg_kernel")
    return record


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
        tag = "f32" if dtype == torch.float32 else "bf16"
        lib = (f"addmv {ms['library']:.6f} ms" if "library" in ms
               else "addmv not timed (f32 only)")
        log(f"kernels: ring_agg U={U} P={P} {tag} uploads "
            f"({n_sets} input sets, {bytes_moved} bytes per chain): kernel "
            f"{ms['kernel']:.6f} ms, plain {ms['plain']:.6f} ms, {lib}")
        log(f"kernels:   bound {max(bound_bytes, bound_ops):.6f} ms "
            f"(bytes {bound_bytes:.6f}, operations {bound_ops:.6f}); "
            f"samples {samples}")
        timings[tag] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": ms.get("library")}
        device_time_later(f"ring_agg U={U} P={P} {tag} uploads per chain",
                          timings[tag], rotating(ops.ring_agg, sets),
                          "ring_agg_kernel")
    return {
        "name": "ring_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg/kernel.py:113",
        "max_abs_err": max_err, **timings["f32"],
        "shape": f"U={U} P={P} f32 uploads",
        "geometries": {f"U={U} P={P} {tag} uploads": row
                       for tag, row in timings.items()},
    }


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


# K4 decode_attention / K5 swa_attention: f32 inputs from N(0, 1) within
# 2e-5 of the plain version (the online softmax sums in another order than
# the dense softmax), bf16 within 3e-2 (the plain version rounds scores and
# weights to bf16; the band of repro's own bf16 kernel test)
ATTN_TOL = {"f32": 2e-5, "bf16": 3e-2}
BF16_FLOP_PER_S = 989e12
# the serve path: smollm-360m behind 8 slots of 2048 positions, 16
# requests of 64-1024 prompt tokens and 64 new tokens each
SERVE_ARCH, SERVE_SLOTS, SERVE_MAX_SEQ = "smollm-360m", 8, 2048
SERVE_REQUESTS, SERVE_NEW, SERVE_PROMPT = 16, 64, (64, 1024)
# card vs CPU on the serve path: 4 layers, 2 prompts, 16 forced steps;
# the two sides sum the f32 products in different orders (a few ulps per
# layer on logits of size ~1), far under the 1e-3 a wrong kernel, cache
# write or position would exceed
SERVE_CPU_LAYERS, SERVE_CPU_PROMPTS, SERVE_CPU_STEPS = 4, 2, 16
SERVE_CPU_TOL = dict(atol=1e-3, rtol=1e-3)
# timed geometries, G = 3, Kv = 5, hd = 64 as smollm-360m's attention; the
# first of each is the serve path's shape.  K4: (label, B, S, dtype) at
# pos = S - 1 (S = 32768 is the decode_32k shape's cache); K5: (label, S,
# dtype) at B = 1, window = S (prefill of an S-token prompt)
DECODE_TIMED = (("serve B=8 S=2048 f32", SERVE_SLOTS, SERVE_MAX_SEQ, "f32"),
                ("B=8 S=32768 f32", 8, 32768, "f32"),
                ("decode_32k B=128 S=32768 bf16", 128, 32768, "bf16"))
SWA_TIMED = (("prefill S=1024 f32", 1024, "f32"),
             ("prefill S=512 f32", 512, "f32"),
             ("prefill S=1024 bf16", 1024, "bf16"))


def in_turns(runs, reps=6, iters=100, warmup=10):
    """Median ms per call of each zero-argument call in ``runs``, timed in
    turns with the order alternating; returns (medians, samples)."""
    samples = {k: [] for k in runs}
    for rep in range(reps):
        order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
        for name in order:
            samples[name].append(time_ms(runs[name], iters, warmup))
    return {k: float(np.median(v)) for k, v in samples.items()}, samples


def attn_inputs(shape_q, shape_kv, dtype, gen, dev):
    import torch
    return (torch.randn(shape_q, generator=gen, device=dev).to(dtype),
            torch.randn(shape_kv, generator=gen, device=dev).to(dtype),
            torch.randn(shape_kv, generator=gen, device=dev).to(dtype))


def attn_check(name, out, want, tag, where):
    """max |out - want|, checked against ``ATTN_TOL[tag]``."""
    import torch
    torch.cuda.synchronize()
    check(out.shape == want.shape and out.dtype == want.dtype,
          f"{name} shape/dtype at {where}")
    e = (out.float() - want.float()).abs().max().item()
    check(e <= ATTN_TOL[tag],
          f"{name} differs from its plain version by {e} at {where}")
    return e


def attn_timings(label, runs, sets_info, bytes_moved, flops, peak, reps,
                 iters, warmup):
    """Time kernel / plain / library in turns; log and return the row."""
    ms, samples = in_turns(runs, reps, iters, warmup)
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / peak * 1e3
    log(f"kernels: {label} ({sets_info}, {bytes_moved} bytes, {flops} "
        f"flops): kernel {ms['kernel']:.6f} ms, plain {ms['plain']:.6f} "
        f"ms, SDPA {ms['library']:.6f} ms")
    log(f"kernels:   bound {max(bound_bytes, bound_ops):.6f} ms (bytes "
        f"{bound_bytes:.6f}, operations {bound_ops:.6f}); samples {samples}")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": ms["library"]}


def phase_decode_kernel(dev):
    """K4 against its plain version over G, hd, pos and dtypes; then
    kernel, plain version and SDPA timed at three geometries."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    kernels.reset_launches()
    err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for G in (1, 3, 4):
            for hd in (64, 128):
                for B, S, Kv in ((SERVE_SLOTS, SERVE_MAX_SEQ, 5),
                                 (2, 1000, 2)):
                    q, k, v = attn_inputs((B, G * Kv, hd), (B, S, Kv, hd),
                                          dtype, gen, dev)
                    mixed = torch.randint(0, S, (B,), generator=gen,
                                          device=dev, dtype=torch.int32)
                    for pname, pos in (("0", 0), ("S-1", S - 1),
                                       ("vector", mixed)):
                        e = attn_check(
                            "decode_attention",
                            ops.decode_attention(q, k, v, pos),
                            ref.decode_attention(q, k, v, pos), tag,
                            f"B={B} S={S} G={G} hd={hd} {tag} pos={pname}")
                        err[tag] = max(err[tag], e)
                        cases += 1
    launched = kernels.launch_counts()["decode_attention"]
    check(launched == cases, f"decode_attention launched {launched} times "
          f"for {cases} calls")
    log(f"kernels: decode_attention within tolerance of its plain version "
        f"in {cases} cases (G in (1, 3, 4), hd in (64, 128), pos = 0, "
        f"S - 1 and a per-row vector, B/S/Kv = 8/2048/5 and 2/1000/2); "
        f"max_abs_err f32 {err['f32']} (tol {ATTN_TOL['f32']}), bf16 "
        f"{err['bf16']} (tol {ATTN_TOL['bf16']}); {launched} launches")

    geometries = {}
    for label, B, S, tag in DECODE_TIMED:
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        peak = FP32_FLOP_PER_S if tag == "f32" else BF16_FLOP_PER_S
        Kv, G, hd = 5, 3, 64
        H = G * Kv
        s = torch.finfo(dtype).bits // 8
        pos = S - 1
        bytes_moved = (2 * B * Kv * (pos + 1) * hd + 2 * B * H * hd) * s
        flops = 4 * B * H * (pos + 1) * hd
        n_sets = max(1, int(np.ceil(2 * L2_BYTES / bytes_moved)))
        mask = (torch.arange(S, device=dev) <= pos).expand(B, 1, 1, S)
        sets = [attn_inputs((B, H, hd), (B, S, Kv, hd), dtype, gen, dev)
                for _ in range(n_sets)]

        def kernel(q, k, v):
            return ops.decode_attention(q, k, v, pos)

        def plain(q, k, v):
            return ref.decode_attention(q, k, v, pos)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)[:, :, 0]
        runs = {"kernel": rotating(kernel, sets),
                "plain": rotating(plain, sets),
                "library": rotating(sdpa, sets)}
        attn_check("SDPA yardstick", sdpa(*sets[0]), kernel(*sets[0]), tag,
                   label)
        big = bytes_moved > 1e9
        iters, warmup, reps = (5, 2, 4) if big else (100, 10, 6)
        chunk, n_chunks = ops.split(B, S, Kv)
        geometries[label] = attn_timings(
            f"decode_attention {label} G={G} hd={hd} pos=S-1",
            runs, f"{n_sets} input sets; {n_chunks} chunks of {chunk}, "
            f"{B * Kv * n_chunks} blocks", bytes_moved, flops, peak,
            reps, iters, warmup)
        device_time_later(f"decode_attention {label}", geometries[label],
                          rotating(kernel, sets),
                          ("decode_chunk_kernel", "decode_combine_kernel"),
                          iters=iters)
    main = geometries[DECODE_TIMED[0][0]]
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:76",
        "max_abs_err": max(err.values()), "max_abs_err_f32": err["f32"],
        "max_abs_err_bf16": err["bf16"], "tolerance": ATTN_TOL,
        **main, "shape": DECODE_TIMED[0][0], "geometries": geometries,
    }


def phase_swa_kernel(dev):
    """K5 against its plain version over windows, S, G and dtypes; then
    kernel, plain version and SDPA timed at prefill geometries."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.swa_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    kernels.reset_launches()
    err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for G in (1, 3):
            for B, S, Kv, hd in ((1, 1024, 5, 64), (2, 200, 2, 128),
                                 (1, 33, 1, 64)):
                q, k, v = attn_inputs((B, S, G * Kv, hd), (B, S, Kv, hd),
                                      dtype, gen, dev)
                for window in (S, 64, 45, 1, 10 * S):
                    e = attn_check(
                        "swa_attention", ops.swa_attention(q, k, v, window),
                        ref.swa_attention(q, k, v, window), tag,
                        f"B={B} S={S} G={G} hd={hd} {tag} window={window}")
                    err[tag] = max(err[tag], e)
                    cases += 1
    launched = kernels.launch_counts()["swa_attention"]
    check(launched == cases, f"swa_attention launched {launched} times "
          f"for {cases} calls")
    log(f"kernels: swa_attention within tolerance of its plain version in "
        f"{cases} cases (G in (1, 3); B/S/Kv/hd = 1/1024/5/64, 2/200/2/128, "
        f"1/33/1/64; window S, 64, 45, 1, 10 S); max_abs_err f32 "
        f"{err['f32']} (tol {ATTN_TOL['f32']}), bf16 {err['bf16']} (tol "
        f"{ATTN_TOL['bf16']}); {launched} launches")

    geometries = {}
    for label, S, tag in SWA_TIMED:
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        peak = FP32_FLOP_PER_S if tag == "f32" else BF16_FLOP_PER_S
        B, Kv, G, hd = 1, 5, 3, 64
        H = G * Kv
        s = torch.finfo(dtype).bits // 8
        bytes_moved = (2 * B * S * H * hd + 2 * B * S * Kv * hd) * s
        flops = 4 * B * H * (S * (S + 1) // 2) * hd   # window = S: causal
        n_sets = int(np.ceil(2 * L2_BYTES / bytes_moved))
        sets = [attn_inputs((B, S, H, hd), (B, S, Kv, hd), dtype, gen, dev)
                for _ in range(n_sets)]

        def kernel(q, k, v):
            return ops.swa_attention(q, k, v, S)

        def plain(q, k, v):
            return ref.swa_attention(q, k, v, S)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)
        runs = {"kernel": rotating(kernel, sets),
                "plain": rotating(plain, sets),
                "library": rotating(sdpa, sets)}
        attn_check("SDPA yardstick", sdpa(*sets[0]), kernel(*sets[0]), tag,
                   label)
        geometries[label] = attn_timings(
            f"swa_attention {label} B=1 H=15 Kv=5 hd=64 window=S", runs,
            f"{n_sets} input sets", bytes_moved, flops, peak,
            reps=6, iters=50, warmup=5)
        device_time_later(f"swa_attention {label}", geometries[label],
                          rotating(kernel, sets), "swa_kernel")
    main = geometries[SWA_TIMED[0][0]]
    return {
        "name": "swa_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention/kernel.py:101",
        "max_abs_err": max(err.values()), "max_abs_err_f32": err["f32"],
        "max_abs_err_bf16": err["bf16"], "tolerance": ATTN_TOL,
        **main, "shape": SWA_TIMED[0][0], "geometries": geometries,
    }


def serve_prompts(vocab):
    """The serve phase's requests: numpy prompts of 64-1024 tokens."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                           SERVE_REQUESTS)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def timed(fn, out):
    """``fn`` that appends its own time (ms, to the card's finish) to
    ``out``."""
    import torch

    def call(*a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res
    return call


def serve_run(cfg, model, prompts, stats=None):
    """One drained ``BatchedServer`` run; returns (requests, ticks,
    seconds).  With ``stats``, prefill and decode-step times land in it."""
    import torch
    from repro_torch.serving import BatchedServer
    srv = BatchedServer(cfg, model, n_slots=SERVE_SLOTS,
                        max_seq=SERVE_MAX_SEQ)
    if stats is not None:
        srv._prefill = timed(srv._prefill, stats["prefill_ms"])
        srv._step = timed(srv._step, stats["tick_ms"])
    reqs = [srv.submit(p, SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = srv.run_until_drained()
    torch.cuda.synchronize()
    return reqs, ticks, time.perf_counter() - t0


def phase_serve(dev):
    """Full-width smollm-360m served on the card; returns the launches of
    (decode_attention, swa_attention) in the counted run."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.resolved_head_dim} "
        f"vocab {cfg.vocab_size}: {T.param_count(cfg)} f32 parameters, "
        f"torch init on the card {time.perf_counter() - t0:.3f} s")
    prompts = serve_prompts(cfg.vocab_size)
    t0 = time.perf_counter()                     # warm-up, not counted
    serve_run(cfg, model, prompts[:2])
    log(f"serve: warm-up (2 requests) {time.perf_counter() - t0:.3f} s")

    stats = {"prefill_ms": [], "tick_ms": []}
    kernels.reset_launches()
    reqs, ticks, wall = serve_run(cfg, model, prompts, stats)
    counts = kernels.launch_counts()
    admitted = len(stats["prefill_ms"])
    check(admitted == SERVE_REQUESTS,
          f"serve: {admitted} of {SERVE_REQUESTS} requests admitted")
    for r in reqs:
        check(r.done and len(r.out) == SERVE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"serve: request {r.rid} out {r.out}")
    check(counts["decode_attention"] == cfg.n_layers * ticks,
          f"serve: {counts['decode_attention']} decode_attention launches "
          f"for {ticks} ticks of {cfg.n_layers} layers")
    check(counts["swa_attention"] == cfg.n_layers * admitted,
          f"serve: {counts['swa_attention']} swa_attention launches for "
          f"{admitted} admits of {cfg.n_layers} layers")
    check(counts["weighted_agg"] == counts["ring_agg"] == 0,
          f"serve: aggregation kernels launched {counts}")
    new_tokens = SERVE_REQUESTS * SERVE_NEW
    lengths = [len(p) for p in prompts]
    log(f"serve: {SERVE_REQUESTS} requests (prompts {min(lengths)}-"
        f"{max(lengths)} tokens, mean {np.mean(lengths):.1f}; {SERVE_NEW} "
        f"new tokens each) over {SERVE_SLOTS} slots of {SERVE_MAX_SEQ}: "
        f"{ticks} ticks in {wall:.3f} s, {new_tokens / wall:.1f} tokens/s; "
        f"launches {counts} (decode_attention = {cfg.n_layers} x {ticks} "
        f"ticks, swa_attention = {cfg.n_layers} x {admitted} admits)")
    log(f"serve:   prefill ms per request: mean "
        f"{np.mean(stats['prefill_ms']):.3f}, median "
        f"{np.median(stats['prefill_ms']):.3f}, max "
        f"{np.max(stats['prefill_ms']):.3f}; decode ms per tick: mean "
        f"{np.mean(stats['tick_ms']):.3f}, median "
        f"{np.median(stats['tick_ms']):.3f}; sum prefill "
        f"{np.sum(stats['prefill_ms']):.3f} ms, sum ticks "
        f"{np.sum(stats['tick_ms']):.3f} ms of {wall * 1e3:.3f} ms")
    profile_later(f"serve {cfg.name} {SERVE_REQUESTS} requests",
                  lambda: serve_run(cfg, model, prompts), wall * 1e3)
    return counts["decode_attention"], counts["swa_attention"]


def phase_serve_vs_cpu(dev):
    """The serve path cut to 4 layers, card against CPU, one CPU init:
    prefill and teacher-forced decode steps on both sides."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE_ARCH).variant(n_layers=SERVE_CPU_LAYERS)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    worst, agree, steps = 0.0, 0, 0

    def compare(lg, lc, where):
        d = (lg.cpu() - lc).abs().max().item()
        check(torch.allclose(lg.cpu(), lc, **SERVE_CPU_TOL),
              f"serve card vs CPU: {where} logits differ by {d}")
        return d

    for prompt in serve_prompts(cfg.vocab_size)[:SERVE_CPU_PROMPTS]:
        P = len(prompt)
        tokens = torch.from_numpy(prompt[None])
        t0 = time.perf_counter()
        lc, cc = T.prefill(cfg, cpu, tokens)
        t1 = time.perf_counter()
        lg, cg = T.prefill(cfg, gpu, tokens.to(dev))
        worst = max(worst, compare(lg, lc, f"prefill (P={P})"))
        cc = T.grow_cache(cfg, cc, 1, P + SERVE_CPU_STEPS)
        cg = T.grow_cache(cfg, cg, 1, P + SERVE_CPU_STEPS)
        forced = torch.argmax(lc[:, -1:], -1)
        for i in range(SERVE_CPU_STEPS):
            lc, cc = T.decode_step(cfg, cpu, forced, cc, P + i)
            lg, cg = T.decode_step(cfg, gpu, forced.to(dev), cg, P + i)
            worst = max(worst, compare(lg, lc, f"step {i} (P={P})"))
            agree += int(torch.equal(torch.argmax(lg, -1).cpu(),
                                     torch.argmax(lc, -1)))
            steps += 1
            forced = torch.argmax(lc, -1)        # teacher-forced: CPU's
        cache_diff = max((cg["stack"]["sub0"]["mixer"][k].cpu()
                          - cc["stack"]["sub0"]["mixer"][k]).abs().max()
                         .item() for k in ("k", "v"))
        log(f"serve vs CPU: {cfg.name} cut to {cfg.n_layers} layers, "
            f"prompt {P} tokens (CPU prefill {t1 - t0:.3f} s): cache max "
            f"|diff| {cache_diff}")
    log(f"serve vs CPU: prefill + {SERVE_CPU_STEPS} teacher-forced steps "
        f"on {SERVE_CPU_PROMPTS} prompts: logits max |diff| {worst} (atol "
        f"{SERVE_CPU_TOL['atol']}, rtol {SERVE_CPU_TOL['rtol']}); greedy "
        f"tokens agree in {agree} of {steps} steps")


# K3 cross_entropy: (nll, lse) within 1e-4 of the plain version in f32
# (repro's bar for its kernel, tests/test_kernels.py) and 3e-2 in bf16; rows
# of +-1e4 logits within 1e-3 (repro's bar for them: lse ~ 1e4, where one
# f32 ulp is 1e-3); d logits within 1e-6 of plain autograd
CE_TOL = {"f32": 1e-4, "bf16": 3e-2}
CE_EXTREME_TOL, CE_GRAD_TOL = 1e-3, 1e-6
CE_R, CE_V = (1, 7, 512, 4096), (512, 1111, 49152, 131072)
CE_GRAD_CASES = ((7, 1111), (512, 49152), (4096, 49152))
# (label, R, V, dtype): the training loop's local step (batch 8 x seq 64)
# first, its held-out eval (32 x 64), make_train_step at B 8 S 512, the
# same in bf16, and mistral-nemo's vocab (benchmarks/kernel_micro.py)
CE_TIMED = (("train step R=512 V=49152 f32", 512, 49152, "f32"),
            ("held-out R=2048 V=49152 f32", 2048, 49152, "f32"),
            ("train_step R=4096 V=49152 f32", 4096, 49152, "f32"),
            ("train_step R=4096 V=49152 bf16", 4096, 49152, "bf16"),
            ("R=256 V=131072 f32", 256, 131072, "f32"))
CE_OPS_PER_LOGIT = 4       # compare, subtract, exponential, add
# training: full-width smollm-360m, train.py's defaults, 10 rounds
TRAIN_ROUNDS = 10
TRAIN_STEP_B, TRAIN_STEP_S, TRAIN_STEP_TIMED = 8, 512, 5
# card vs CPU on the training path: 4 layers, 2 rounds x 2 local steps;
# cuBLAS and the CPU sum the f32 products in different orders, a few ulps
# per op that 4 SGD steps at lr 0.05 carry forward; 1e-4 on weights of size
# ~0.01-1 is far above that and far below what a wrong kernel, gradient or
# merge would change
TRAIN_CPU_LAYERS, TRAIN_CPU_ROUNDS, TRAIN_CPU_ITERS = 4, 2, 2
TRAIN_CPU_LOSS_RTOL = 1e-4
TRAIN_CPU_TOL = dict(atol=1e-4, rtol=1e-3)


def ce_inputs(R, V, dtype, gen, dev):
    import torch
    x = (torch.randn(R, V, generator=gen, device=dev) * 3).to(dtype)
    y = torch.randint(0, V, (R,), generator=gen, device=dev)
    y[0] = 0
    y[-1] = V - 1
    return x, y


def ce_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def phase_ce_kernel(dev):
    """K3 against its plain version over R, V, dtypes and labels, with
    +-1e4 rows; the backward against plain autograd; then kernel, plain
    version and ``F.cross_entropy`` timed at the training path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.cross_entropy import ops, ref

    gen = torch.Generator(device=dev).manual_seed(6)
    kernels.reset_launches()
    err = {"f32": 0.0, "bf16": 0.0, "extreme": 0.0}
    cases = 0
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for R in CE_R:
            for V in CE_V:
                x, y = ce_inputs(R, V, dtype, gen, dev)
                got = ops.nll_and_lse(x, y)
                torch.cuda.synchronize()
                check(all(t.dtype == torch.float32 and t.shape == (R,)
                          for t in got), f"cross_entropy shape/dtype R={R} "
                      f"V={V} {tag}")
                e = ce_err(got, ref.nll_and_lse(x, y))
                check(e <= CE_TOL[tag], f"cross_entropy differs from its "
                      f"plain version by {e} at R={R} V={V} {tag}")
                err[tag] = max(err[tag], e)
                cases += 1
                del x, y, got
        for V in CE_V:
            x = torch.tensor([1e4, -1e4, 0.0, 5.0], device=dev).repeat(
                8, V // 4 + 1)[:, :V].contiguous().to(dtype)
            y = torch.tensor([0, 1, 2, 3, V - 1, 0, 1, 2], device=dev)
            got = ops.nll_and_lse(x, y)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"cross_entropy: +-1e4 rows not finite at V={V} {tag}")
            e = ce_err(got, ref.nll_and_lse(x, y))
            check(e <= CE_EXTREME_TOL, f"cross_entropy: +-1e4 rows differ "
                  f"by {e} at V={V} {tag}")
            err["extreme"] = max(err["extreme"], e)
            cases += 1
    launched = kernels.launch_counts()["cross_entropy"]
    check(launched == cases, f"cross_entropy launched {launched} times for "
          f"{cases} calls")
    grad_err = 0.0
    for R, V in CE_GRAD_CASES:
        x, y = ce_inputs(R, V, torch.float32, gen, dev)
        grads = []
        for use_kernel in (True, False):
            xl = x.clone().requires_grad_()
            loss = ops.lm_loss(xl[None], y[None], use_kernel=use_kernel)
            grads.append(torch.autograd.grad(loss, xl)[0])
        e = (grads[0] - grads[1]).abs().max().item()
        check(e <= CE_GRAD_TOL, f"cross_entropy backward differs from plain "
              f"autograd by {e} at R={R} V={V}")
        grad_err = max(grad_err, e)
        del x, grads
    log(f"kernels: cross_entropy within tolerance of its plain version in "
        f"{cases} cases (R in {CE_R}, V in {CE_V}, f32 and bf16, labels 0, "
        f"V - 1 and random; +-1e4 rows at every V); max_abs_err f32 "
        f"{err['f32']} (tol {CE_TOL['f32']}), bf16 {err['bf16']} (tol "
        f"{CE_TOL['bf16']}), +-1e4 rows {err['extreme']} (tol "
        f"{CE_EXTREME_TOL}); backward d logits vs plain autograd at "
        f"{CE_GRAD_CASES} max_abs_err {grad_err} (tol {CE_GRAD_TOL}); "
        f"{launched} launches")

    geometries = {}
    for label, R, V, tag in CE_TIMED:
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        s = torch.finfo(dtype).bits // 8
        # logits and i32 labels read once, nll and lse written once
        bytes_moved = R * V * s + R * 4 + 2 * R * 4
        flops = CE_OPS_PER_LOGIT * R * V
        n_sets = max(2, int(np.ceil(2 * L2_BYTES / bytes_moved)))
        sets = [ce_inputs(R, V, dtype, gen, dev) for _ in range(n_sets)]
        runs = {"kernel": rotating(ops.nll_and_lse, sets),
                "plain": rotating(ref.nll_and_lse, sets),
                "library": rotating(
                    lambda x, y: F.cross_entropy(x, y, reduction="none"),
                    sets)}
        # the yardstick computes the same function (in bf16 it returns
        # bf16: one ulp is 2^-7 relative)
        lib = F.cross_entropy(*sets[0], reduction="none").float()
        nll = ops.nll_and_lse(*sets[0])[0]
        d = (lib - nll).abs().max().item()
        check(torch.allclose(lib, nll, atol=CE_TOL["f32"],
                             rtol=0.0 if tag == "f32" else 2 ** -7),
              f"F.cross_entropy yardstick differs by {d} at {label}")
        ms, samples = in_turns(runs, reps=6, iters=50, warmup=5)
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / FP32_FLOP_PER_S * 1e3
        log(f"kernels: cross_entropy {label} ({n_sets} input sets, "
            f"{bytes_moved} bytes): kernel {ms['kernel']:.6f} ms, plain "
            f"{ms['plain']:.6f} ms, F.cross_entropy {ms['library']:.6f} ms")
        log(f"kernels:   bound {max(bound_bytes, bound_ops):.6f} ms (bytes "
            f"{bound_bytes:.6f}, operations {bound_ops:.6f}); samples "
            f"{samples}")
        geometries[label] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": ms["library"]}
        device_time_later(f"cross_entropy {label}", geometries[label],
                          rotating(ops.nll_and_lse, sets),
                          "cross_entropy_kernel")
    main = geometries[CE_TIMED[0][0]]
    return {
        "name": "cross_entropy", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cross_entropy.cu",
        "replaces": "src/repro/kernels/cross_entropy/kernel.py:77",
        "max_abs_err": max(err["f32"], err["bf16"]),
        "max_abs_err_f32": err["f32"], "max_abs_err_bf16": err["bf16"],
        "max_abs_err_extreme": err["extreme"], "max_abs_err_grad": grad_err,
        "tolerance": CE_TOL, **main, "shape": CE_TIMED[0][0],
        "geometries": geometries,
    }


def train_args(*extra):
    from repro_torch.launch import train
    return train.build_parser().parse_args(
        ["--use-kernel", "--rounds", str(TRAIN_ROUNDS), *extra])


def phase_train(dev):
    """``launch/train.py``'s loop at full width on the card; returns the
    launches of (cross_entropy, weighted_agg) in the counted run."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE_ARCH)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    leaves = len(T.param_dict(model))
    args = train_args()
    # warm-up, not counted: the same run, so the caching allocator already
    # holds the segments of the pending downloads the counted run keeps
    t0 = time.perf_counter()
    train.run_training(cfg, model, args, log=lambda *a: None)
    torch.cuda.synchronize()
    log(f"train: warm-up (the same {args.rounds} rounds) "
        f"{time.perf_counter() - t0:.3f} s; {leaves} parameter leaves")

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)      # the model, queued inputs
    lines = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    run = train.run_training(cfg, model, args, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    for line in lines:
        log(f"train:   {line}")
    evals = len(run.heldout)
    steps = args.rounds * args.l_iters
    check(counts["cross_entropy"] == steps + evals,
          f"train: {counts['cross_entropy']} cross_entropy launches for "
          f"{steps} local steps and {evals} held-out evals")
    check(counts["weighted_agg"] == leaves * args.rounds,
          f"train: {counts['weighted_agg']} weighted_agg launches for "
          f"{args.rounds} merges of {leaves} leaves")
    check(counts["ring_agg"] == counts["decode_attention"]
          == counts["swa_attention"] == 0, f"train: launches {counts}")
    losses = [float(v) for v in run.local_losses] + [v for _, v in
                                                     run.heldout]
    check(len(run.vehicles) == args.rounds and all(np.isfinite(losses)),
          f"train: losses {losses}")
    check(all(bool(torch.isfinite(v).all()) for v in run.params.values()),
          "train: final global model not finite")

    # ms per SGD step, timed alone: the loop's step (loss and gradient
    # through K3, the update) on one minibatch, synchronised
    vg = train.lm_loss_and_grad(cfg, model)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq_len + 1)).astype(
            np.int32)).to(dev)
    params = T.param_dict(model)

    def sgd_step(p):
        loss, grads = vg(p, tokens)
        return {k: w - args.lr * grads[k] for k, w in p.items()}, loss
    p, _ = sgd_step(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        p, _ = sgd_step(p)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    del p
    tokens_per_step = args.batch * args.seq_len
    log(f"train: {cfg.name} full width ({T.param_count(cfg)} f32 "
        f"parameters), {args.rounds} rounds x {args.l_iters} local steps "
        f"(batch {args.batch} x seq {args.seq_len}, lr {args.lr}), "
        f"use_kernel: {wall:.3f} s, {wall / args.rounds * 1e3:.3f} ms/round, "
        f"{steps * tokens_per_step / wall:.1f} trained tokens/s end to end; "
        f"vehicles {run.vehicles}; held-out {run.heldout}; peak device "
        f"memory {peak_gb:.3f} GB above the model")
    log(f"train:   SGD step timed alone: {step_ms:.3f} ms per step, "
        f"{tokens_per_step / step_ms * 1e3:.1f} tokens/s; launches {counts} "
        f"(cross_entropy = {steps} steps + {evals} evals, weighted_agg = "
        f"{leaves} leaves x {args.rounds} merges)")
    profile_later(f"train {cfg.name} {args.rounds} rounds",
                  lambda: train.run_training(cfg, model, args,
                                             log=lambda *a: None),
                  wall * 1e3)
    return counts["cross_entropy"], counts["weighted_agg"]


def phase_train_step(dev):
    """``make_train_step`` at full width, B 8, S 512."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import synth_tokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE_ARCH)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    step = make_train_step(cfg, lr=0.05)
    batch = {"tokens": torch.from_numpy(synth_tokens(
        TRAIN_STEP_B, TRAIN_STEP_S + 1, cfg.vocab_size, seed=5)).to(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params, metrics = step(model, T.param_dict(model), batch)   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEP_TIMED):
        params, metrics = step(model, params, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEP_TIMED * 1e3
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    check(counts["cross_entropy"] == TRAIN_STEP_TIMED,
          f"train_step: {counts['cross_entropy']} cross_entropy launches for "
          f"{TRAIN_STEP_TIMED} steps")
    check(all(np.isfinite(losses)), f"train_step: losses {losses}")
    rows = TRAIN_STEP_B * TRAIN_STEP_S
    log(f"train_step: {cfg.name} full width, B {TRAIN_STEP_B} S "
        f"{TRAIN_STEP_S} ({rows} rows into cross_entropy): {ms:.3f} ms per "
        f"step over {TRAIN_STEP_TIMED} steps, {rows / ms * 1e3:.1f} tokens/s; "
        f"losses {losses}; peak device memory "
        f"{(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.3f} GB above "
        f"the model")


def phase_train_vs_cpu(dev):
    """The training loop cut to 4 layers, card against CPU, one CPU
    init."""
    import copy

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    cfg = get_config(SERVE_ARCH).variant(n_layers=TRAIN_CPU_LAYERS)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    args = train_args("--rounds", str(TRAIN_CPU_ROUNDS), "--l-iters",
                      str(TRAIN_CPU_ITERS))
    runs = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs[name] = train.run_training(cfg, model, args,
                                        log=lambda *a: None)
        counts = kernels.launch_counts()
        log(f"train vs CPU: {cfg.name} cut to {cfg.n_layers} layers on "
            f"{name}: {time.perf_counter() - t0:.3f} s; launches {counts}")
        if name == "cuda":
            want = args.rounds * args.l_iters + len(runs[name].heldout)
            check(counts["cross_entropy"] == want,
                  f"train vs CPU: {counts['cross_entropy']} cross_entropy "
                  f"launches on the card, expected {want}")
    g, c = runs["cuda"], runs["cpu"]
    check(g.vehicles == c.vehicles, f"train vs CPU: vehicles {g.vehicles} "
          f"vs {c.vehicles}")
    lg = np.array([float(v) for v in g.local_losses] + [v for _, v in
                                                        g.heldout])
    lc = np.array([float(v) for v in c.local_losses] + [v for _, v in
                                                        c.heldout])
    loss_rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    check(loss_rel <= TRAIN_CPU_LOSS_RTOL, f"train vs CPU: losses {lg} vs "
          f"{lc}")
    worst = 0.0
    for k, v in c.params.items():
        d = (g.params[k].cpu() - v).abs().max().item()
        worst = max(worst, d)
        check(torch.allclose(g.params[k].cpu(), v, **TRAIN_CPU_TOL),
              f"train vs CPU: final {k} differs by {d}")
    log(f"train vs CPU: {TRAIN_CPU_ROUNDS} rounds x {TRAIN_CPU_ITERS} local "
        f"steps, vehicles identical {g.vehicles}; losses max relative diff "
        f"{loss_rel} (rtol {TRAIN_CPU_LOSS_RTOL}); final params max |diff| "
        f"{worst} (atol {TRAIN_CPU_TOL['atol']}, rtol "
        f"{TRAIN_CPU_TOL['rtol']})")


# F1, the race analyzer's racy fixture: launches of the analyzer's grid
# (4, 2) and of the large grid whose lost updates are reported (not
# asserted: a racy kernel's result is undefined)
F1_LOST_RUNS = 5
F1_LARGE = (8192, 2, 2)            # R, U, block rows: 4,096 blocks a column
# elements of NaN before and after each output of the write-set checks
# (256 bytes: the outputs stay 16-byte aligned)
GUARD = 64


def run_analyzer():
    """``python -m repro_torch.check src/repro_torch --strict
    --format=json`` in this process: (exit code, the JSON report)."""
    import contextlib
    import io
    from repro_torch.check import runner
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = runner.main([str(ROOT / "src" / "repro_torch"), "--strict",
                          "--format=json"])
    return rc, json.loads(buf.getvalue())


def guarded(n, dev):
    """(buffer, view): ``n`` f32 elements with GUARD NaNs on each side."""
    import torch
    buf = torch.full((n + 2 * GUARD,), float("nan"), device=dev)
    return buf, buf[GUARD:GUARD + n]


def check_written(label, geo, name, buf):
    """The elements of ``buf``'s view that came back written (not NaN) are
    exactly the union of ``geo``'s declared ranges for output ``name``,
    and both guards are still NaN."""
    import torch
    torch.cuda.synchronize()
    got = ~torch.isnan(buf[GUARD:-GUARD]).cpu().numpy()
    want = geo.written(name)
    check(bool(torch.isnan(buf[:GUARD]).all())
          and bool(torch.isnan(buf[-GUARD:]).all()),
          f"{label}: {geo.kernel} stored outside {name}")
    check(np.array_equal(got, want),
          f"{label}: {geo.kernel} wrote {int(got.sum())} elements of "
          f"{name}, {int((got != want).sum())} differ from the declared "
          f"{int(want.sum())}")
    return int(got.sum())


def nan_launches(dev):
    """Launch each production kernel at its registered case shape into
    NaN-filled, guarded outputs, with the arguments its wrapper passes;
    returns {kernel_id: elements written}."""
    import math
    import torch
    from repro_torch.check.grid_race import KERNEL_CASES
    from repro_torch.kernels.cross_entropy import ops as ce
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.swa_attention import ops as sa
    from repro_torch.kernels.weighted_agg import ops as wa
    from repro_torch.kernels.weighted_agg import ref as wa_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    written = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    kid = "weighted_agg.weighted_agg"
    n, dt, aligned = KERNEL_CASES[kid].args
    check(dt == torch.float32 and aligned, f"{kid}: case is f32, aligned")
    g, l = randn(n), randn(n)
    buf, out = guarded(n, dev)
    b, coef = wa_ref.agg_scalars(0.5, 0.8719)
    wa.KERNEL.launch("weighted_agg_f32", dev, out.data_ptr(), g.data_ptr(),
                     l.data_ptr(), n, b, coef, stream)
    (geo,) = KERNEL_CASES[kid].launches()
    written[kid] = check_written(kid, geo, "out", buf)

    kid = "weighted_agg.ring_agg"
    P, U, dt = KERNEL_CASES[kid].args
    g, locs, coeffs = randn(P), randn(U, P), randn(U, 2)
    buf, out = guarded(P, dev)
    wa.RING_KERNEL.launch("ring_agg_f32", dev, out.data_ptr(), g.data_ptr(),
                          locs.data_ptr(), coeffs.data_ptr(), P, U, stream)
    (geo,) = KERNEL_CASES[kid].launches()
    written[kid] = check_written(kid, geo, "out", buf)

    kid = "cross_entropy.nll_and_lse"
    R, V = KERNEL_CASES[kid].args
    logits = randn(R, V)
    labels = torch.randint(0, V, (R,), generator=gen, device=dev,
                           dtype=torch.int32)
    nll_buf, nll = guarded(R, dev)
    lse_buf, lse = guarded(R, dev)
    ce.KERNEL.launch("cross_entropy_f32", dev, logits.data_ptr(),
                     labels.data_ptr(), nll.data_ptr(), lse.data_ptr(), R,
                     V, stream)
    (geo,) = KERNEL_CASES[kid].launches()
    written[kid] = (check_written(kid, geo, "nll", nll_buf)
                    + check_written(kid, geo, "lse", lse_buf))

    kid = "decode_attention.decode_attention"
    B, S, H, Kv, hd = KERNEL_CASES[kid].args
    q, k, v = randn(B, H, hd), randn(B, S, Kv, hd), randn(B, S, Kv, hd)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)  # all live
    chunk, n_chunks = da.split(B, S, Kv)
    out_buf, out = guarded(B * H * hd, dev)
    part_buf, part = guarded(B * H * n_chunks * (hd + 2), dev)
    da.KERNEL.launch("decode_attention_f32", dev, out.data_ptr(),
                     part.data_ptr(), q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), pos.data_ptr(), B, S, H, Kv, hd, chunk,
                     n_chunks, 1.0 / math.sqrt(hd), stream)
    chunk_geo, combine_geo = KERNEL_CASES[kid].launches()
    written[kid] = (check_written(kid, chunk_geo, "part", part_buf)
                    + check_written(kid, combine_geo, "out", out_buf))

    kid = "swa_attention.swa_attention"
    B, S, H, Kv, hd = KERNEL_CASES[kid].args
    q, k, v = randn(B, S, H, hd), randn(B, S, Kv, hd), randn(B, S, Kv, hd)
    buf, out = guarded(B * S * H * hd, dev)
    sa.KERNEL.launch("swa_attention_f32", dev, out.data_ptr(), q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), B, S, H, Kv, hd, S,
                     1.0 / math.sqrt(hd), stream)
    (geo,) = KERNEL_CASES[kid].launches()
    written[kid] = check_written(kid, geo, "out", buf)
    return written


def lost_updates(dev, R, U, br, runs):
    """F1 on all-ones ``x [R, U]``: every tile adds ``br`` to its column, so
    ``R // br - out[u] / br`` updates of column u were lost.  The total
    per launch, for ``runs`` launches."""
    import torch
    from repro_torch.check.corpus import racy_kernel
    x = torch.ones(R, U, device=dev)
    lost = []
    for _ in range(runs):
        out = racy_kernel.racy_sum(x, block_rows=br)
        kept = (out / br).round().long().sum().item()
        lost.append(int(U * (R // br) - kept))
    return lost


def phase_check(dev):
    """The analyzer entry point on this card and its kernels: the strict
    CLI run with every probe, each kernel's Python launch geometry against
    its ``.cu`` export and against what a launch writes, and F1 (the racy
    fixture): exact at one row tile, lost updates reported, timed."""
    import torch
    from repro_torch.check import grid_race
    from repro_torch.check.corpus import racy_kernel

    launched_before = racy_kernel.KERNEL.launches
    t0 = time.perf_counter()
    rc, report = run_analyzer()
    wall = time.perf_counter() - t0
    live = [f for f in report["findings"] if not f["waived"]]
    check(rc == 0 and not live,
          f"check: analyzer exit {rc}, live findings {live}")
    verdicts = {k["kernel_id"]: k["classification"]
                for k in report["kernels"]}
    check(set(verdicts) == set(grid_race.KERNEL_CASES)
          and set(verdicts.values()) == {"parallel-safe"},
          f"check: kernel verdicts {verdicts}")
    log(f"check: python -m repro_torch.check src/repro_torch --strict: exit "
        f"{rc}, {len(report['findings'])} findings (all waived), every "
        f"production kernel parallel-safe ({len(verdicts)}); timings_s "
        f"{report['timings_s']}; {wall:.3f} s in all")

    n_grids = 0
    for kid, case in grid_race.KERNEL_CASES.items():
        shapes = [("case", case.args)] + grid_race.main_path_shapes()[kid]
        for label, args in shapes:
            want = [g.dim3 for g in case.launches(*args)]
            got = case.grids(*args)
            check(got == want, f"check: {kid} at {label}: .cu geometry "
                  f"export {got}, python geometry {want}")
            n_grids += 1
    for args in ((8, 2, 2), (2, 2, 2), F1_LARGE):
        want = [g.dim3 for g in racy_kernel.geometry(*args)]
        got = racy_kernel.cu_grids(*args)
        check(got == want, f"check: racy_sum at {args}: export {got}, "
              f"python {want}")
        n_grids += 1
    log(f"check: python grids equal the .cu geometry exports in {n_grids} "
        f"shapes (every case and main-path shape, F1 at 3)")

    written = nan_launches(dev)
    log(f"check: launched into NaN-filled outputs at the case shapes, every "
        f"kernel wrote exactly its declared ranges and nothing past them: "
        f"{written} elements")

    # F1 at one row tile: one block per column, exact on integer values
    max_err = 0.0
    gen = np.random.default_rng(0)
    for R, U in ((8, 2), (4096, 2), (1024, 7)):
        x = torch.from_numpy(gen.integers(-100, 100, (R, U)).astype(
            np.float32)).to(dev)
        got = racy_kernel.racy_sum(x, block_rows=R)
        want = racy_kernel.plain_sum(x, block_rows=R)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"racy_sum at one row tile R={R} "
              f"U={U} differs from its plain version: {got} vs {want}")
        max_err = max(max_err, (got - want).abs().max().item())
    rep = grid_race.analyze_callable("fixtures.racy_sum", "racy_sum",
                                     racy_kernel.invoke)
    check(rep.classification == "racy" and rep.revisit_axes == (0,),
          f"check: F1 classified {rep}")
    small = lost_updates(dev, 8, 2, 2, F1_LOST_RUNS)
    large = lost_updates(dev, *F1_LARGE, F1_LOST_RUNS)
    log(f"check: racy_sum equals its plain version at one row tile (grid "
        f"(1, U), 3 shapes); classified {rep.classification} on grid "
        f"{rep.grid}, revisit axes {rep.revisit_axes}; lost updates per "
        f"launch (not asserted: undefined) at grid (4, 2): {small} of 8, "
        f"at grid ({F1_LARGE[0] // F1_LARGE[2]}, {F1_LARGE[1]}): {large} of "
        f"{F1_LARGE[0] // F1_LARGE[2] * F1_LARGE[1]}")

    R, U, br = F1_LARGE
    x = torch.ones(R, U, device=dev)
    runs = {"kernel": lambda: racy_kernel.racy_sum(x, block_rows=br),
            "plain": lambda: racy_kernel.plain_sum(x, block_rows=br),
            "library": lambda: x.sum(0)}
    ms, samples = in_turns(runs)
    bytes_moved = 4 * R * U + 4 * U          # read x, write out
    flops = R * U
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / FP32_FLOP_PER_S * 1e3
    log(f"check: racy_sum at R={R} U={U} block rows {br} ({bytes_moved} "
        f"bytes): kernel {ms['kernel']:.6f} ms (the wrapper: zeroing the "
        f"output and the launch), plain {ms['plain']:.6f} ms, x.sum(0) "
        f"{ms['library']:.6f} ms, bound {max(bound_bytes, bound_ops):.6f} "
        f"ms; samples {samples}")
    return {
        "name": "racy_sum", "route": "cuda",
        "source": "src/repro_torch/check/corpus/racy_sum.cu",
        "replaces": "src/repro/check/fixtures/racy_kernel.py:25",
        "max_abs_err": max_err, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": ms["library"], "shape": f"R {R} U {U} br {br}",
        "launches_by_path": {
            "phase_check": racy_kernel.KERNEL.launches - launched_before},
        "lost_updates": {"grid (4, 2)": small,
                         f"grid ({R // br}, {U})": large},
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.check.corpus import racy_kernel
        from repro_torch.kernels.build import CSRC, build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    libs = build(sorted(p.name for p in CSRC.glob("*.cu"))
                 + [str(racy_kernel.SOURCE)])
    built = ", ".join(f"{Path(s).name} -> {p.relative_to(ROOT)}"
                      for s, p in libs.items())
    log(f"build: {built} in {time.perf_counter() - t0:.3f} s")
    log(card_line())

    k2 = phase_kernels(dev)
    k1 = phase_ring_kernel(dev)
    k4 = phase_decode_kernel(dev)
    k5 = phase_swa_kernel(dev)
    k3 = phase_ce_kernel(dev)
    f1_before = racy_kernel.KERNEL.launches
    host_merges = phase_main()
    k1["launches"] = phase_fleet()
    k4["launches"], k5["launches"] = phase_serve(dev)
    k3["launches"], train_merges = phase_train(dev)
    # F1 is a fixture: no main path launches it
    f1_main = racy_kernel.KERNEL.launches - f1_before
    check(f1_main == 0,
          f"racy_sum launched {f1_main} times on the main paths")
    # K2 runs on two main paths: the host engines' merges and training's
    k2["launches"] = host_merges + train_merges
    k2["launches_by_path"] = {"host engines": host_merges,
                              "training": train_merges}
    phase_train_step(dev)
    phase_host("serial")
    phase_host("jit")
    phase_serve_vs_cpu(dev)
    phase_train_vs_cpu(dev)
    # after every host-clock timing of the main paths (its host-side probe
    # runs the CPU fleet engine), before the profiler readings
    f1 = phase_check(dev)
    f1["launches"] = f1_main
    f1["launches_by_path"]["main paths"] = f1_main
    before = launch_us(dev)
    for measure in PROFILED:            # every profiler reading, last
        measure()
    log(f"launch cost: {before:.3f} us per tiny launch before the profiler "
        f"readings, {launch_us(dev):.3f} us after them")
    for rec in (k1, k4, k5, k3):        # the main shape's device time
        rec["device_ms"] = rec["geometries"][rec["shape"]]["device_ms"]

    log(json.dumps({"kernels": [k2, k1, k4, k5, k3, f1]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
