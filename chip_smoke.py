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
   shape alone and as whole merges: the CNN's leaves, a mixed f32/bf16
   tree with misaligned and empty leaves, smollm-360m's 290 leaves, with
   one launch per 112 leaves of a dtype; ``ring_agg`` at U in {0, 1, 2, 7,
   9, 10, 30, 60}, f32 and bf16 uploads, P = 422,016, 128*300, 128*1031
   (a pack count the 132-multiple grid does not divide) and 128 (blocks
   with no pack), with -0.0 and a (1, 0) step; with a world axis at P =
   422,016, U = 10, W = 5 and 15, the upload rows a view of a [W, 40, P]
   buffer, bitwise the plain version and W one-world launches), and time
   kernel, plain version and one library call against the card's bound (a
   CNN merge and a smollm-360m merge for ``weighted_agg``, against
   ``torch._foreach_lerp``; ``ring_agg`` also by the wrapper's host time
   per call, and with a world axis beside W one-world launches and one
   ``torch.baddbmm``).
3. host-engine path: ``run_scenario`` on paper-k10 (serial and batched, 40
   rounds) and fleet-k100 (batched, 120 rounds) with ``use_kernel=True``;
   every merge is ``weighted_agg`` (one launch per merge: the CNN's 8
   leaves in one table).
4. fleet-engine path: ``run_scenario(engine="jit")`` on fleet-k1000 (30
   rounds, f32 ring), fleet-k10000 (60 rounds, bf16 ring) and
   platoon-burst-k500 (40 rounds); every merge is a ``ring_agg`` chain, one
   launch per chain of the plan, and ``weighted_agg`` launches none; each
   world's host set-up (world building, plan) is then timed alone.
   Launch counts are zeroed before and read after each timed run of 3-4.
5. card against host: paper-k10 for 8 rounds on the card and on the CPU
   from one numpy-made init, on the serial and on the fleet engine.
6. corridor path: ``weighted_agg`` on the EMA reconcile's ``[R, P]``
   stack (R = 2, 4, 8, P = 422,016) bitwise its plain version, one launch
   each; ``run_scenario(engine="corridor")`` on corridor-quick-r2-k8 (8
   rounds), highway-k40-handover (80), corridor-r4-k400,
   corridor-r8-k4000 and corridor-rush-hour-r8-k4000 (40 each): every
   merge a ``ring_agg`` chain on one RSU's cohort row, one launch per
   chunk of the plan, and no ``weighted_agg`` under FedAvg; each world's
   set-up (world building, plan) timed alone; corridor-r4-k400 with the
   EMA reconcile (tau 0.3): one ``weighted_agg`` launch per reconcile;
   the serial handover loop (``engine="serial"``) on corridor-quick-r2-k8
   (8 rounds) and highway-k40-handover (80): one ``weighted_agg`` launch
   per arrival.  After phase 5: corridor-quick-r2-k8 for 8 rounds on the
   card and on the CPU from one numpy-made init, on both engines: the
   same (round, vehicle, rsu) trace, times, params and accuracy within
   phase 5's bands.
6b. selection path (after phase 6): fleet-k1000-topk and
   fleet-k1000-budget on ``engine="jit"`` (30 rounds each): ``ring_agg``
   launches = the selection plan's chains, ``weighted_agg`` none, every
   popped vehicle admitted when it downloaded, ``report.selection`` =
   a host re-plan's summary, fleet-k1000-topk profiled; fleet-k1000-topk
   on ``batched``: one ``weighted_agg`` launch per merge;
   corridor-r4-k400-bandit on ``engine="corridor"`` (40 rounds):
   ``ring_agg`` = ``chain_launches`` of its plan, the bandit guard
   passing; on the serial handover loop: one ``weighted_agg`` launch per
   arrival; selection with the EMA reconcile raises ``ValueError``.
   After the corridor's card-vs-CPU check: paper-k10 with weighted-topk k
   5 (8 rounds, serial and jit) and corridor-quick-r2-k8 with eps-bandit
   k 2, eps 0.4 (12 rounds, both corridor engines) on the card and on the
   CPU from one numpy-made init: equal ``report.selection``, the same
   traces, times and params within phase 5's bands.
6c. fault path (after phase 6b): fleet-k1000-flaky and
   fleet-k1000-throttled (30 rounds each) on ``engine="jit"``: ``ring_agg``
   launches = the fault plan's chains (a cap-discarded pop stays in its
   chain as a (1, 0) step), ``weighted_agg`` none, fleet-k1000-flaky
   profiled; both on ``batched``: one ``weighted_agg`` launch per kept
   merge; corridor-rush-hour-deadzone-r8-k4000 (40 rounds) on
   ``engine="corridor"``: ``ring_agg`` = ``chain_launches`` of its plan,
   set-up timed alone; every ``extras["faults"]`` equal to a host
   replay's summary; deadzone with the EMA reconcile raises
   ``ValueError``.  After the selection's card-vs-CPU check: paper-k10
   with throttled (10 rounds, serial and jit: partial cycles on the card)
   and corridor-quick-r2-k8 with repro's HEAVY spec (24 rounds of 2 local
   steps, both corridor engines), card against CPU from one numpy-made
   init: equal ``extras["faults"]``, the same traces, times and params
   within phase 5's bands.
6d. telemetry (after the card-vs-CPU checks of 5-6c): ``metrics="on"``
   against no metrics, in turns (off, on, on, off), on fleet-k1000 (30
   rounds), fleet-k10000 (60, bf16 ring: the ring guard counts no
   non-finite row) and fleet-k1000-flaky (30: the fault counters) on
   ``engine="jit"``, and corridor-r8-k4000 and corridor-r4-k400-bandit (40
   each: per-RSU channels, the bandit's reward accumulators) on the
   corridor engine: K1/K2 launches equal on and off, the same trace,
   params within 1e-6, every channel equal to the port's own f64 replay
   (the pop wait within rtol 1e-4 / atol 1e-3), the report's device
   memory keys present; ms/round on and off printed, with one rendered run
   log line; a profiler reading of the extra launches per pop on
   fleet-k1000 is queued.
6e. sweep (after phase 6d): ``run_sweep`` (``engine="vmap"``) at
   registered sizes: the Fig. 5 grid (paper-k10, betas 0.1-0.9 x seeds
   0-2: W 15 in 3 shared-timeline groups, 40 rounds), fleet-k1000 at
   seeds 0-2 (W 3 singleton groups, 30 rounds) and fleet-k1000 admit-all
   beside weighted-topk k 250 (30 rounds): ``ring_agg`` launches = the
   union plan's chains (one launch for all W worlds), ``weighted_agg``
   none, every world's pop order and times bitwise its solo ``jit`` run on
   the card, params and accuracy bitwise for a singleton group, params
   within atol 1e-2 for a shared one (``SWEEP_GROUP_ATOL``); accuracy, ms
   per world-round beside the solo runs' ms/round, set-up seconds and the
   device peak printed.  Then
   quick-k5, 2 betas x 2 seeds (8 rounds) as one batch on the card and on
   the CPU from one numpy-made init per seed, within phase 5's bands.
6f. pytree programs (after phase 6e, ``flat=False``): K2's device form
   (its scalars one-element f32 tensors on the card) bitwise its plain
   version and its host-float form on CNN and smollm-360m merges, a CNN
   merge timed against the host-float form; then fleet-k1000 (30 rounds;
   again under ``use_kernel``), fleet-k10000 (60, f32), platoon-burst-k500
   (40), fleet-k1000-flaky and fleet-k1000-topk (30) on ``jit``, and
   corridor-r4-k400 (40, EMA tau 0.3, ``use_kernel``),
   highway-k40-handover (80), corridor-rush-hour-deadzone-r8-k4000 (40),
   corridor-r4-k400-bandit (40, metrics on) and corridor-quick-r2-k8 (8,
   ``record_cohorts``) on ``corridor``, each flat and pytree: the same
   trace bit for bit, summaries and channels equal, params bitwise
   without the kernel and within ``PYTREE_KERNEL_ATOL`` with it,
   ``weighted_agg`` launches = pops + EMA reconciles under ``use_kernel``
   (else none), ``ring_agg`` none; ms/round beside the flat run's.  Then
   paper-k10 (``jit``) and corridor-quick-r2-k8 (``corridor``),
   ``flat=False``, 8 rounds, card against CPU within phase 5's bands.
6g. mesh (``phase_mesh``, after phase 6f's card-vs-CPU check): the
   simulator over ranks of a ``launch/mesh.py`` mesh.  World size 1 over
   NCCL in this process: fleet-k1000 (30 rounds, flat, ``jit``) with
   ``make_host_mesh()`` and with a ``("data",)`` mesh of 1, bitwise the
   unsharded card run (trace, times, params, accuracy), ``ring_agg``
   launches = the plan's chains.  World size 2 over gloo, two spawned
   ranks on this one card (``all_reduce`` and ``broadcast`` of card
   tensors checked first): fleet-k1000 with its waves over ``"data"``,
   corridor-r4-k400 (40 rounds, EMA tau 0.3, ``flat=False``,
   ``use_kernel``) and corridor-quick-r2-k8 (8 rounds) with their cohorts
   over ``"rsu"``, each against its unsharded card run: the (round,
   vehicle, rsu) trace exact, times in phase 4's f32 band, params within
   ``MESH_PARAM_ATOL`` (1e-5, ``repro``'s bar for its sharded corridor),
   launches on every rank = the plan's (K1 the fleet plan's chains; K2 the
   pops on the rank's cohorts plus the EMA reconciles); ms/round beside
   the unsharded run's, with the host time in ``all_reduce``; then
   ``cross_pod_reconcile`` over a (2,) ``"pod"`` mesh at tau 1 and 0.5
   under ``use_kernel`` within 1e-6 of the plain f32 reconcile (K2 once
   at tau 0.5 on each rank).
7. attention kernels: ``decode_attention`` (K4) at G in {1, 3, 4, 5, 8, 16},
   hd in {64, 128} (f32 and bf16), pos = 0, 63, 64, 65 (the kv tile's
   edges), S - 1 and a mixed per-row vector, and
   ``swa_attention`` (K5) at window = S, windows under S, a window that is
   not a multiple of the 64-row tile and S not a multiple of it, G in
   {1, 3} (f32) and {1, 3, 5} at hd 64 and 128 (bf16, the tensor-core
   kernel); each held to its plain version (2e-5 in f32, 3e-2 in bf16);
   then kernel, plain version and ``scaled_dot_product_attention`` timed
   at the serve path's shapes and at smollm-360m's decode_32k and 512- /
   1024-token prefill geometries.
8. serve path: full-width smollm-360m (32 layers, f32, the port's torch
   init) behind a ``BatchedServer`` of 8 slots and max_seq 2048 serves 16
   requests (numpy prompts of 64-1024 tokens, 64 new tokens each);
   ``decode_attention`` launches 32 per tick and ``swa_attention`` 32 per
   admitted request; a second run under torch.profiler gives the
   kernels' device times.
8b. dense archs (after phase 8): mistral-nemo-12b's
   ``sliding_window_variant()`` (window 4096) at full width (40 layers,
   d_model 5120, 32/8 heads, vocab 131,072) with bf16 weights and caches
   through ``launch/serve.py:generate`` (scalar positions), B 2 and 64 new
   tokens after prompts of 1024 (the ring padded), 4064 (the ring wraps
   during decode) and 8192 tokens (K5 with window 4096 < S): K5 40 per
   prefill, K4 40 per step; qwen1.5-4b (QKV biases, G 1) and
   musicgen-large (the audio stub's codes, hd 64) in f32 behind phase 8's
   ``BatchedServer`` (16 and 8 requests; K5 = layers x admits, K4 =
   layers x ticks); internvl2-2b in f32 through ``generate`` with the
   vision stub's 256 patch embeddings before 512 text tokens, B 4, 32 new;
   each model freed before the next, its peak memory printed.  Then K5
   against its plain version at mistral's heads (B 1, S 4608, window 4096
   and through the chunk reshape, f32 and bf16) and K4 over a ring of
   4096 at G 1, 2, 4 before, at and past the wrap, against its plain
   version and ``repro``'s ring mask (2e-5 / 3e-2); card against CPU on
   the reduced configs of the five archs, the swa variant (window 64) and
   a ``[chunk 64, global]`` variant (80-token prompts, 16 teacher-forced
   steps, within phase 9's band); and K5 at mistral's prefill (B 2, S
   8192, bf16) at window 4096 and window S, K4 over its ring (B 2, W
   4096), each beside its plain version and SDPA.
8b. MoE + MLA and the training side (``phase_moe``), each model freed
   before the next: deepseek-v2-lite-16b at full size in bf16 (31.5 GB)
   through ``generate`` (B 2, prompts of 1,024, 64 new) with naive and
   then absorbed MLA decode (their logits over ``ARCH_BF16_TOL``'s bar
   logged), the two forms' ``mla_decode`` in bf16 on identical inputs at
   each of the 27 MLA layers (against the naive form in f32 and each
   other, each output row's rms error held to the bar's ``row_rms``, a
   step one position late planted) and behind phase 7's ``BatchedServer``
   and requests (MLA: no K4/K5 launch); K5 and K4 against their plain
   versions at llama4-scout-17b-a16e's shapes (G 5, hd 128, bf16: K5
   through the chunk reshape of 10,240 tokens into 2 rows of 8,192 and
   over the global layer's prompt, K4 over the chunk ring of 8,192 and
   the full cache of 10,272, under ``ARCH_BF16_TOL`` with planted
   errors), then scout at full width over one period of
   4 layers (10.9 B parameters; the whole model is 215.5 GB of bf16)
   through ``generate`` (B 1, a 10,240-token prompt, 32 new: K5 once a
   layer, K4 once a layer a step, G 5); ``make_train_step`` on the 5-layer
   deepseek in f32 (B 4, S 512) under ``full``, ``dots``, ``dots_nb``,
   ``remat_sublayer`` and ``no_remat`` (K3 once a step, the losses within
   1e-5 of each other, the memory each keeps for the backward logged) and
   the two MLA decode forms held to each other under ``ARCH_BF16_TOL`` in
   f32; ``repro_torch.optim`` (adam under ``linear_warmup_cosine``,
   momentum SGD, ``clip_by_global_norm``) on smollm-360m's param dict,
   card against CPU; card against CPU on reduced deepseek (both decode
   forms) and scout, logits within 1e-5.
8c. SSM layers (``phase_ssm``, after ``phase_moe``), each model freed
   before the next: rwkv6-1.6b whole in bf16 (24 layers, 3.2 GB) through
   ``generate`` (B 2, prompts of 1,024, 64 new) and behind phase 7's
   ``BatchedServer`` (its first 8 requests, 32 new): no K4/K5 launch; K5
   and K4 against their plain versions at jamba-v0.1-52b's attention
   shapes (G 4, hd 128, bf16, ``ARCH_BF16_TOL``, planted errors); jamba
   at full width over one period of 8 layers (13.3 B parameters; the
   whole model is 103 GB of bf16) through ``generate`` (B 2, prompts of
   1,024, 32 new: K5 once, K4 once a step); ``make_train_step`` on rwkv6
   cut to 4 layers in f32 (B 2, S 256) under ``full`` and ``no_remat``
   (K3 once a step, losses equal, memory kept for the backward logged);
   card against CPU on the reduced configs (prefill and decode logits
   within ``SSM_LOGIT_TOL``, every state leaf, one train step's params).
   One decode tick of each model and two rwkv6 prefills are profiled
   with the other profiler readings: launches per tick and per token.
8d. llama3-405b (``phase_llama3``, after ``phase_ssm``): at full width
   over 4 of its 126 layers in bf16 (34 GB; 128 query heads over 8 kv
   heads, G 16): each layer's K5 and K4 on its own q, k, v of the prompt
   against the plain versions in f32 under ``ARCH_BF16_TOL`` (planted:
   half the window, half the position), then ``generate`` at B 2 x 1,024
   prompt tokens, 32 new (K5 once a layer, K4 once a layer a tick): ms
   per prefill and per tick against the tick's weight-read bound, tokens/s
   and peak memory; K4 timed at its decode shape (B 2, 1,056 slots) beside
   its plain version and SDPA with ``enable_gqa``.
9. serve, card against host: the same config cut to 4 layers, one CPU
   init, two of the prompts: prefill and 16 teacher-forced decode steps on
   both, logits within atol 1e-3 / rtol 1e-3.
10. cross-entropy kernel: ``cross_entropy`` (K3) at R in {1, 7, 512, 4096}
   and V in {512, 1111, 49152, 65536, 131072}, f32 and bf16, labels at 0,
   V - 1 and random, plus rows of +-1e4 logits: (nll, lse) within 1e-4
   (f32) / 3e-2 (bf16) / 1e-3 (+-1e4 rows) of the plain version, and the
   backward's d logits within 1e-6 of plain autograd (rwkv6's training
   shape, R 512 V 65,536, among them); then kernel, plain
   version and ``F.cross_entropy`` timed at the training path's shapes.
11. training path: ``launch/train.py``'s MAFL loop on full-width
    smollm-360m (the port's torch init, f32) with ``--use-kernel`` and the
    defaults (batch 8, seq-len 64, 4 local steps, lr 0.05) for 10 rounds;
    ``cross_entropy`` launches once per local step and held-out eval,
    ``weighted_agg`` 3 times per merge (290 leaves, 112 a launch); every
    printed loss finite; a 3-round run under torch.profiler gives the
    kernels' device times.
12. train step: ``make_train_step`` at full width, B 8, S 512 (4096 rows
    into K3): one warm-up and 5 timed steps.
12b. sharded train step (``phase_shard_train``): reduced
    deepseek-v2-lite-16b on a one-rank NCCL ``("data", "model")`` mesh of
    DTensor parameters (``shard_activations``, ``grad_specs``, FSDP
    forced on, 2 microbatches, 2 steps): params within 1e-6 of the
    unsharded step's, every parameter on its spec's placements, K3 once a
    microbatch on the rank's rows.
13. training, card against host: the same config cut to 4 layers, one CPU
    init, 2 rounds of 2 local steps on both: the same vehicles, losses
    within rtol 1e-4, final params within atol 1e-4 / rtol 1e-3.
14. check (after phase 13, before the profiler readings): the analyzer entry
    point ``python -m repro_torch.check src/repro_torch --strict
    --format=json`` in this process, every probe included: exit 0, no live
    finding, every production kernel parallel-safe.  Each kernel's Python
    launch geometry (``ops.geometry``) against its ``.cu``'s
    ``<name>_geometry`` export at its registered case and at every
    main-path shape; each kernel launched at its case shape into
    NaN-filled, guarded outputs writes exactly its declared ranges (K4 in
    f32 and bf16 at pos = 0, S - 1 and a mixed vector).  F1
    (``check/corpus/racy_sum.cu``, built with the others): equal to its
    plain version at one row tile (grid (1, U), integer-valued inputs);
    its lost updates at the analyzer's grid (4, 2) and at grid (4096, 2)
    printed, not asserted; timed against its plain version and
    ``x.sum(0)``; launched 0 times on the main paths.

Every torch.profiler reading (kernels' device times on the main paths) is
taken last, after all host-clock and CUDA-event timings:
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
# ring_agg: chain lengths and buffer sizes checked bitwise (the paper CNN's
# P, a P ragged against any power-of-two tile, a pack count the grid of 132
# multiples does not divide, and fewer packs than blocks), and the timed
# chain
RING_U = (0, 1, 2, 7, 9, 10, 30, 60)
RING_P = (422016, 128 * 300, 128 * 1031, 128)
RING_TIMED_U = 10
# ring_agg with a world axis: the sweep's batches (W 15: the Fig. 5 grid;
# W 5: one seed's betas), locs a view of a [W, 40, P] upload buffer
RING_WORLDS = (5, 15)
RING_WORLD_ROWS = 40
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


START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def mark(label):
    """Log how far into the run a phase ended: the script's time budget."""
    log(f"time: {label} ended {time.perf_counter() - START:.1f} s into the "
        f"run")


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
    """Wall time of one call of ``fn`` from CUDA events over ``iters``
    back-to-back calls: the device's time where the host issues faster
    than the device runs, the host's issue time where it does not.  Every
    kernel timing passes a ``rotating`` call, so the inputs are not in L2
    between calls."""
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
    from torch.profiler's CUDA activity (None if it records none), and the
    number of those kernels' events the profiler recorded."""
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
    rows = [e for e in prof.key_averages()
            if any(n in e.key for n in kernel_names)]
    us = sum(e.device_time_total for e in rows)
    return (us / iters / 1e3 if us > 0 else None), sum(e.count for e in rows)


def profile_call(label, fn):
    """``fn()`` under torch.profiler: the kernels that take the most device
    time.  Returns (the device ms, the kernel launches recorded), (None, 0)
    if the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    launched = sum(r[1] for r in rows)
    if not rows:
        log(f"profile: {label}: no device activity recorded")
        return None, 0
    log(f"profile: {label}: device kernels {dev_ms:.3f} ms in {launched} "
        f"launches; top kernels by device time:")
    for t, n, key in rows[:10]:
        log(f"profile:   {t:10.3f} ms {n:7d} x  {key[:90]}")
    return dev_ms, launched


def profile_run(name, engine, rounds):
    """One main-path run of the simulator under torch.profiler (queued)."""
    from repro_torch.core.scenarios import run_scenario
    profile_later(f"{name}/{engine} {rounds} rounds",
                  lambda: run_scenario(name, engine=engine, use_kernel=True,
                                       device=DEVICE, rounds=rounds))


# A finished torch.profiler trace leaves the card's launch path slower for
# the rest of the process (on an H100 80GB HBM3 at 700 W, ``launch_us``
# read 10.2 us per tiny launch before the queue below and 16.9 us after
# it).  So every profiler reading is queued here and taken after all
# host-clock and CUDA-event timings of the run.
PROFILED = []


def host_ms_per_call(fn, n=2000):
    """Host time of one call of ``fn`` (ms): ``n`` back-to-back calls on
    the host clock, no synchronisation inside the loop, so where the
    device keeps up this is what one call costs the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return host


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


def profile_later(label, fn):
    PROFILED.append(lambda: profile_call(label, fn))


def device_time_later(label, row, fn, kernel_names, iters=50,
                      per_event=False):
    """Queue the profiler's device time per call of ``fn``'s kernels: it
    is logged and stored in ``row["device_ms"]`` when the queue runs.
    ``per_event`` (for a call of one launch): the time per recorded
    kernel event, which stays a reading when the profiler keeps fewer
    events than calls."""
    row["device_ms"] = None

    def measure():
        busy, events = device_ms_per_call(fn, kernel_names, iters)
        if per_event and busy is not None:
            busy = busy * iters / events
        row["device_ms"] = busy
        log(f"device time: {label}: "
            f"{'not measured' if busy is None else f'{busy:.6f} ms'} per "
            f"{'recorded launch' if per_event else 'call'} (torch.profiler; "
            f"{events} kernel events recorded for {iters} calls)")
    PROFILED.append(measure)


def bits(t):
    import torch
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def check_merge(label, ops, ref, g, l, b, w, inputs_before=None):
    """One merge through ``weighted_agg_tree``: every leaf bitwise its plain
    version, contiguous, of its input's shape and dtype; launches one per
    ``MAX_LEAVES`` non-empty leaves of a dtype; the inputs unchanged."""
    import torch
    from repro_torch import kernels
    kernels.reset_launches()
    out = ops.weighted_agg_tree(g, l, b, w)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()["weighted_agg"]
    dtypes = {v.dtype for v in g.values()}
    want_launches = sum(ops.launches(sum(1 for v in g.values()
                                         if v.dtype == dt and v.numel()))
                        for dt in dtypes)
    check(launched == want_launches, f"weighted_agg {label}: {launched} "
          f"launches, expected {want_launches}")
    check(list(out) == list(g), f"weighted_agg {label}: keys")
    for k, v in out.items():
        check(v.shape == g[k].shape and v.dtype == g[k].dtype
              and v.is_contiguous(), f"weighted_agg {label}: leaf {k}")
        check(torch.equal(bits(v), bits(ref.weighted_agg(g[k], l[k], b, w))),
              f"weighted_agg {label}: leaf {k} differs from its plain "
              f"version")
    if inputs_before is not None:
        check(all(torch.equal(bits(g[k]), bits(gb))
                  and torch.equal(bits(l[k]), bits(lb))
                  for k, (gb, lb) in inputs_before.items()),
              f"weighted_agg {label}: an input was written")
    return launched


def merge_timings(label, runs, n_params, iters, warmup, reps):
    """kernel / plain / library (and any extra yardstick) in turns; the
    bound is the merge's bytes: read g and l, write out, 12 bytes per f32
    element."""
    ms, samples = in_turns(runs, reps, iters, warmup)
    bytes_moved = 3 * 4 * n_params
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = 3 * n_params / FP32_FLOP_PER_S * 1e3
    extra = "".join(f", {k} {v:.6f} ms" for k, v in ms.items()
                    if k not in ("kernel", "plain", "library"))
    log(f"kernels: {label} (P={n_params}, {bytes_moved} bytes): kernel "
        f"{ms['kernel']:.6f} ms, plain {ms['plain']:.6f} ms, "
        f"torch._foreach_lerp {ms['library']:.6f} ms{extra}, bound "
        f"{max(bound_bytes, bound_ops):.6f} ms (at 3.35 TB/s); samples "
        f"{samples}")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": ms["library"],
            **{f"{k}_ms": v for k, v in ms.items()
               if k not in ("kernel", "plain", "library")}}


def phase_kernels(dev):
    """K2 against its plain version, bitwise: one leaf (a table of one) at
    every CNN leaf shape plus a ragged length, a length under 128 and a
    misaligned view; whole merges of the CNN's leaves, of a mixed f32 /
    bf16 tree with misaligned and empty leaves, and of smollm-360m's 290
    leaves; then the timings of a CNN merge and a smollm-360m merge."""
    import torch
    from repro_torch.check.grid_race import smollm_leaf_shapes
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
        f"{cases} one-leaf cases (f32 and bf16; every CNN leaf shape, "
        f"n=12345, n=77, aligned and misaligned; mixing and literal "
        f"scalars); max_abs_err={max_err}")

    def tree(shape_of, dtype_of, off_of=lambda k: 0):
        return [{k: torch.randn(int(np.prod(s)) + off_of(k), generator=gen,
                                device=dev).to(dtype_of(k))[off_of(k):]
                 .view(s) for k, s in shape_of.items()} for _ in range(2)]
    mixed_shapes = {**CNN_SHAPES, "empty": (0,), "one": (1,),
                    "ragged": (12345,)}
    names = list(mixed_shapes)
    merges = {
        "CNN f32": tree(CNN_SHAPES, lambda k: torch.float32),
        "CNN bf16": tree(CNN_SHAPES, lambda k: torch.bfloat16),
        "mixed f32/bf16, misaligned and empty leaves": tree(
            mixed_shapes,
            lambda k: (torch.float32, torch.bfloat16)[names.index(k) % 2],
            lambda k: int(names.index(k) % 3 == 1)),
    }
    launched = {}
    for label, (g, l) in merges.items():
        for b, w in scalars:
            before = {k: (g[k].clone(), l[k].clone()) for k in g}
            launched[label] = check_merge(label, ops, ref, g, l, b, w,
                                          before)
    big = smollm_leaf_shapes()
    big_trees = tree(big, lambda k: torch.float32)
    launched["smollm-360m (290 leaves, f32)"] = check_merge(
        "smollm-360m", ops, ref, *big_trees, *scalars[0])
    log(f"kernels: weighted_agg_tree bitwise equal to its plain version, "
        f"inputs unchanged, launches per merge {launched}")

    # timings of one merge at the main paths' two shapes
    beta = 1.0 - 0.0734125
    geometries = {}
    for label, shape_of, iters, warmup, reps in (
            ("CNN merge (8 leaves, f32)", CNN_SHAPES, 100, 10, 6),
            ("smollm-360m merge (290 leaves, f32)", big, 5, 2, 4)):
        g, l = (big_trees if shape_of is big
                else tree(shape_of, lambda k: torch.float32))
        gl, ll = list(g.values()), list(l.values())
        runs = {
            "kernel": lambda g=g, l=l: ops.weighted_agg_tree(g, l, beta,
                                                             1.0),
            "plain": lambda g=g, l=l: {k: ref.weighted_agg(g[k], l[k], beta,
                                                           1.0) for k in g},
            "library": lambda gl=gl, ll=ll: torch._foreach_lerp(gl, ll,
                                                                 1.0 - beta),
        }
        if shape_of is CNN_SHAPES:       # the earlier records' yardstick
            runs["lerp_x8"] = lambda g=g, l=l: {
                k: torch.lerp(g[k], l[k], 1.0 - beta) for k in g}
        n_params = sum(int(np.prod(s)) for s in shape_of.values())
        geometries[label] = merge_timings(label, runs, n_params, iters,
                                          warmup, reps)
        device_time_later(f"weighted_agg {label}", geometries[label],
                          runs["kernel"], "weighted_agg_kernel", iters=10)
    main = "CNN merge (8 leaves, f32)"
    return {
        "name": "weighted_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg/kernel.py:48",
        "max_abs_err": max_err, **geometries[main],
        "shape": main, "geometries": geometries,
        "launches_per_merge": launched,
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
    from repro_torch.kernels.build import current_stream
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
        host = host_ms_per_call(runs["kernel"])
        # where the wrapper's host time goes; the rest is the pointers, the
        # ctypes call, the CUDA launch and the count
        g0, l0, c0 = sets[0]
        split = {"checks": host_ms_per_call(
                     lambda: ops._check_ring_inputs(g0, l0, c0)),
                 "output": host_ms_per_call(lambda: torch.empty_like(g0)),
                 "stream": host_ms_per_call(lambda: current_stream(dev))}
        split["rest"] = host - sum(split.values())
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = 3 * U * P / FP32_FLOP_PER_S * 1e3
        tag = "f32" if dtype == torch.float32 else "bf16"
        lib = (f"addmv {ms['library']:.6f} ms" if "library" in ms
               else "no library call (none mixes a bf16 matrix with an f32 "
               "vector into f32)")
        log(f"kernels: ring_agg U={U} P={P} {tag} uploads "
            f"({n_sets} input sets, {bytes_moved} bytes per chain): kernel "
            f"{ms['kernel']:.6f} ms (host {host:.6f} ms per call), plain "
            f"{ms['plain']:.6f} ms, {lib}")
        log(f"kernels:   host per call split (ms): {split}")
        log(f"kernels:   bound {max(bound_bytes, bound_ops):.6f} ms "
            f"(bytes {bound_bytes:.6f}, operations {bound_ops:.6f}); "
            f"samples {samples}")
        timings[tag] = {
            "ms": ms["kernel"], "host_ms": host, "host_split_ms": split,
            "plain_ms": ms["plain"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": ms.get("library")}
        device_time_later(f"ring_agg U={U} P={P} {tag} uploads per chain",
                          timings[tag], rotating(ops.ring_agg, sets),
                          "ring_agg_kernel")
        del sets, runs
    worlds, world_err = ring_world_cases(dev, gen)
    return {
        "name": "ring_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg/kernel.py:113",
        "max_abs_err": max(max_err, world_err), **timings["f32"],
        "shape": f"U={U} P={P} f32 uploads",
        "geometries": {**{f"U={U} P={P} {tag} uploads": row
                          for tag, row in timings.items()}, **worlds},
    }


def ring_world_cases(dev, gen):
    """K1 with a world axis (the sweep tier's chain): at P = 422,016, U =
    10 and W in ``RING_WORLDS``, f32 and bf16 uploads, ``locs`` the
    ``[:, a:a+U]`` view of a ``[W, 40, P]`` upload buffer (world stride
    40 P, as paper-k10's sweep passes it): one launch, bitwise the plain
    version and W one-world launches on the slices; then the launch, the
    plain version, W one-world launches and (f32) one ``torch.baddbmm`` on
    the prefix weights with the ``g`` term, timed in turns against the
    bound ``W (8 + U s) P`` bytes.  Returns ``({shape: row}, max
    |kernel - plain|)``."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.weighted_agg import ops, ref

    P, U, M, a = RING_P[0], RING_TIMED_U, RING_WORLD_ROWS, 10
    rows, max_err = {}, 0.0
    for dtype, s in ((torch.float32, 4), (torch.bfloat16, 2)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for W in RING_WORLDS:
            def inputs():
                g = torch.randn(W, P, generator=gen, device=dev)
                buf = torch.randn(W, M, P, generator=gen,
                                  device=dev).to(dtype)
                c = torch.rand(W, U, generator=gen, device=dev) * 0.5 + 0.5
                coeffs = torch.stack([c, 1.0 - c], dim=2).contiguous()
                return g, buf[:, a:a + U], coeffs
            bytes_moved = W * ((8 + U * s) * P + 8 * U)
            n_sets = int(np.ceil(2 * L2_BYTES / bytes_moved))
            sets = [inputs() for _ in range(n_sets)]
            g, locs, coeffs = sets[0]
            kernels.reset_launches()
            out = ops.ring_agg(g, locs, coeffs)
            launched = kernels.launch_counts()["ring_agg"]
            want = ref.ring_agg(g, locs, coeffs)
            ones = [ops.ring_agg(g[w], locs[w], coeffs[w]) for w in range(W)]
            torch.cuda.synchronize()
            label = f"U={U} P={P} W={W} {tag} uploads"
            check(launched == 1, f"ring_agg {label}: {launched} launches")
            check(torch.equal(bits(out), bits(want)),
                  f"ring_agg {label} differs from its plain version")
            check(all(torch.equal(bits(out[w]), bits(ones[w]))
                      for w in range(W)),
                  f"ring_agg {label} differs from {W} one-world launches")
            max_err = max(max_err, (out - want).abs().max().item())

            def separate(g, locs, coeffs, W=W):
                return [ops.ring_agg(g[w], locs[w], coeffs[w])
                        for w in range(W)]
            runs = {"kernel": rotating(ops.ring_agg, sets),
                    "plain": rotating(ref.ring_agg, sets),
                    "separate": rotating(separate, sets)}
            if dtype == torch.float32:
                # the yardstick: each world's closed form as one batched
                # gemv with the g term; the port never calls it
                lib_sets = []
                for g, locs, coeffs in sets:
                    wts = torch.tensor(np.stack(
                        [ops.prefix_weights(coeffs[w].cpu())
                         for w in range(W)]), dtype=torch.float32,
                        device=dev)
                    lib_sets.append((g, locs, wts[:, None, 1:].contiguous(),
                                     wts[:, :1].contiguous()))
                runs["library"] = rotating(
                    lambda g, l, w, w0: torch.baddbmm(
                        (w0 * g)[:, None, :], w, l)[:, 0], lib_sets)
                diff = (runs["library"]() - runs["kernel"]()).abs().max()
                check(diff.item() <= 1e-4,
                      f"baddbmm yardstick differs by {diff.item()}")
            samples = {k: [] for k in runs}
            for rep in range(6):                 # in turns, order alternating
                order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
                for name in order:
                    samples[name].append(time_ms(runs[name], iters=50,
                                                 warmup=5))
            ms = {k: float(np.median(v)) for k, v in samples.items()}
            # fewer calls than the launch queue holds: the host's own time
            host = host_ms_per_call(runs["kernel"], n=300)
            bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
            bound_ops = 3 * W * U * P / FP32_FLOP_PER_S * 1e3
            lib = (f"baddbmm {ms['library']:.6f} ms" if "library" in ms
                   else "no library call (none mixes bf16 rows with f32 "
                   "weights into f32)")
            log(f"kernels: ring_agg {label} (locs a [:, {a}:{a + U}] view "
                f"of [{W}, {M}, {P}]; {n_sets} input sets, {bytes_moved} "
                f"bytes per call): one launch bitwise its plain version and "
                f"{W} one-world launches; kernel {ms['kernel']:.6f} ms (host "
                f"{host:.6f} ms per call), {W} one-world launches "
                f"{ms['separate']:.6f} ms, plain {ms['plain']:.6f} ms, {lib}; "
                f"bound {max(bound_bytes, bound_ops):.6f} ms; samples "
                f"{samples}")
            rows[label] = {
                "ms": ms["kernel"], "host_ms": host,
                "separate_ms": ms["separate"], "plain_ms": ms["plain"],
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": ("bytes" if bound_bytes >= bound_ops
                             else "operations"),
                "library_ms": ms.get("library")}
            device_time_later(f"ring_agg {label} per call", rows[label],
                              rotating(ops.ring_agg, sets),
                              "ring_agg_kernel")
            del sets, runs, out, want, ones
    return rows, max_err


def run_main(name, engine, rounds):
    """One main-path run; returns (result, ms/round, launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.scenarios import run_scenario
    from repro_torch.kernels.weighted_agg import ops as agg_ops
    from repro_torch.models.cnn import CNN_SHAPES

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(name, engine=engine, use_kernel=True, device=DEVICE,
                       rounds=rounds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()["weighted_agg"]
    merges = len(res.rounds)
    # a cap-discarded arrival counts its round but merges nothing
    kept = (sum(res.extras["faults"]["keep"]) if "faults" in res.extras
            else merges)
    per_merge = agg_ops.launches(len(CNN_SHAPES))
    check(merges == rounds, f"{name}/{engine}: {merges} of {rounds} rounds")
    check(launches == per_merge * kept,
          f"{name}/{engine}: {launches} weighted_agg launches for {kept} "
          f"kept merges (expected {per_merge} per merge: the CNN's 8 leaves "
          f"in one table)")
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
        f"= {per_merge} x {kept} kept merges of {merges}")
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
    serial, _, n1 = run_main("paper-k10", "serial", PAPER_ROUNDS)
    batched, _, n2 = run_main("paper-k10", "batched", PAPER_ROUNDS)
    trace = [(r.round, r.vehicle, r.time) for r in serial.rounds]
    check(trace == [(r.round, r.vehicle, r.time) for r in batched.rounds],
          "paper-k10 serial and batched traces differ")
    diff = max((serial.final_params[k] - batched.final_params[k])
               .abs().max().item() for k in serial.final_params)
    log(f"main: paper-k10 serial and batched traces identical; final "
        f"params max |serial - batched| = {diff}")
    _, _, n3 = run_main("fleet-k100", "batched", FLEET_ROUNDS)
    profile_run("paper-k10", "serial", PAPER_ROUNDS)
    profile_run("fleet-k100", "batched", FLEET_ROUNDS)
    return n1 + n2 + n3


def expected_chains(name, rounds):
    """ring_agg launches of one run: the non-empty checkpoint intervals of
    the port's own plan and ``needed`` set."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.faults import scenario_faults
    sc = get_scenario(name)
    plan = jit_engine.plan_fleet(sc.channel(), 0, rounds,
                                 selection=sc.selection_spec(),
                                 faults=scenario_faults(sc),
                                 l_iters=sc.l_iters)
    need = jit_engine.needed_rounds(
        plan, jit_engine.eval_rounds_of(rounds, EVAL_EVERY))
    return sum(len(jit_engine.chain_bounds(s, e, need))
               for _, s, e in plan.waves)


def run_fleet(name, rounds):
    """One fleet-engine run; returns (result, ms/round, ring_agg
    launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import (build_world, get_scenario,
                                            run_scenario)
    from repro_torch.faults import scenario_faults

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
    sc = get_scenario(name)
    _, _, _, p = build_world(sc)
    t1 = time.perf_counter()
    jit_engine.plan_fleet(p, 0, rounds, selection=sc.selection_spec(),
                          faults=scenario_faults(sc), l_iters=sc.l_iters)
    t2 = time.perf_counter()
    log(f"fleet: {name} engine=jit rounds={rounds}: {ms_round:.3f} "
        f"ms/round ({dt:.3f} s), final accuracy {res.final_accuracy():.5f}, "
        f"ring_agg launches {counts['ring_agg']} = the plan's chains, "
        f"weighted_agg launches 0")
    log(f"fleet:   set-up timed alone: build_world {t1 - t0:.3f} s, "
        f"plan_fleet {t2 - t1:.3f} s; the rest of the run (staging, device "
        f"loop, evals) {dt - (t2 - t0):.3f} s")
    return res, ms_round, counts["ring_agg"]


def phase_fleet():
    from repro_torch.core.scenarios import run_scenario
    total = 0
    for name, rounds in JIT_RUNS:
        t0 = time.perf_counter()                 # warm-up, untimed
        run_scenario(name, engine="jit", use_kernel=True, device=DEVICE,
                     rounds=rounds, eval_every=EVAL_EVERY)
        log(f"fleet: {name} warm-up {time.perf_counter() - t0:.3f} s")
        _, _, n = run_fleet(name, rounds)
        total += n
    profile_run("fleet-k10000", "jit", 60)
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


def phase_host(engine, selection=None, faults=None, rounds=HOST_ROUNDS):
    """paper-k10 for ``rounds`` rounds on the card and on the CPU, same
    init (with a ``SelectionSpec``: the same ``report.selection`` too;
    with a fault profile, the same ``extras["faults"]``)."""
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core.mafl import run_simulation
    from repro_torch.core.scenarios import build_world, get_scenario

    sc = get_scenario("paper-k10")
    veh, te_i, te_l, p = build_world(sc)
    init = numpy_init()
    out = {}
    label = engine if selection is None else f"{engine} {selection.policy}"
    if faults is not None:
        label = f"{label} faults={faults}"
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        out[dev] = run_simulation(
            veh, te_i, te_l, scheme=sc.scheme, rounds=rounds,
            l_iters=sc.l_iters, lr=sc.lr, params=p, eval_every=2,
            use_kernel=True, init_params=params_from_jax(init, dev),
            engine=engine, selection=selection, faults=faults, device=dev)
        log(f"host: paper-k10 {label} {rounds} rounds on {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    gpu, cpu = out[DEVICE], out["cpu"]
    if faults is not None:
        counts = cpu.extras["faults"]["counts"]
        check(gpu.extras["faults"] == cpu.extras["faults"],
              f"{label}: card and CPU fault summaries differ")
        log(f"host: {label}: card and CPU fault summaries equal: {counts}")
    if selection is not None:
        admit0 = cpu.report.selection["admit0"]
        check(gpu.report.selection == cpu.report.selection,
              f"{label}: card and CPU selection summaries differ")
        check(not all(admit0) and {r.vehicle for r in cpu.rounds}
              <= {v for v, a in enumerate(admit0) if a},
              f"{label}: a parked vehicle arrived ({admit0})")
    check([(r.round, r.vehicle) for r in gpu.rounds]
          == [(r.round, r.vehicle) for r in cpu.rounds],
          f"{label}: card and CPU (round, vehicle) traces differ")
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
              f"{label}: card vs CPU final {k}: max |diff| {err}")
    acc_diff = max(abs(a - b) for (_, a), (_, b)
                   in zip(gpu.acc_history, cpu.acc_history))
    check(acc_diff <= ACC_TOL,
          f"{label}: card vs CPU accuracy differs by {acc_diff}")
    log(f"host: {label}: card and CPU traces identical ((round, vehicle); "
        f"event times max |diff| {float(np.abs(tg - tc).max())}); final "
        f"params max |diff| {worst} (atol {HOST_ATOL}, rtol {HOST_RTOL}); "
        f"accuracy max |diff| {acc_diff}")


# the corridor engine's worlds at their registered rounds, eval every 10
CORRIDOR_RUNS = (("corridor-quick-r2-k8", 8), ("highway-k40-handover", 80),
                 ("corridor-r4-k400", 40), ("corridor-r8-k4000", 40),
                 ("corridor-rush-hour-r8-k4000", 40))
# the EMA cloud tier, through weighted_agg on the [R, P] stack
CORRIDOR_EMA = ("corridor-r4-k400", 40,
                dict(reconcile_mode="ema", reconcile_tau=0.3))


def corridor_plan(name, rounds, **overrides):
    """The port's own corridor plan of one run, and its K1 launch count:
    one per chunk of the per-RSU chains of every segment."""
    import dataclasses
    from repro_torch.core.jit_engine import eval_rounds_of
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.corridor import engine, plan_corridor
    from repro_torch.faults import scenario_faults
    sc = dataclasses.replace(get_scenario(name), rounds=rounds, **overrides)
    plan = plan_corridor(sc.channel(), sc.n_rsus, 0, rounds,
                         entry=sc.corridor_entry,
                         selection=sc.selection_spec(),
                         reconcile_every=sc.reconcile_every,
                         faults=scenario_faults(sc), l_iters=sc.l_iters)
    return sc, plan, engine.chain_launches(
        plan, eval_rounds_of(rounds, EVAL_EVERY), sc.reconcile_every)


def run_corridor(name, rounds, engine="corridor", **overrides):
    """One corridor-world run on the card with the kernel path on;
    returns (result, ms/round, launch counts)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.scenarios import run_scenario

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(name, engine=engine, use_kernel=True, device=DEVICE,
                       rounds=rounds, eval_every=EVAL_EVERY, **overrides)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    tag = f"{name}/{engine}{' ' + str(overrides) if overrides else ''}"
    check(len(res.rounds) == rounds,
          f"{tag}: {len(res.rounds)} of {rounds} rounds")
    for k, v in res.final_params.items():
        check(v.device.type == DEVICE and bool(torch.isfinite(v).all()),
              f"{tag}: final {k} not finite on the card")
    accs = [a for _, a in res.acc_history]
    check(all(np.isfinite(accs)) and 0.0 <= accs[-1] <= 1.0,
          f"{tag}: accuracy history {accs}")
    ms_round = dt / rounds * 1e3
    by_rsu = np.bincount([r.rsu for r in res.rounds])
    log(f"corridor: {tag} rounds={rounds}: {ms_round:.3f} ms/round "
        f"({dt:.3f} s), final accuracy {res.final_accuracy():.5f}, uploads "
        f"per RSU {by_rsu.tolist()}, ring_agg launches "
        f"{counts['ring_agg']}, weighted_agg launches "
        f"{counts['weighted_agg']}")
    return res, ms_round, counts


def phase_corridor(dev):
    """The corridor path: K2 on the [R, P] stack against its plain
    version; the device engine on every corridor world (K1 = the plan's
    chunks, K2 = 0 under FedAvg), the EMA reconcile (K2 = one launch per
    reconcile) and the serial handover loop (K2 = one launch per arrival)
    on the card.  Returns (K1 launches, K2 launches, ms/round of
    corridor-r8-k4000)."""
    import torch
    from repro_torch.core.scenarios import build_world, get_scenario
    from repro_torch.corridor import plan_corridor
    from repro_torch.kernels.weighted_agg import ops, ref
    from repro_torch.models.cnn import CNN_SHAPES

    # K2 at the EMA reconcile's shape: the whole [R, P] stack as one leaf
    # against the broadcast mean, bitwise
    P = 422016
    gen = torch.Generator(device=dev).manual_seed(1)
    for R in (2, 4, 8):
        G = torch.randn(R, P, generator=gen, device=dev)
        C = G.mean(dim=0).expand_as(G).contiguous()
        n = check_merge(f"corridor stack [{R}, {P}]", ops, ref, {"G": G},
                        {"G": C}, float(np.float32(1.0) - np.float32(0.3)),
                        1.0, {"G": (G.clone(), C.clone())})
        check(n == 1, f"weighted_agg on the [{R}, P] stack: {n} launches")
    log(f"corridor: weighted_agg on the [R, {P}] stack (R = 2, 4, 8) "
        f"bitwise its plain version, one launch each")

    k1 = k2 = 0
    ms = {}
    for name, rounds in CORRIDOR_RUNS:
        t0 = time.perf_counter()                 # warm-up, untimed
        run_corridor(name, rounds)
        log(f"corridor: {name} warm-up {time.perf_counter() - t0:.3f} s")
        _, _, want = corridor_plan(name, rounds)
        res, ms[name], counts = run_corridor(name, rounds)
        check(counts["ring_agg"] == want,
              f"{name}/corridor: {counts['ring_agg']} ring_agg launches for "
              f"the plan's {want} chunks")
        check(counts["weighted_agg"] == 0,
              f"{name}/corridor: {counts['weighted_agg']} weighted_agg "
              f"launches under FedAvg")
        k1 += counts["ring_agg"]
        # the run's host set-up, timed alone: world building and the plan
        sc = get_scenario(name)
        t0 = time.perf_counter()
        _, _, _, p = build_world(sc)
        t1 = time.perf_counter()
        plan_corridor(p, sc.n_rsus, 0, rounds, entry=sc.corridor_entry)
        t2 = time.perf_counter()
        log(f"corridor:   {name}: ring_agg launches = the plan's {want} "
            f"chunks; set-up timed alone: build_world {t1 - t0:.3f} s, "
            f"plan_corridor {t2 - t1:.3f} s")

    name, rounds, ema = CORRIDOR_EMA
    sc, _, want = corridor_plan(name, rounds, **ema)
    run_corridor(name, rounds, **ema)            # warm-up, untimed
    _, ms_ema, counts = run_corridor(name, rounds, **ema)
    merges = rounds // sc.reconcile_every
    check(counts["ring_agg"] == want and counts["weighted_agg"] == merges,
          f"{name} EMA: ring_agg {counts['ring_agg']} (plan {want}), "
          f"weighted_agg {counts['weighted_agg']} (reconciles {merges})")
    k1 += counts["ring_agg"]
    k2 += counts["weighted_agg"]
    log(f"corridor: {name} EMA tau 0.3: weighted_agg launches "
        f"{counts['weighted_agg']} = one per reconcile ({merges}); "
        f"{ms_ema:.3f} ms/round")

    # the serial handover loop: every mafl merge is one weighted_agg launch
    per_merge = ops.launches(len(CNN_SHAPES))
    for name, rounds in (("corridor-quick-r2-k8", 8),
                         ("highway-k40-handover", 80)):
        run_corridor(name, rounds, engine="serial")   # warm-up, untimed
        _, _, counts = run_corridor(name, rounds, engine="serial")
        check(counts["weighted_agg"] == per_merge * rounds
              and counts["ring_agg"] == 0,
              f"{name}/serial: weighted_agg {counts['weighted_agg']} for "
              f"{rounds} arrivals, ring_agg {counts['ring_agg']}")
        k2 += counts["weighted_agg"]
    log(f"corridor: serial handover loop: weighted_agg launches one per "
        f"arrival ({per_merge} per merge)")
    return k1, k2, ms["corridor-r8-k4000"]


def phase_corridor_vs_cpu(rounds=8, **fields):
    """corridor-quick-r2-k8 for ``rounds`` rounds on the card and on the
    CPU from one numpy-made init, on the device engine and on the serial
    loop; ``fields`` holds Scenario selection or fault fields (then the
    two ``report.selection`` or ``extras["faults"]`` must be equal
    too)."""
    import dataclasses
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core.scenarios import build_world, get_scenario
    from repro_torch.corridor import (run_corridor_simulation,
                                      run_handover_simulation)
    from repro_torch.faults import scenario_faults

    sc = dataclasses.replace(get_scenario("corridor-quick-r2-k8"),
                             rounds=rounds, **fields)
    veh, te_i, te_l, p = build_world(sc)
    init = numpy_init()
    selection = sc.selection is not None
    for engine, run in (("corridor", run_corridor_simulation),
                        ("serial", run_handover_simulation)):
        out = {}
        for dev in (DEVICE, "cpu"):
            out[dev] = run(sc, veh, te_i, te_l, p, eval_every=4,
                           use_kernel=True,
                           init_params=params_from_jax(init, dev),
                           faults=scenario_faults(sc), device=dev)
        gpu, cpu = out[DEVICE], out["cpu"]
        label = f"{engine} {sc.selection}" if selection else engine
        if sc.faults is not None:
            label = (f"{label} faults={sc.faults}"
                     + (" with overrides" if sc.faults_overrides else ""))
            summary = cpu.extras["faults"]
            check(gpu.extras["faults"] == summary,
                  f"corridor {label}: card and CPU fault summaries differ")
            log(f"corridor: {engine} under faults: card and CPU fault "
                f"summaries equal: {summary['counts']}, recoveries at "
                f"{[b for b, _ in summary['readmits']]}")
        if selection:
            summary = cpu.report.selection
            check(gpu.report.selection == summary,
                  f"corridor {label}: card and CPU selection summaries "
                  f"differ")
            log(f"corridor: {label}: card and CPU selection summaries "
                f"equal: re-scored at "
                f"{[b for b, _, _ in summary['decisions']]}, re-admitted "
                f"{[n for _, n, _ in summary['decisions']]}")
        trace = [(r.round, r.vehicle, r.rsu) for r in cpu.rounds]
        check([(r.round, r.vehicle, r.rsu) for r in gpu.rounds] == trace,
              f"corridor {label}: card and CPU (round, vehicle, rsu) "
              f"traces differ")
        tg = np.array([r.time for r in gpu.rounds])
        tc = np.array([r.time for r in cpu.rounds])
        check(np.allclose(tg, tc, **JIT_TIME_TOL),
              f"corridor {label}: card and CPU event times differ: {tg} vs "
              f"{tc}")
        pg, pc = (params_to_numpy(gpu.final_params),
                  params_to_numpy(cpu.final_params))
        worst = max(float(np.abs(pg[k] - pc[k]).max()) for k in pg)
        for k in pg:
            check(np.allclose(pg[k], pc[k], atol=HOST_ATOL, rtol=HOST_RTOL),
                  f"corridor {label}: card vs CPU final {k}: max |diff| "
                  f"{float(np.abs(pg[k] - pc[k]).max())}")
        acc_diff = max(abs(a - b) for (_, a), (_, b)
                       in zip(gpu.acc_history, cpu.acc_history))
        check(acc_diff <= ACC_TOL,
              f"corridor {label}: card vs CPU accuracy differs by "
              f"{acc_diff}")
        log(f"corridor: {label}: card and CPU traces identical ((round, "
            f"vehicle, rsu), uploads on RSUs "
            f"{sorted({r for _, _, r in trace})}; event times max |diff| "
            f"{float(np.abs(tg - tc).max())}); final params max |diff| "
            f"{worst} (atol {HOST_ATOL}, rtol {HOST_RTOL}); accuracy max "
            f"|diff| {acc_diff}")


# the selection worlds at their registered sizes and rounds, eval every 10
SELECTION_FLEET = (("fleet-k1000-topk", 30), ("fleet-k1000-budget", 30))
SELECTION_CORRIDOR = ("corridor-r4-k400-bandit", 40)


def admitted_pops(plan):
    """Whether every popped vehicle was admitted when it downloaded: at
    t = 0 (``admit0``), by its previous pop's mask, or re-admitted at the
    boundary after that pop."""
    from repro_torch.core.jit_engine import readmit_points
    sel, readmits = plan.sel, readmit_points(plan)
    for v, d in zip(plan.veh, plan.dl_round):
        if d < 0:
            ok = sel.admit0[v]
        else:
            ok = (sel.mask_for_round(int(d))[v]
                  or int(v) in readmits.get(int(d) + 1, ()))
        if not ok:
            return False
    return True


def phase_selection(dev):
    """Vehicle selection on every engine of the port at registered sizes:
    the fleet engine on fleet-k1000-topk and -budget (K1 = the selection
    plan's chains, K2 = 0, every pop admitted, the summary equal to a host
    re-plan's), the batched host engine on fleet-k1000-topk (K2 = one
    launch per merge), the corridor engine on corridor-r4-k400-bandit (K1 =
    ``chain_launches`` of its plan, the bandit guard passing) and the
    serial handover loop on it (K2 = one launch per arrival); selection
    with the EMA reconcile raises.  Returns (K1 launches, K2 launches)."""
    from repro_torch.core import jit_engine
    from repro_torch.core.scenarios import (build_world, get_scenario,
                                            run_scenario)
    from repro_torch.corridor import plan_corridor
    from repro_torch.kernels.weighted_agg import ops
    from repro_torch.models.cnn import CNN_SHAPES

    k1 = k2 = 0
    for name, rounds in SELECTION_FLEET:
        t0 = time.perf_counter()                 # warm-up, untimed
        run_scenario(name, engine="jit", use_kernel=True, device=DEVICE,
                     rounds=rounds, eval_every=EVAL_EVERY)
        log(f"selection: {name} warm-up {time.perf_counter() - t0:.3f} s")
        res, _, n = run_fleet(name, rounds)
        k1 += n
        if name == SELECTION_FLEET[0][0]:
            profile_run(name, "jit", rounds)
        sc = get_scenario(name)
        plan = jit_engine.plan_fleet(sc.channel(), 0, rounds,
                                     selection=sc.selection_spec())
        summary = res.report.selection
        check(summary == plan.sel.summary(),
              f"{name}/jit: selection summary differs from a host re-plan")
        check(admitted_pops(plan)
              and [r.vehicle for r in res.rounds] == plan.veh.tolist(),
              f"{name}/jit: a popped vehicle was not admitted")
        log(f"selection: {name}/jit: {sum(summary['admit0'])} of {sc.K} "
            f"admitted ({summary['policy']}), {len(plan.waves)} waves, "
            f"{len({r.vehicle for r in res.rounds})} vehicles arrived; "
            f"every pop admitted; summary = the host re-plan's")

    name = SELECTION_FLEET[0][0]
    run_scenario(name, engine="batched", use_kernel=True, device=DEVICE,
                 rounds=5)                       # warm-up, untimed
    res, _, n = run_main(name, "batched", SELECTION_FLEET[0][1])
    k2 += n
    check(not all(res.report.selection["admit0"]),
          f"{name}/batched: nothing parked")

    name, rounds = SELECTION_CORRIDOR
    sc, plan, want = corridor_plan(name, rounds)
    run_corridor(name, rounds)                   # warm-up, untimed
    res, ms, counts = run_corridor(name, rounds)
    check(counts["ring_agg"] == want and counts["weighted_agg"] == 0,
          f"{name}/corridor: ring_agg {counts['ring_agg']} (plan {want}), "
          f"weighted_agg {counts['weighted_agg']}")
    check(res.report.selection == plan.sel.summary(),
          f"{name}/corridor: selection summary differs from the plan's")
    k1 += counts["ring_agg"]
    t0 = time.perf_counter()
    _, _, _, p = build_world(sc)
    t1 = time.perf_counter()
    plan_corridor(p, sc.n_rsus, 0, rounds, selection=sc.selection_spec(),
                  reconcile_every=sc.reconcile_every)
    t2 = time.perf_counter()
    readmitted = [len(n) for _, n, _ in plan.sel.boundaries]
    log(f"selection: {name}/corridor: ring_agg launches = the plan's "
        f"{want} chunks; bandit guard passed; re-admitted {readmitted} at "
        f"{[b for b, _, _ in plan.sel.boundaries]}; set-up timed alone: "
        f"build_world {t1 - t0:.3f} s, plan_corridor {t2 - t1:.3f} s; "
        f"{ms:.3f} ms/round")

    per_merge = ops.launches(len(CNN_SHAPES))
    run_corridor(name, 8, engine="serial")       # warm-up, untimed
    _, _, counts = run_corridor(name, rounds, engine="serial")
    check(counts["weighted_agg"] == per_merge * rounds
          and counts["ring_agg"] == 0,
          f"{name}/serial: weighted_agg {counts['weighted_agg']} for "
          f"{rounds} arrivals, ring_agg {counts['ring_agg']}")
    k2 += counts["weighted_agg"]

    for engine in ("corridor", "serial"):
        try:
            run_scenario(name, engine=engine, device=DEVICE, rounds=8,
                         reconcile_mode="ema")
        except ValueError as e:
            check("ema" in str(e), f"{name}/{engine} EMA: {e}")
        else:
            check(False, f"{name}/{engine}: selection with the EMA "
                         f"reconcile ran")
    log(f"selection: {name}: selection with the EMA reconcile raises "
        f"ValueError on both corridor engines")
    return k1, k2


def phase_selection_vs_cpu():
    """Selection card against CPU: paper-k10 with weighted-topk k 5 for 8
    rounds on the serial and the fleet engine, and corridor-quick-r2-k8
    with eps-bandit k 2, eps 0.4 for 12 rounds on both corridor engines,
    each from one numpy-made init within phase 5's bands."""
    from repro_torch.selection import SelectionSpec
    topk = SelectionSpec("weighted-topk", k=5)
    phase_host("serial", topk)
    phase_host("jit", topk)
    phase_corridor_vs_cpu(rounds=12, selection="eps-bandit", selection_k=2,
                          selection_eps=0.4)


# the fault worlds at their registered sizes and rounds, eval every 10
FAULT_FLEET = (("fleet-k1000-flaky", 30), ("fleet-k1000-throttled", 30))
FAULT_CORRIDOR = ("corridor-rush-hour-deadzone-r8-k4000", 40)
# repro's churn-heavy spec (its tests/test_faults.py) as Scenario fields:
# drops, blackouts, recoveries, partial cycles, discards and stragglers
# within a few corridor-quick-r2-k8 rounds
HEAVY_FIELDS = dict(faults="flaky", faults_overrides=(
    ("p_dropout", 0.25), ("p_blackout", 0.15), ("blackout_mean", 20.0),
    ("p_partial", 0.5), ("straggler_frac", 0.4), ("straggler_mult", 3.0),
    ("staleness_cap", 6), ("recheck_every", 2)))
# paper-k10 under throttled for 10 rounds: 4 partial cycles, 1 discard
FAULT_HOST_ROUNDS = 10


def fault_replay(name, rounds):
    """The f64 host replay of a registry fault world's decisions."""
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.faults import (replay_corridor_faults,
                                    replay_fleet_faults, scenario_faults)
    sc = get_scenario(name)
    spec = scenario_faults(sc)
    if sc.n_rsus > 1:
        return replay_corridor_faults(
            sc.channel(), sc.n_rsus, 0, rounds, spec, l_iters=sc.l_iters,
            entry=sc.corridor_entry, reconcile_every=sc.reconcile_every)
    return replay_fleet_faults(sc.channel(), 0, rounds, spec,
                               l_iters=sc.l_iters)


def check_faults(tag, res, replay, l_iters):
    summary = res.extras["faults"]
    check(summary == replay.summary(l_iters),
          f"{tag}: fault summary differs from a host replay's")
    log(f"faults: {tag}: summary = the host replay's: {summary['counts']}, "
        f"{sum(not a for a in summary['admit0'])} dark at t = 0, "
        f"recoveries {[(b, len(v)) for b, v in summary['readmits']]}, "
        f"{summary['n_stragglers']} stragglers, {sum(summary['keep'])} of "
        f"{len(summary['keep'])} merges kept")


def phase_faults(dev):
    """Fault injection on every engine of the port at registered sizes:
    fleet-k1000-flaky and -throttled on the fleet engine (K1 = the fault
    plans' chains, cap discards staying in their chains as no-ops) and on
    ``batched`` (K2 = one launch per kept merge), the dead-zone corridor on
    the corridor engine (K1 = ``chain_launches`` of its plan, K2 = 0); each
    summary equal to a host replay's; timeline faults with the EMA
    reconcile raise.  Returns (K1 launches, K2 launches)."""
    from repro_torch.core.scenarios import (build_world, get_scenario,
                                            run_scenario)
    from repro_torch.corridor import plan_corridor
    from repro_torch.faults import scenario_faults

    k1 = k2 = 0
    for name, rounds in FAULT_FLEET:
        t0 = time.perf_counter()                 # warm-up, untimed
        run_scenario(name, engine="jit", use_kernel=True, device=DEVICE,
                     rounds=rounds, eval_every=EVAL_EVERY)
        log(f"faults: {name} warm-up {time.perf_counter() - t0:.3f} s")
        res, _, n = run_fleet(name, rounds)
        k1 += n
        if name == FAULT_FLEET[0][0]:
            profile_run(name, "jit", rounds)
        check_faults(f"{name}/jit", res, fault_replay(name, rounds),
                     get_scenario(name).l_iters)

    for name, rounds in FAULT_FLEET:
        run_scenario(name, engine="batched", use_kernel=True, device=DEVICE,
                     rounds=5)                   # warm-up, untimed
        replay = fault_replay(name, rounds)
        res, _, n = run_main(name, "batched", rounds)
        check(n == sum(replay.keep),
              f"{name}/batched: {n} weighted_agg launches, "
              f"{sum(replay.keep)} kept merges in the replay")
        k2 += n
        check_faults(f"{name}/batched", res, replay,
                     get_scenario(name).l_iters)

    name, rounds = FAULT_CORRIDOR
    sc, plan, want = corridor_plan(name, rounds)
    run_corridor(name, rounds)                   # warm-up, untimed
    res, ms, counts = run_corridor(name, rounds)
    check(counts["ring_agg"] == want and counts["weighted_agg"] == 0,
          f"{name}/corridor: ring_agg {counts['ring_agg']} (plan {want}), "
          f"weighted_agg {counts['weighted_agg']}")
    k1 += counts["ring_agg"]
    check_faults(f"{name}/corridor", res, fault_replay(name, rounds),
                 sc.l_iters)
    t0 = time.perf_counter()
    _, _, _, p = build_world(sc)
    t1 = time.perf_counter()
    plan_corridor(p, sc.n_rsus, 0, rounds, entry=sc.corridor_entry,
                  reconcile_every=sc.reconcile_every,
                  faults=scenario_faults(sc), l_iters=sc.l_iters)
    t2 = time.perf_counter()
    log(f"faults: {name}/corridor: ring_agg launches = the plan's {want} "
        f"chunks; set-up timed alone: build_world {t1 - t0:.3f} s, "
        f"plan_corridor {t2 - t1:.3f} s; {ms:.3f} ms/round")

    for engine in ("corridor", "serial"):
        try:
            run_scenario(name, engine=engine, device=DEVICE, rounds=8,
                         K=40, reconcile_mode="ema")
        except ValueError as e:
            check("ema" in str(e), f"{name}/{engine} EMA: {e}")
        else:
            check(False, f"{name}/{engine}: timeline faults with the EMA "
                         f"reconcile ran")
    log(f"faults: {name}: deadzone with the EMA reconcile raises "
        f"ValueError on both corridor engines")
    return k1, k2


def phase_faults_vs_cpu():
    """Faults card against CPU: paper-k10 with throttled (partial cycles
    and a cap discard) on the serial and the fleet engine, and
    corridor-quick-r2-k8 with repro's HEAVY spec for 24 rounds of 2 local
    steps on both corridor engines, each from one numpy-made init: equal
    ``extras["faults"]``, the same traces, times and params within phase
    5's bands."""
    phase_host("serial", faults="throttled", rounds=FAULT_HOST_ROUNDS)
    phase_host("jit", faults="throttled", rounds=FAULT_HOST_ROUNDS)
    phase_corridor_vs_cpu(rounds=24, l_iters=2, **HEAVY_FIELDS)


# telemetry (metrics="on") on the device engines at registered sizes: the
# f32 ring, the bf16 ring guard, the fault counters, the corridor's per-RSU
# channels and the bandit's reward accumulators
TELEMETRY_RUNS = (("fleet-k1000", 30, "jit"), ("fleet-k10000", 60, "jit"),
                  ("fleet-k1000-flaky", 30, "jit"),
                  ("corridor-r8-k4000", 40, "corridor"),
                  ("corridor-r4-k400-bandit", 40, "corridor"))
# metrics on leaves the models as they are: cuDNN is set deterministic
# (repro_torch/device.py), so the bound is met with room; an off-path op
# leaking into the training would move them by 1e-3 and more
TELEMETRY_PARAM_TOL = 1e-6
TELEMETRY_GAP_TOL = dict(rtol=1e-4, atol=1e-3)


def telemetry_run(name, rounds, engine, metrics):
    """One run with ``metrics`` (None or "on"); returns (result, ms/round,
    launch counts)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.scenarios import run_scenario

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(name, engine=engine, use_kernel=True, device=DEVICE,
                       rounds=rounds, eval_every=EVAL_EVERY, metrics=metrics)
    torch.cuda.synchronize()
    return (res, (time.perf_counter() - t0) / rounds * 1e3,
            kernels.launch_counts())


def telemetry_replay(name, rounds):
    """The port's own f64 channel replay of a registry world and the edges
    the planner derives from it."""
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.faults import scenario_faults
    from repro_torch.telemetry.replay import (replay_corridor_channels,
                                              replay_fleet_channels)
    from repro_torch.telemetry.spec import resolve_metrics
    sc = get_scenario(name)
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
    return sc, rep, spec


def check_channels(tag, res, sc, rep, spec):
    """A metrics-on card run's channels against the f64 replay: histogram,
    occupancy, handovers and fault counters exactly, the pop wait within
    rtol 1e-4 / atol 1e-3."""
    from repro_torch.faults import (replay_corridor_faults,
                                    replay_fleet_faults, scenario_faults)
    from repro_torch.telemetry.spec import stale_histogram
    ch = res.report.channels
    check(res.report.spec["edges"] == list(spec.edges),
          f"{tag}: spec edges {res.report.spec['edges']} differ from the "
          f"replay's {list(spec.edges)}")
    rsu = rep.get("up_rsu")
    check(np.array_equal(ch["stale_hist"], stale_histogram(
        spec.edges, rep["stale"], rsu=rsu, n_rsus=sc.n_rsus)),
          f"{tag}: staleness histogram {ch['stale_hist'].tolist()} differs "
          f"from the replay's")
    check(np.array_equal(ch["occupancy"], rep["occupancy"]),
          f"{tag}: occupancy differs from the replay's")
    check(np.allclose(ch["gap"], rep["gap"], **TELEMETRY_GAP_TOL),
          f"{tag}: pop wait outside rtol 1e-4 / atol 1e-3 of the replay's")
    if rsu is not None:
        check(np.array_equal(np.asarray(ch["handover"], bool),
                             rep["handover"])
              and np.array_equal(ch["handover_count"],
                                 rep["handover_count"]),
              f"{tag}: handovers differ from the replay's")
    spec_f = scenario_faults(sc)
    if spec_f is not None:
        if sc.n_rsus > 1:
            replay = replay_corridor_faults(
                sc.channel(), sc.n_rsus, 0, len(rep["veh"]), spec_f,
                l_iters=sc.l_iters, entry=sc.corridor_entry,
                reconcile_every=sc.reconcile_every)
        else:
            replay = replay_fleet_faults(sc.channel(), 0, len(rep["veh"]),
                                         spec_f, l_iters=sc.l_iters)
        want = replay.counts_table(sc.l_iters).sum(0)
        check(np.array_equal(ch["fault_counts"], want),
              f"{tag}: fault counters {ch['fault_counts'].tolist()} differ "
              f"from the replay's {want.tolist()}")


def phase_telemetry():
    """Telemetry on the device engines at registered sizes: each world run
    metrics-off and metrics-on in turns (off, on, on, off).  The K1/K2
    launches are equal on and off, the card's channels equal the port's
    own f64 replay, the trace is identical and the params within 1e-6;
    ms/round on and off, the report's memory keys and one rendered run
    log line are printed.  Returns the K1 and K2 launches of the
    metrics-on runs (one per world)."""
    import torch
    from repro_torch.telemetry import runlog

    k1 = k2 = 0
    rendered = None
    for name, rounds, engine in TELEMETRY_RUNS:
        sc, rep, spec = telemetry_replay(name, rounds)
        ms = {None: [], "on": []}
        runs = {}
        for metrics in (None, "on", "on", None):
            res, ms_round, counts = telemetry_run(name, rounds, engine,
                                                  metrics)
            ms[metrics].append(ms_round)
            runs.setdefault(metrics, (res, counts))
        (off, c_off), (on, c_on) = runs[None], runs["on"]
        tag = f"{name}/{engine}"
        check(c_on == c_off, f"{tag}: launches with metrics on {c_on}, "
              f"off {c_off}")
        check(on.report.metrics_on and not off.report.metrics_on
              and off.report.channels == {},
              f"{tag}: metrics on/off reports {on.report.metrics_on}, "
              f"{off.report.metrics_on}")
        check([(r.round, r.vehicle, r.time) for r in on.rounds]
              == [(r.round, r.vehicle, r.time) for r in off.rounds],
              f"{tag}: the trace differs with metrics on")
        diff = max((on.final_params[k] - off.final_params[k]).abs().max()
                   .item() for k in off.final_params)
        check(diff <= TELEMETRY_PARAM_TOL and all(
            v.is_cuda for v in on.final_params.values()),
            f"{tag}: params with metrics on differ by {diff} (or left the "
            f"card)")
        check_channels(tag, on, sc, rep, spec)
        ch = on.report.channels
        extra = []
        if name == "fleet-k10000":
            check(int(ch["ring_nonfinite"]) == 0
                  and float(ch["ring_max_abs"]) > 0.0,
                  f"{tag}: bf16 ring guard {ch['ring_nonfinite']} "
                  f"non-finite, max |row| {ch['ring_max_abs']}")
            extra.append(f"ring_nonfinite 0, ring_max_abs "
                         f"{float(ch['ring_max_abs']):.6g}")
        if "fault_counts" in ch:
            extra.append(f"fault_counts {ch['fault_counts'].tolist()} = the "
                         f"replay's")
        if sc.selection == "eps-bandit":
            check("reward_sum" in ch and int(ch["reward_count"].sum())
                  == rounds, f"{tag}: bandit accumulators {sorted(ch)}")
            extra.append(f"reward_count sum {int(ch['reward_count'].sum())}"
                         f", reward_sum sum {float(ch['reward_sum'].sum()):.6f}")
        if "handover_count" in ch:
            extra.append(f"handovers per RSU {ch['handover_count'].tolist()}")
        mem = on.report.memory
        check({"device_bytes_in_use", "device_peak_bytes_in_use",
               "device_bytes_limit"} <= set(mem),
              f"{tag}: report memory keys {sorted(mem)}")
        k1 += c_on["ring_agg"]
        k2 += c_on["weighted_agg"]
        m_off, m_on = np.median(ms[None]), np.median(ms["on"])
        log(f"telemetry: {tag} rounds={rounds}: ms/round off "
            f"{[round(x, 3) for x in ms[None]]} on "
            f"{[round(x, 3) for x in ms['on']]} (median on/off "
            f"{m_on / m_off:.4f}); launches equal on and off {c_on}; "
            f"channels = the f64 replay (histogram "
            f"{np.asarray(ch['stale_hist']).tolist()}, occupancy, gap"
            f"{', handovers' if 'handover' in ch else ''}); trace identical, "
            f"params max |on - off| {diff}"
            f"{'; ' + '; '.join(extra) if extra else ''}")
        log(f"telemetry:   {tag} memory {mem}; phases "
            f"{ {k: round(v, 4) for k, v in on.report.phases.items()} }")
        if rendered is None:
            rendered = runlog.render([on.report.to_json()])
    log("telemetry: rendered run log line:\n" + rendered)
    profile_later_launches("fleet-k1000", 30, "jit")
    return k1, k2


def profile_later_launches(name, rounds, engine):
    """Queue the profiler's count of the kernels one run launches with
    metrics off and on: the extra launches per pop that telemetry costs."""
    def measure():
        import torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.scenarios import run_scenario
        out = {}
        for metrics in (None, "on"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_scenario(name, engine=engine, use_kernel=True,
                             device=DEVICE, rounds=rounds,
                             eval_every=EVAL_EVERY, metrics=metrics)
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_time_total > 0 and str(
                        getattr(e, "device_type", "")).endswith("CUDA")]
            out[metrics] = (sum(e.count for e in rows),
                            sum(e.device_time_total for e in rows) / 1e3)
        (n_off, d_off), (n_on, d_on) = out[None], out["on"]
        log(f"profile: telemetry {name}/{engine} {rounds} rounds: device "
            f"kernels off {n_off} launches / {d_off:.3f} ms, on {n_on} / "
            f"{d_on:.3f} ms: {(n_on - n_off) / rounds:.2f} extra launches "
            f"and {(d_on - d_off) / rounds * 1e3:.3f} us of device time per "
            f"pop")
    PROFILED.append(measure)


# K4 decode_attention / K5 swa_attention: f32 inputs from N(0, 1) within
# 2e-5 of the plain version (the online softmax sums in another order than
# the dense softmax), bf16 within 3e-2 (the plain version rounds scores and
# weights to bf16; the band of repro's own bf16 kernel test)
# the sweep tier (engine="vmap") at registered sizes, eval every 10
SWEEP_BETAS = (0.1, 0.3, 0.5, 0.7, 0.9)
SWEEP_SEEDS = (0, 1, 2)
# a world of a shared timeline group (one seed at several betas) trains in
# one batched call: vmap over stacked params makes cuDNN run grouped
# convolutions where its solo run broadcasts one payload, another f32 sum
# order per step that 40 rounds of 5 SGD steps carry forward and amplify.
# The same solo world differs by 1.8e-3 between an H100 and the CPU at
# that length (paper-k10 seed 1, beta 0.1), so the band is the distance
# such a reordering reaches, not phase 5's 8-round one: atol 1e-2 (the
# largest reading on an H100, 4.9e-3, is half of it).  Printed beside it: how far the
# world is from its group's other solo runs (other betas), which a mixed-up
# payload row or minibatch would bring it towards.  Accuracy is printed,
# not held: at 0.1-0.35 on 800 test images it moves by up to 0.07 with
# such drift.
SWEEP_GROUP_ATOL = 1e-2


def sweep_batches():
    """The three batches of ``phase_sweep``: (label, ``SweepSpec``)."""
    from repro_torch.core.scenarios import SweepSpec
    beta = tuple((("channel_overrides", (("beta", b),)),)
                 for b in SWEEP_BETAS)
    return (
        ("Fig. 5 grid: paper-k10, 5 betas x 3 seeds", SweepSpec(
            scenario="paper-k10", seeds=SWEEP_SEEDS, variants=beta,
            eval_every=EVAL_EVERY)),
        ("fleet-k1000, 3 seeds", SweepSpec(
            scenario="fleet-k1000", seeds=SWEEP_SEEDS,
            eval_every=EVAL_EVERY)),
        ("fleet-k1000 admit-all + weighted-topk k 250", SweepSpec(
            scenario="fleet-k1000", seeds=(0,), variants=((), (
                ("selection", "weighted-topk"), ("selection_k", 250))),
            eval_every=EVAL_EVERY)))


def sweep_record(r):
    return (r.round, r.vehicle, r.time, r.upload_delay, r.train_delay,
            r.weight)


def phase_sweep():
    """The sweep tier on the card at the paper CNN's full width: the Fig. 5
    grid (paper-k10, W 15 in 3 shared-timeline groups), fleet-k1000 at 3
    seeds (W 3 singleton groups) and fleet-k1000 admit-all beside
    weighted-topk (the ``[W, M, K]`` admission fold).  Each batch runs once
    to warm up and once timed with the launch counts zeroed: ``ring_agg``
    launches = the union plan's chains (written down before the run),
    ``weighted_agg`` none; then each world solo on ``jit``: the same pop
    order and times bit for bit, params and accuracy bitwise for a
    singleton group, params within ``SWEEP_GROUP_ATOL`` for a shared
    one.  Logs each world's accuracy,
    ms per world-round beside the solo runs' ms/round, the batch's set-up
    seconds and the device peak memory.  Returns the ``ring_agg`` launches
    of the timed batches."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import jit_engine, sweep
    from repro_torch.core.scenarios import run_scenario, run_sweep

    total = 0
    for label, spec in sweep_batches():
        worlds = spec.worlds()
        W, M = len(worlds), worlds[0][0].rounds
        plans = [jit_engine.plan_fleet(sc.channel(), seed, M,
                                       sc.selection_spec(),
                                       l_iters=sc.l_iters)
                 for sc, seed in worlds]
        want = len(sweep.chain_ends(plans, jit_engine.eval_rounds_of(
            M, spec.eval_every)))
        log(f"sweep: {label}: W={W}, {M} rounds: the union plan has {want} "
            f"chains, so ring_agg should launch {want} times for all "
            f"{W} worlds")
        t0 = time.perf_counter()
        run_sweep(spec, device=DEVICE)                # warm-up, untimed
        warm = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()     # what earlier phases hold
        kernels.reset_launches()
        t0 = time.perf_counter()
        vm = run_sweep(spec, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(counts["ring_agg"] == want,
              f"sweep {label}: {counts['ring_agg']} ring_agg launches for "
              f"the union plan's {want} chains")
        check(counts["weighted_agg"] == 0,
              f"sweep {label}: {counts['weighted_agg']} weighted_agg "
              "launches")
        total += counts["ring_agg"]
        groups = [r.report.channels["group"] for r in vm]
        solos, solo_ms = [], []
        for (sc, seed), v in zip(worlds, vm):
            t0 = time.perf_counter()
            solos.append(run_scenario(sc, engine="jit", seed=seed,
                                      eval_every=spec.eval_every,
                                      device=DEVICE))
            torch.cuda.synchronize()
            solo_ms.append((time.perf_counter() - t0) / M * 1e3)

        def dist(x, y):
            return max((x.final_params[k] - y.final_params[k]).abs().max()
                       .item() for k in x.final_params)
        drift, apart, acc_diff = [], [], 0.0
        for w, (v, s) in enumerate(zip(vm, solos)):
            check([sweep_record(r) for r in v.rounds]
                  == [sweep_record(r) for r in s.rounds],
                  f"sweep {label} world {w}: pop order or times differ "
                  f"from its solo jit run")
            check(all(bool(torch.isfinite(x).all()) and x.is_cuda
                      for x in v.final_params.values()),
                  f"sweep {label} world {w}: final params not finite on "
                  f"the card")
            mates = [u for u in range(W) if u != w and groups[u] == groups[w]]
            if not mates:
                check(all(torch.equal(v.final_params[k], s.final_params[k])
                          for k in s.final_params)
                      and v.acc_history == s.acc_history,
                      f"sweep {label} world {w}: a singleton group differs "
                      f"from its solo run")
                continue
            drift.append(dist(v, s))
            apart.append(min(dist(v, solos[u]) for u in mates))
            acc_diff = max(acc_diff, max(abs(x - y) for (_, x), (_, y)
                                         in zip(v.acc_history,
                                                s.acc_history)))
            check(drift[-1] <= SWEEP_GROUP_ATOL,
                  f"sweep {label} world {w}: params {drift[-1]} from its "
                  f"solo run, outside the shared-group band "
                  f"{SWEEP_GROUP_ATOL}")
        accs = [round(v.final_accuracy(), 5) for v in vm]
        ph = vm[0].report.phases
        setup = ph["total"] - ph["run"] - ph["eval"]
        solo_run = sum(r.report.phases["run"] for r in solos)
        solo_setup = sum(r.report.phases["plan"] + r.report.phases["stage"]
                         for r in solos)
        shared = (f"shared groups within atol {SWEEP_GROUP_ATOL} of their "
                  f"solo runs (max |diff| per world "
                  f"{[f'{x:.3g}' for x in drift]}; the nearest other solo "
                  f"run of the group {[f'{x:.3g}' for x in apart]}; "
                  f"accuracy max |diff| {acc_diff:.5f})" if drift
                  else "no shared group")
        log(f"sweep: {label}: ring_agg {counts['ring_agg']} launches = the "
            f"union plan's chains, weighted_agg 0; groups {groups}; every "
            f"world's pop order and times bitwise its solo jit run; "
            f"singleton groups bitwise their solo runs (params, accuracy); "
            f"{shared}; final accuracy per world {accs}")
        log(f"sweep:   {label}: batch {wall:.3f} s ({warm:.3f} s warm-up): "
            f"{wall / M * 1e3:.3f} ms per round of all {W} worlds, "
            f"{wall / (W * M) * 1e3:.3f} ms per world-round; the {W} solo "
            f"runs {sum(solo_ms):.3f} ms/round summed (per world "
            f"{[round(x, 3) for x in solo_ms]}); set-up {setup:.3f} s "
            f"(world building, plan {ph['plan']:.3f} s, stage "
            f"{ph['stage']:.3f} s), run {ph['run']:.3f} s, eval "
            f"{ph['eval']:.3f} s; the solo runs' run phases "
            f"{solo_run:.3f} s, plan and stage {solo_setup:.3f} s summed; "
            f"device peak {peak} bytes, {peak - held} above the {held} "
            f"bytes earlier phases hold")
    return total


def phase_sweep_vs_cpu():
    """quick-k5, 2 betas x 2 seeds (8 rounds) as one sweep batch on the
    card and on the CPU from one numpy-made init per seed: the same
    groups and (round, vehicle) traces, times within the fleet engine's
    f32 band, params within phase 5's bands."""
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core import sweep
    from repro_torch.core.scenarios import SweepSpec

    spec = SweepSpec(scenario="quick-k5", seeds=(0, 1),
                     variants=tuple((("channel_overrides", (("beta", b),)),)
                                    for b in (0.3, 0.7)),
                     overrides=(("rounds", 8),), eval_every=4)
    worlds = spec.worlds()
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        out[dev] = sweep.run_simulation_vmap(
            worlds, eval_every=4, device=dev,
            init_params=[params_from_jax(numpy_init(seed), dev)
                         for _, seed in worlds])
        log(f"sweep: quick-k5 W=4 on {dev}: {time.perf_counter() - t0:.3f} "
            "s")
    worst, t_worst = 0.0, 0.0
    for w, (gpu, cpu) in enumerate(zip(out[DEVICE], out["cpu"])):
        check(gpu.report.channels == cpu.report.channels,
              f"sweep world {w}: card and CPU channels differ")
        check([(r.round, r.vehicle) for r in gpu.rounds]
              == [(r.round, r.vehicle) for r in cpu.rounds],
              f"sweep world {w}: card and CPU traces differ")
        tg = np.array([r.time for r in gpu.rounds])
        tc = np.array([r.time for r in cpu.rounds])
        check(np.allclose(tg, tc, **JIT_TIME_TOL),
              f"sweep world {w}: card and CPU event times differ")
        t_worst = max(t_worst, float(np.abs(tg - tc).max()))
        pg, pc = (params_to_numpy(gpu.final_params),
                  params_to_numpy(cpu.final_params))
        for k in pg:
            worst = max(worst, float(np.abs(pg[k] - pc[k]).max()))
            check(np.allclose(pg[k], pc[k], atol=HOST_ATOL, rtol=HOST_RTOL),
                  f"sweep world {w}: card vs CPU final {k}")
        check(all(abs(a - b) <= ACC_TOL for (_, a), (_, b)
                  in zip(gpu.acc_history, cpu.acc_history)),
              f"sweep world {w}: card vs CPU accuracy")
    log(f"sweep: quick-k5 W=4 card against CPU: groups and traces "
        f"identical, event times max |diff| {t_worst}, final params max "
        f"|diff| {worst} (atol {HOST_ATOL}, rtol {HOST_RTOL})")


# the pytree programs (flat=False) at full width and registered rounds,
# each beside the same world's flat run on the card: (name, engine,
# rounds, options); fleet-k10000 in f32 (the bf16 ring is flat only)
PYTREE_RUNS = (
    ("fleet-k1000", "jit", 30, {}),
    ("fleet-k1000", "jit", 30, {"use_kernel": True}),
    ("fleet-k10000", "jit", 60, {"ring_dtype": "f32"}),
    ("platoon-burst-k500", "jit", 40, {}),
    ("fleet-k1000-flaky", "jit", 30, {}),
    ("fleet-k1000-topk", "jit", 30, {}),
    ("corridor-r4-k400", "corridor", 40,
     {"use_kernel": True, "reconcile_mode": "ema", "reconcile_tau": 0.3}),
    ("highway-k40-handover", "corridor", 80, {}),
    ("corridor-rush-hour-deadzone-r8-k4000", "corridor", 40, {}),
    ("corridor-r4-k400-bandit", "corridor", 40, {"metrics": "on"}),
    ("corridor-quick-r2-k8", "corridor", 8, {"record_cohorts": True}),
)
# pytree against flat under use_kernel: K2's device form mixes with
# 1 - (1 - alpha) where the flat chain uses alpha, one f32 ulp of a mix
# coefficient, carried by SGD through later waves' payloads: on the CPU
# 6.0e-8 (fleet-k1000, 30 rounds) and 8.9e-8 (corridor-r4-k400 EMA, 40
# rounds) apart; without the kernel both are bitwise
PYTREE_KERNEL_ATOL = 1e-5


def pytree_run(name, engine, rounds, flat, opts):
    """One run of a world on the card with ``flat``; returns (result,
    ms/round, launch counts)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.scenarios import run_scenario

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(name, engine=engine, device=DEVICE, rounds=rounds,
                       eval_every=EVAL_EVERY, flat=flat, **opts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(res.rounds) == rounds,
          f"{name}/{engine} flat={flat}: {len(res.rounds)} of {rounds} "
          f"rounds")
    for k, v in res.final_params.items():
        check(v.device.type == DEVICE and bool(torch.isfinite(v).all()),
              f"{name}/{engine} flat={flat}: final {k} not finite")
    return res, dt / rounds * 1e3, kernels.launch_counts()


def pytree_merges_record(dev):
    """K2's device form (its scalars one-element f32 tensors on the card)
    bitwise its plain version and its host-float form on CNN and
    smollm-360m merges; then a CNN merge timed in turns against the
    host-float form and the plain version (tensor scalars), its device
    time queued.  Returns the device form's record."""
    import torch
    from repro_torch import kernels
    from repro_torch.check.grid_race import smollm_leaf_shapes
    from repro_torch.kernels.weighted_agg import ops, ref
    from repro_torch.models.cnn import CNN_SHAPES

    gen = torch.Generator(device=dev).manual_seed(7)

    def tree(shapes):
        return [{k: torch.randn(s, generator=gen, device=dev)
                 for k, s in shapes.items()} for _ in range(2)]
    max_err, launched = 0.0, {}
    scalars = [(1.0 - 0.0734125, 1.0), (0.5, 0.8719)]
    for label, shapes in (("CNN", CNN_SHAPES),
                          ("smollm-360m", smollm_leaf_shapes())):
        g, l = tree(shapes)
        for beta, weight in scalars[:2 if label == "CNN" else 1]:
            want = ops.weighted_agg_tree(g, l, beta, weight)
            tb = torch.tensor(beta, device=dev)
            tw = torch.tensor([weight], device=dev)
            for b, w in ((tb, weight), (beta, tw), (tb, tw)):
                kernels.reset_launches()
                out = ops.weighted_agg_tree(g, l, b, w)
                torch.cuda.synchronize()
                launched[label] = kernels.launch_counts()["weighted_agg"]
                check(launched[label] == ops.launches(len(shapes)),
                      f"weighted_agg device form {label}: "
                      f"{launched[label]} launches")
                for k in g:
                    check(torch.equal(bits(out[k]), bits(want[k])),
                          f"weighted_agg device form {label}: leaf {k} "
                          f"differs from the host-float form")
                    plain = ref.weighted_agg(g[k], l[k], b, w)
                    check(torch.equal(bits(out[k]), bits(plain)),
                          f"weighted_agg device form {label}: leaf {k} "
                          f"differs from its plain version")
                    max_err = max(max_err, (out[k] - plain).abs().max()
                                  .item())
        del g, l, want, out
    log(f"pytree: weighted_agg device form (beta, weight or both on the "
        f"card) bitwise its plain version and its host-float form on CNN "
        f"and smollm-360m merges; launches per merge {launched}; "
        f"max_abs_err={max_err}")

    g, l = tree(CNN_SHAPES)
    gl, ll = list(g.values()), list(l.values())
    beta = 1.0 - 0.0734125
    tb = torch.tensor(beta, device=dev)
    runs = {
        "kernel": lambda: ops.weighted_agg_tree(g, l, tb, 1.0),
        "plain": lambda: {k: ref.weighted_agg(g[k], l[k], tb, 1.0)
                          for k in g},
        "library": lambda: torch._foreach_lerp(gl, ll, 1.0 - beta),
        "host_form": lambda: ops.weighted_agg_tree(g, l, beta, 1.0),
    }
    n_params = sum(int(np.prod(s)) for s in CNN_SHAPES.values())
    row = merge_timings("CNN merge, device scalars (8 leaves, f32)", runs,
                        n_params, 100, 10, 6)
    row["max_abs_err"] = max_err
    # one K2 launch a call; the profiler has kept as few as 3 events of
    # 10 for this call
    device_time_later("weighted_agg device form CNN merge", row,
                      runs["kernel"], "weighted_agg_kernel", iters=50,
                      per_event=True)
    return row


def phase_pytree(dev):
    """The device engines' pytree programs (``flat=False``) at full width
    and registered rounds: K2's device form first (``pytree_merges_record``),
    then each world of ``PYTREE_RUNS`` flat and pytree on the card: the
    same trace bit for bit, the same selection and fault summaries and
    channels, params bitwise without the kernel and within
    ``PYTREE_KERNEL_ATOL`` with it; K2 launches on each pytree run = its
    pops plus its EMA reconciles under ``use_kernel`` (else 0), K1 none.
    Runs in turns (flat, pytree, pytree, flat) for ms/round; the flat
    runs are references and the second pytree run a timing repeat: the
    launches counted are the first pytree run's.
    Returns (the pytree runs' K2 launches, the device form's record)."""
    import torch
    from repro_torch.core.scenarios import get_scenario

    rec = pytree_merges_record(dev)
    total = 0
    for name, engine, rounds, opts in PYTREE_RUNS:
        tag = f"{name}/{engine} {rounds} rounds {opts or ''}".rstrip()
        # in turns (flat, pytree, pytree, flat): a world's first run in a
        # phase can be up to 1.7x slower than its next
        runs = [pytree_run(name, engine, rounds, flat, opts)
                for flat in (True, False, False, True)]
        (flat, flat_ms, _), (tree, tree_ms, counts) = runs[0], runs[1]
        flat_ms = (flat_ms + runs[3][1]) / 2
        tree_ms = (tree_ms + runs[2][1]) / 2
        trace = [(r.round, r.vehicle, r.rsu, r.time, r.upload_delay,
                  r.train_delay, r.weight) for r in flat.rounds]
        check([(r.round, r.vehicle, r.rsu, r.time, r.upload_delay,
                r.train_delay, r.weight) for r in tree.rounds] == trace,
              f"pytree {tag}: trace differs from the flat run's")
        check(tree.report.selection == flat.report.selection
              and tree.extras.get("faults") == flat.extras.get("faults"),
              f"pytree {tag}: selection or fault summary differs")
        check(tree.report.channels.keys() == flat.report.channels.keys()
              and all(np.array_equal(v, flat.report.channels[k])
                      for k, v in tree.report.channels.items()),
              f"pytree {tag}: telemetry channels differ")
        sc = get_scenario(name)
        kernel = opts.get("use_kernel", False)
        reconciles = (rounds // sc.reconcile_every
                      if opts.get("reconcile_mode") == "ema" else 0)
        want = rounds + reconciles if kernel else 0
        check(all(c["weighted_agg"] == want and c["ring_agg"] == 0
                  for _, _, c in runs[1:3]),
              f"pytree {tag}: weighted_agg {counts['weighted_agg']} "
              f"(expected {want}), ring_agg {counts['ring_agg']}")
        total += counts["weighted_agg"]
        diff = max((tree.final_params[k] - flat.final_params[k]).abs().max()
                   .item() for k in flat.final_params)
        pairs = [(flat.final_params, tree.final_params)]
        if "cohort_snapshots" in flat.extras:
            pairs += list(zip(flat.extras["cohort_snapshots"],
                              tree.extras["cohort_snapshots"]))
            pairs.append((flat.extras["final_cohorts"],
                          tree.extras["final_cohorts"]))
        if kernel:
            check(diff <= PYTREE_KERNEL_ATOL,
                  f"pytree {tag}: params {diff} from the flat run's "
                  f"(band {PYTREE_KERNEL_ATOL})")
            check(abs(tree.final_accuracy() - flat.final_accuracy())
                  <= ACC_TOL, f"pytree {tag}: accuracy")
        else:
            check(all(torch.equal(bits(b[k]), bits(a[k]))
                      for a, b in pairs for k in a),
                  f"pytree {tag}: params differ from the flat run's "
                  f"(max |diff| {diff})")
            check(tree.acc_history == flat.acc_history,
                  f"pytree {tag}: accuracy history differs")
        log(f"pytree: {tag}: {tree_ms:.3f} ms/round pytree, {flat_ms:.3f} "
            f"flat (ratio {tree_ms / flat_ms:.4f}; each the mean of two runs "
            f"in turns: {runs[0][1]:.3f}, {runs[1][1]:.3f}, "
            f"{runs[2][1]:.3f}, {runs[3][1]:.3f}); trace identical; params "
            f"{'bitwise' if not kernel else f'max |diff| {diff}'}; "
            f"weighted_agg {counts['weighted_agg']} = {rounds} pops + "
            f"{reconciles} reconciles under use_kernel, ring_agg 0; "
            f"accuracy {tree.final_accuracy():.5f}")
    rec["launches"] = total
    return total, rec


def phase_pytree_vs_cpu(rounds=8):
    """paper-k10 on ``jit`` and corridor-quick-r2-k8 on ``corridor``, both
    ``flat=False`` with the kernel on, for ``rounds`` rounds on the card
    and on the CPU from one numpy-made init: the same traces, times and
    params within phase 5's bands."""
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.core.mafl import run_simulation
    from repro_torch.core.scenarios import build_world, get_scenario
    from repro_torch.corridor import run_corridor_simulation

    import dataclasses
    init = numpy_init()
    for name in ("paper-k10", "corridor-quick-r2-k8"):
        sc = dataclasses.replace(get_scenario(name), rounds=rounds)
        veh, te_i, te_l, p = build_world(sc)
        out = {}
        for dev in (DEVICE, "cpu"):
            kw = dict(eval_every=4, use_kernel=True, flat=False,
                      init_params=params_from_jax(init, dev), device=dev)
            out[dev] = (run_corridor_simulation(sc, veh, te_i, te_l, p,
                                                **kw)
                        if sc.n_rsus > 1 else
                        run_simulation(veh, te_i, te_l, scheme=sc.scheme,
                                       rounds=rounds, l_iters=sc.l_iters,
                                       lr=sc.lr, params=p, engine="jit",
                                       **kw))
        gpu, cpu = out[DEVICE], out["cpu"]
        check([(r.round, r.vehicle, r.rsu) for r in gpu.rounds]
              == [(r.round, r.vehicle, r.rsu) for r in cpu.rounds],
              f"pytree {name}: card and CPU traces differ")
        tg = np.array([r.time for r in gpu.rounds])
        tc = np.array([r.time for r in cpu.rounds])
        check(np.allclose(tg, tc, **JIT_TIME_TOL),
              f"pytree {name}: card and CPU event times differ")
        pg, pc = (params_to_numpy(gpu.final_params),
                  params_to_numpy(cpu.final_params))
        worst = max(float(np.abs(pg[k] - pc[k]).max()) for k in pg)
        for k in pg:
            check(np.allclose(pg[k], pc[k], atol=HOST_ATOL, rtol=HOST_RTOL),
                  f"pytree {name}: card vs CPU final {k}")
        acc_diff = max(abs(a - b) for (_, a), (_, b)
                       in zip(gpu.acc_history, cpu.acc_history))
        check(acc_diff <= ACC_TOL,
              f"pytree {name}: card vs CPU accuracy differs by {acc_diff}")
        log(f"pytree: {name} flat=False {rounds} rounds, card against CPU: "
            f"traces identical, event times max |diff| "
            f"{float(np.abs(tg - tc).max())}, final params max |diff| "
            f"{worst} (atol {HOST_ATOL}, rtol {HOST_RTOL}), accuracy max "
            f"|diff| {acc_diff}")


ATTN_TOL = {"f32": 2e-5, "bf16": 3e-2}
# K4's query heads per kv head held to the plain version (the kernel takes
# 1..8 and 16, llama3-405b's 128 over 8)
DECODE_GROUPS = (1, 3, 4, 5, 8, 16)
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
             ("prefill S=1024 bf16", 1024, "bf16"),
             ("prefill S=512 bf16", 512, "bf16"))


# ---------------------------------------------------------------------------
# phase_mesh: the simulator over ranks of a mesh (launch/mesh.py)
# ---------------------------------------------------------------------------
# each run of the phase: tag -> (engine, world, rounds, options); the fleet
# engine shards its waves over "data", the corridor its cohorts over "rsu"
# (the pytree program: the sharded stack keeps it)
MESH_RUNS = {
    "fleet-k1000": ("jit", "fleet-k1000", 30, {}),
    "corridor-r4-k400 ema": ("corridor", "corridor-r4-k400", 40,
                             dict(reconcile_mode="ema", reconcile_tau=0.3,
                                  use_kernel=True, flat=False)),
    "corridor-quick-r2-k8": ("corridor", "corridor-quick-r2-k8", 8,
                             dict(flat=False)),
}
MESH_AXIS = {"jit": "data", "corridor": "rsu"}
MESH_WORLD = 2
# params of a sharded run against the unsharded run on the card: repro's
# bar for its sharded corridor (tests/test_corridor.py); a split wave
# trains through convolutions of another batch size, and the reconcile's
# mean over 4 cohorts is a mean of two ranks' means
MESH_PARAM_ATOL = 1e-5
# cross_pod_reconcile against the plain f32 reconcile: K2 and the plain
# EMA round their products apart by an ulp
MESH_POD_ATOL = 1e-6


def mesh_run(engine, name, rounds, opts, mesh, device):
    """One run of ``MESH_RUNS`` on ``device`` under ``mesh`` (None:
    unsharded); returns (result, seconds, launch counts).  The fleet world
    goes through ``run_simulation_jit``: ``run_scenario`` hands a mesh to
    the corridor engine only."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.jit_engine import run_simulation_jit
    from repro_torch.core.scenarios import (build_world, get_scenario,
                                            run_scenario)
    kernels.reset_launches()
    t0 = time.perf_counter()
    if engine == "jit":
        sc = get_scenario(name)
        veh, ti, tl, p = build_world(sc)
        res = run_simulation_jit(
            veh, ti, tl, scheme=sc.scheme, rounds=rounds, l_iters=sc.l_iters,
            lr=sc.lr, params=p, eval_every=EVAL_EVERY, use_kernel=True,
            mesh=mesh, device=device, **opts)
    else:
        res = run_scenario(name, engine=engine, device=device, rounds=rounds,
                           eval_every=EVAL_EVERY, mesh=mesh, **opts)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, kernels.launch_counts()


def mesh_digest(res, seconds, counts):
    """A run as numpy: trace, times, params, accuracy, seconds, launches."""
    return {"trace": [(r.round, r.vehicle, r.rsu) for r in res.rounds],
            "times": np.array([[r.time, r.upload_delay, r.train_delay,
                                r.weight] for r in res.rounds]),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in res.final_params.items()},
            "acc": list(res.acc_history), "seconds": seconds,
            "counts": counts}


def mesh_cohorts(device):
    """Two cohort models of ``cross_pod_reconcile``: rank r holds the
    numpy init scaled by r + 1."""
    import torch
    return [{k: torch.from_numpy(v * (r + 1)).to(device)
             for k, v in numpy_init().items()} for r in range(MESH_WORLD)]


def mesh_rank(rank, world, store, device):
    """A rank of phase_mesh's world over gloo: ``all_reduce`` and
    ``broadcast`` on the card's tensors, then every ``MESH_RUNS`` run
    (after one short warm-up on each mesh) with its launches and the host
    time spent in ``all_reduce``, then ``cross_pod_reconcile`` over a
    ``"pod"`` axis.  Writes its results to ``store.rank<r>``."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core.hierarchical import cross_pod_reconcile
    from repro_torch.launch.mesh import make_mesh

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        device = "cuda:0"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    real_all_reduce = dist.all_reduce
    coll = {"calls": 0, "seconds": 0.0}

    def timed_all_reduce(*a, **kw):
        t0 = time.perf_counter()
        out = real_all_reduce(*a, **kw)
        coll["seconds"] += time.perf_counter() - t0
        coll["calls"] += 1
        return out

    out = {}
    try:
        t = torch.full((4,), float(rank + 1), device=device)
        dist.all_reduce(t)
        b = torch.full((4,), float(rank + 7), device=device)
        dist.broadcast(b, src=0)
        out["collectives"] = (t.tolist(), b.tolist(), str(t.device))
        meshes = {a: make_mesh((world,), (a,), device)
                  for a in ("data", "rsu", "pod")}
        for engine, name, _, opts in MESH_RUNS.values():  # warm-up
            mesh_run(engine, name, 4, opts, meshes[MESH_AXIS[engine]],
                     device)
        dist.all_reduce = timed_all_reduce
        for tag, (engine, name, rounds, opts) in MESH_RUNS.items():
            coll.update(calls=0, seconds=0.0)
            res, s, counts = mesh_run(engine, name, rounds, opts,
                                      meshes[MESH_AXIS[engine]], device)
            out[tag] = dict(mesh_digest(res, s, counts), **{
                f"all_reduce_{k}": v for k, v in coll.items()})
        dist.all_reduce = real_all_reduce
        mine = mesh_cohorts(device)[rank]
        for tau in (1.0, 0.5):
            kernels.reset_launches()
            got = cross_pod_reconcile(mine, meshes["pod"], shard_spec="pod",
                                      tau=tau, use_kernel=True)
            out["pod", tau] = ({k: v.cpu().numpy() for k, v in got.items()},
                               kernels.launch_counts())
    finally:
        dist.all_reduce = real_all_reduce
        dist.destroy_process_group()
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(out, f)


def mesh_compare(tag, got, want, bitwise):
    """A sharded run against the unsharded one: the (round, vehicle, rsu)
    trace exact, times in the fleet engine's f32 band, accuracy within the
    golden bar, params bitwise or within ``MESH_PARAM_ATOL``; returns the
    params' max difference."""
    check(got["trace"] == want["trace"], f"mesh: {tag}: trace differs")
    check(np.allclose(got["times"], want["times"], **JIT_TIME_TOL),
          f"mesh: {tag}: times differ")
    err = max(float(np.abs(got["params"][k] - v).max())
              for k, v in want["params"].items())
    if bitwise:
        check(all(got["params"][k].tobytes() == v.tobytes()
                  for k, v in want["params"].items())
              and np.array_equal(got["times"], want["times"])
              and got["acc"] == want["acc"],
              f"mesh: {tag}: not bitwise the unsharded run ({err})")
    check(err <= MESH_PARAM_ATOL,
          f"mesh: {tag}: params {err} from the unsharded run")
    check(all(abs(a - b) <= ACC_TOL for (_, a), (_, b)
              in zip(got["acc"], want["acc"])),
          f"mesh: {tag}: accuracy {got['acc']} vs {want['acc']}")
    return err


def mesh_expected(tag, rank):
    """The plan's launches of ``MESH_RUNS[tag]`` on one rank of the
    ``MESH_WORLD`` ranks: K1 once a chain of the fleet plan on every
    rank; K2, under ``use_kernel`` on the pytree corridor, once a pop on
    the rank's cohorts and once an EMA reconcile."""
    engine, name, rounds, opts = MESH_RUNS[tag]
    if engine == "jit":
        return {"ring_agg": expected_chains(name, rounds),
                "weighted_agg": 0}
    sc, plan, _ = corridor_plan(name, rounds)
    rl = sc.n_rsus // MESH_WORLD
    pops = int(np.sum(plan.up_rsu // rl == rank))
    k2 = (pops + (rounds // sc.reconcile_every
                  if opts.get("reconcile_mode") == "ema" else 0)
          if opts.get("use_kernel") else 0)
    return {"ring_agg": 0, "weighted_agg": k2}


def phase_mesh(device=DEVICE):
    """The distribution slice on the card.  World size 1 over NCCL:
    fleet-k1000 (30 rounds, flat) with ``make_host_mesh()`` and with a
    ``("data",)`` mesh of 1, bitwise the unsharded run, K1 = the plan's
    chains.  World size 2 over gloo, two spawned ranks on the one card:
    every ``MESH_RUNS`` run against its unsharded run on the card (traces
    exact, params within ``MESH_PARAM_ATOL``, K1/K2 = the plan's on every
    rank), ms/round beside the unsharded run's with the share in
    ``all_reduce``, and ``cross_pod_reconcile`` at tau 1 and 0.5 under
    ``use_kernel`` against the plain f32 reconcile.  Returns the phase's K1
    and K2 launches."""
    import pickle
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.core.hierarchical import ema_toward, reconcile_models
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    k1 = k2 = 0
    base = {}
    for tag, (engine, name, rounds, opts) in MESH_RUNS.items():
        mesh_run(engine, name, rounds, opts, None, device)     # warm-up
        base[tag] = mesh_digest(*mesh_run(engine, name, rounds, opts, None,
                                          device))
    # world size 1: one NCCL rank (gloo on the CPU) in this process
    fleet = MESH_RUNS["fleet-k1000"]
    rounds = fleet[2]
    want = base["fleet-k1000"]
    meshes = {"host (data 1, model 1)": make_host_mesh(device),
              "data 1": make_mesh((1,), ("data",), device)}
    try:
        # warm-up: NCCL builds its communicator at the first collective
        mesh_run(fleet[0], fleet[1], 4, fleet[3], meshes["data 1"], device)
        for label, mesh in meshes.items():
            got = mesh_digest(*mesh_run(*fleet, mesh, device))
            mesh_compare(f"fleet-k1000 {label}", got, want, bitwise=True)
            check(got["counts"]["ring_agg"] == want["counts"]["ring_agg"]
                  == expected_chains(fleet[1], rounds),
                  f"mesh: fleet-k1000 {label}: ring_agg "
                  f"{got['counts']['ring_agg']}")
            k1 += got["counts"]["ring_agg"]
            log(f"mesh: fleet-k1000 world 1 ({dist.get_backend()}) mesh "
                f"{label}: bitwise the unsharded run, "
                f"{got['seconds'] / rounds * 1e3:.3f} ms/round against "
                f"{want['seconds'] / rounds * 1e3:.3f} unsharded, ring_agg "
                f"launches {got['counts']['ring_agg']}")
    finally:
        dist.destroy_process_group()
    # world size 2: two ranks over gloo, each a process on this card
    store = Path(tempfile.mkdtemp()) / "store"
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(MESH_WORLD, str(store), device),
             nprocs=MESH_WORLD, join=True)
    log(f"mesh: {MESH_WORLD} ranks over gloo on one card: "
        f"{time.perf_counter() - t0:.1f} s from spawn to join")
    ranks = []
    for r in range(MESH_WORLD):
        with open(f"{store}.rank{r}", "rb") as f:
            ranks.append(pickle.load(f))
    for rank, out in enumerate(ranks):
        sums, bcast, where = out["collectives"]
        check(sums == [3.0] * 4 and bcast == [7.0] * 4,
              f"mesh: rank {rank}: gloo all_reduce {sums}, broadcast "
              f"{bcast} on {where}")
        for tag, (engine, name, rounds, opts) in MESH_RUNS.items():
            got, want_run = out[tag], base[tag]
            err = mesh_compare(f"{tag} rank {rank}", got, want_run,
                               bitwise=False)
            exp = mesh_expected(tag, rank)
            counts = {k: got["counts"][k] for k in exp}
            check(counts == exp, f"mesh: {tag} rank {rank}: launches "
                  f"{counts}, the plan's {exp}")
            k1 += counts["ring_agg"]
            k2 += counts["weighted_agg"]
            share = got["all_reduce_seconds"] / got["seconds"]
            log(f"mesh: {tag} {MESH_AXIS[engine]} {MESH_WORLD} rank {rank}: "
                f"{got['seconds'] / rounds * 1e3:.3f} ms/round against "
                f"{want_run['seconds'] / rounds * 1e3:.3f} unsharded; "
                f"all_reduce {got['all_reduce_calls']} calls, "
                f"{got['all_reduce_seconds']:.3f} s ({share:.4f} of the run);"
                f" params within {err:.3e}, launches {counts}; accuracy "
                f"{got['acc'][-1][1]:.5f} (unsharded "
                f"{want_run['acc'][-1][1]:.5f})")
    cohorts = mesh_cohorts(device)
    mean = reconcile_models(cohorts)
    for tau in (1.0, 0.5):
        for rank, out in enumerate(ranks):
            got, counts = out["pod", tau]
            want_pod = (mean if tau == 1.0
                        else ema_toward(cohorts[rank], mean, tau))
            err = max(float(np.abs(got[k] - v.cpu().numpy()).max())
                      for k, v in want_pod.items())
            check(err <= MESH_POD_ATOL,
                  f"mesh: cross_pod_reconcile tau {tau} rank {rank}: {err}")
            check(counts["weighted_agg"] == (tau != 1.0),
                  f"mesh: cross_pod_reconcile tau {tau}: weighted_agg "
                  f"{counts['weighted_agg']}")
            k2 += counts["weighted_agg"]
        log(f"mesh: cross_pod_reconcile over a (2,) 'pod' mesh, tau {tau}, "
            f"use_kernel: within {MESH_POD_ATOL} of the plain f32 "
            f"reconcile on both ranks")
    return k1, k2


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
        for G in DECODE_GROUPS:
            for hd in (64, 128):
                for B, S, Kv in ((SERVE_SLOTS, SERVE_MAX_SEQ, 5),
                                 (2, 1000, 2)):
                    q, k, v = attn_inputs((B, G * Kv, hd), (B, S, Kv, hd),
                                          dtype, gen, dev)
                    mixed = torch.randint(0, S, (B,), generator=gen,
                                          device=dev, dtype=torch.int32)
                    for pname, pos in (("0", 0), ("63", 63), ("64", 64),
                                       ("65", 65), ("S-1", S - 1),
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
        f"in {cases} cases (G in {DECODE_GROUPS}, hd in (64, 128), pos = "
        f"0, 63, 64, 65, S - 1 and a per-row vector, B/S/Kv = 8/2048/5 and "
        f"2/1000/2); "
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

        # a device vector, as the serve path passes it (an int would cost
        # a fill launch per call); bound now: the profiler reading runs
        # after the loop
        posv = torch.full((B,), pos, dtype=torch.int32, device=dev)

        def kernel(q, k, v, posv=posv):
            return ops.decode_attention(q, k, v, posv)

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
        n_chunks = ops.split(B, S, Kv)
        starts, stops = ops.chunk_bounds(pos, S, n_chunks)
        geometries[label] = attn_timings(
            f"decode_attention {label} G={G} hd={hd} pos=S-1",
            runs, f"{n_sets} input sets; {B * Kv * n_chunks} blocks, "
            f"{n_chunks} chunks a row, {int((stops > starts).sum())} live, "
            f"shares of {int(stops[0] - starts[0])} positions",
            bytes_moved, flops, peak,
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
    # f32 (CUDA cores): G 1 and 3; bf16 (tensor cores, kv tiles shared by
    # the G heads): G 1, 3 and 5, each shape at hd 64 and 128
    sweeps = {"f32": ((1, 3), ((1, 1024, 5, 64), (2, 200, 2, 128),
                               (1, 33, 1, 64))),
              "bf16": ((1, 3, 5), tuple((B, S, Kv, hd) for hd in (64, 128)
                                        for B, S, Kv in ((1, 1024, 5),
                                                         (2, 200, 2),
                                                         (1, 33, 1))))}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Gs, shapes = sweeps[tag]
        for G in Gs:
            for B, S, Kv, hd in shapes:
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
        f"{cases} cases (f32: G in (1, 3), B/S/Kv/hd = 1/1024/5/64, "
        f"2/200/2/128, 1/33/1/64; bf16: G in (1, 3, 5), B/S/Kv = 1/1024/5, "
        f"2/200/2, 1/33/1 at hd 64 and 128; window S, 64, 45, 1, 10 S); "
        f"max_abs_err f32 "
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

        # ``S`` bound now: the profiler reading runs after the loop
        def kernel(q, k, v, S=S):
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
                          rotating(kernel, sets),
                          ("swa_kernel", "swa_mma_kernel"))
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


def serve_run(cfg, model, prompts, stats=None, max_new=SERVE_NEW):
    """One drained ``BatchedServer`` run; returns (requests, ticks,
    seconds).  With ``stats``, prefill and decode-step times land in it."""
    import torch
    from repro_torch.serving import BatchedServer
    srv = BatchedServer(cfg, model, n_slots=SERVE_SLOTS,
                        max_seq=SERVE_MAX_SEQ)
    if stats is not None:
        srv._prefill = timed(srv._prefill, stats["prefill_ms"])
        srv._step = timed(srv._step, stats["tick_ms"])
    reqs = [srv.submit(p, max_new) for p in prompts]
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
                  lambda: serve_run(cfg, model, prompts))
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


# The dense archs (phase_archs).  mistral-nemo-12b's sliding-window variant
# (window 4096) at full width, bf16 weights and caches (f32 weights are
# 49.0 GB), through the serve path (``launch/serve.py:generate``, scalar
# positions): three batches of 2 prompts, under the window (the ring
# padded), just under it (the ring wraps during decode) and twice it (K5
# with window 4096 < S, the ring rolled), 64 new tokens each.  Then, in
# f32: qwen1.5-4b (QKV biases, G 1) behind the serve phase's
# BatchedServer and requests, internvl2-2b (G 2) through the serve path
# with the vision stub's 256 patch embeddings before 512 text tokens, and
# musicgen-large (G 1, hd 64) behind a BatchedServer on the audio stub's
# codes.  Each model is freed before the next.
ARCH_SWA_WINDOW, ARCH_SWA_B, ARCH_SWA_NEW = 4096, 2, 64
ARCH_SWA_PROMPTS = (1024, 4064, 8192)
ARCH_VISION_B, ARCH_VISION_TEXT, ARCH_VISION_NEW = 4, 512, 32
ARCH_AUDIO_REQUESTS, ARCH_AUDIO_NEW = 8, 32
# card against CPU: the reduced configs of the five archs, the swa variant
# (window 64) and a [chunk 64, global] variant (two periods), prompts of 80
# tokens (past the window; 80 % 64 = 16, so the ring is rolled), 16
# teacher-forced steps, within SERVE_CPU_TOL
ARCH_CPU_PROMPT, ARCH_CPU_STEPS = 80, 16
# K5 against its plain version at mistral-nemo-12b's heads, B 1 and S 4608
# (the plain version's [S, S] scores fit): window 4096 < S and the chunk
# reshape (chunks of 4096, the second padded); K4 over a ring of 4096 at
# B 2, Kv 8, hd 128 before, at and past the wrap
ARCH_K5_CHECK = (1, 4608, 32, 8, 128)          # B, S, H, Kv, hd
ARCH_K4_RING = (2, 4096, 8, 128)               # B, W, Kv, hd
ARCH_K4_GROUPS = (1, 2, 4)
ARCH_K4_POSITIONS = (5, 4095, 4096, 4100, 3 * 4096 + 7)
# timed: K5 at mistral's prefill (B 2, S 8192, window 4096, bf16) beside
# the same call at window S and SDPA with a bool sliding-window mask; K4
# over the bf16 ring (B 2, W 4096, pos W - 1) beside SDPA
ARCH_K5_TIMED = (2, 8192, 32, 8, 128)
ARCH_K5_TIMED_LABEL = "mistral prefill B=2 S=8192 W=4096 bf16"
ARCH_K4_TIMED_LABEL = "mistral swa ring B=2 W=4096 bf16"


def arch_cpu_configs():
    """The configs held card against CPU at reduced size."""
    from repro_torch.configs import get_config
    from repro_torch.configs.mistral_nemo_12b import sliding_window_variant
    cfgs = {n: get_config(n).reduced() for n in (
        "mistral-nemo-12b", "qwen1.5-4b", "internvl2-2b", "musicgen-large",
        "llama3-405b")}
    cfgs["mistral-nemo-12b swa 64"] = sliding_window_variant().reduced()
    cfgs["mistral-nemo-12b [chunk 64, global]"] = get_config(
        "mistral-nemo-12b").reduced().variant(
            attn_chunk=64, global_attn_every=2, scan_period=2, n_layers=4)
    return cfgs


def free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def arch_counts(tag, counts, k5, k4):
    """The launches of one counted run: K5 and K4 as stated, no other
    kernel."""
    check(counts["swa_attention"] == k5 and counts["decode_attention"] == k4
          and counts["weighted_agg"] == counts["ring_agg"]
          == counts["cross_entropy"] == 0,
          f"archs: {tag}: launches {counts}, want swa_attention {k5}, "
          f"decode_attention {k4}")


def archs_swa(dev):
    """mistral-nemo-12b's sliding-window variant at full width in bf16;
    returns (K4, K5) launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.mistral_nemo_12b import sliding_window_variant
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    cfg = sliding_window_variant(ARCH_SWA_WINDOW)
    W = cfg.sliding_window
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    log(f"archs: {cfg.name} sliding_window_variant({W}): {cfg.n_layers} "
        f"layers d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd {cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}"
        f": {T.param_count(cfg)} bf16 parameters "
        f"({(torch.cuda.memory_allocated(dev) - base) / 1e9:.3f} GB), torch "
        f"init on the card {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(1)

    def batch(P):
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (ARCH_SWA_B, P)).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    generate(cfg, model, batch(128), 4)          # warm-up, not counted
    log(f"archs:   warm-up (B {ARCH_SWA_B}, 128 tokens, 3 steps) "
        f"{time.perf_counter() - t0:.3f} s")
    steps = ARCH_SWA_NEW - 1
    k4 = k5 = 0
    for P in ARCH_SWA_PROMPTS:
        prompts = batch(P)
        torch.cuda.synchronize()
        kernels.reset_launches()
        toks, prefill_s, decode_s = generate(cfg, model, prompts,
                                             ARCH_SWA_NEW)
        counts = kernels.launch_counts()
        arch_counts(f"{cfg.name} swa P={P}", counts, cfg.n_layers,
                    cfg.n_layers * steps)
        k4 += counts["decode_attention"]
        k5 += counts["swa_attention"]
        out = toks.cpu().numpy()
        check(out.shape == (ARCH_SWA_B, ARCH_SWA_NEW) and (out >= 0).all()
              and (out < cfg.vocab_size).all(),
              f"archs: {cfg.name} P={P} tokens {out}")
        last = P + steps - 1                     # the last decode position
        ring = ("S < W: the ring padded, never full" if last < W else
                "the ring wraps during decode" if P < W else
                f"K5 window {W} < S, the ring rolled by S % W = {P % W}")
        log(f"archs: {cfg.name} swa {W}, B {ARCH_SWA_B} x {P} prompt "
            f"tokens, {ARCH_SWA_NEW} new ({ring}): prefill "
            f"{prefill_s * 1e3:.3f} ms, decode {decode_s / steps * 1e3:.3f} "
            f"ms per tick over {steps} ticks, "
            f"{ARCH_SWA_B * ARCH_SWA_NEW / (prefill_s + decode_s):.1f} "
            f"tokens/s ({ARCH_SWA_B * steps / decode_s:.1f} decoding); "
            f"launches swa_attention {counts['swa_attention']} = "
            f"{cfg.n_layers} x 1 prefill, decode_attention "
            f"{counts['decode_attention']} = {cfg.n_layers} x {steps}")
    logits, _ = T.prefill(cfg, model, prompts[:, :64])
    check(bool(torch.isfinite(logits).all()),
          f"archs: {cfg.name}: non-finite logits at full width")
    log(f"archs: {cfg.name} swa: peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} "
        f"GB allocated (max_memory_allocated, earlier phases' "
        f"{base / 1e9:.3f} GB included)")
    del model, logits, toks, prompts
    free_card()
    return k4, k5


def archs_server(dev, name, prompts, max_new):
    """``name`` at full width in f32 behind the serve phase's BatchedServer
    (8 slots of 2048); returns (K4, K5) launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(name)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    log(f"archs: {name}: {cfg.n_layers} layers d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.resolved_head_dim} vocab "
        f"{cfg.vocab_size}, qkv_bias {cfg.qkv_bias}, frontend "
        f"{cfg.frontend}: {T.param_count(cfg)} f32 parameters, init "
        f"{time.perf_counter() - t0:.3f} s")
    serve_run(cfg, model, prompts[:2], max_new=4)   # warm-up, not counted
    stats = {"prefill_ms": [], "tick_ms": []}
    kernels.reset_launches()
    reqs, ticks, wall = serve_run(cfg, model, prompts, stats, max_new)
    counts = kernels.launch_counts()
    arch_counts(f"{name} BatchedServer", counts,
                cfg.n_layers * len(prompts), cfg.n_layers * ticks)
    for r in reqs:
        check(r.done and len(r.out) == max_new
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"archs: {name} request {r.rid} out {r.out}")
    lengths = [len(p) for p in prompts]
    log(f"archs: {name}: {len(prompts)} requests (prompts {min(lengths)}-"
        f"{max(lengths)} tokens, {max_new} new each) over {SERVE_SLOTS} "
        f"slots of {SERVE_MAX_SEQ}: {ticks} ticks in {wall:.3f} s, "
        f"{len(prompts) * max_new / wall:.1f} tokens/s; prefill ms per "
        f"request mean {np.mean(stats['prefill_ms']):.3f}, decode ms per "
        f"tick mean {np.mean(stats['tick_ms']):.3f} (median "
        f"{np.median(stats['tick_ms']):.3f}); launches swa_attention "
        f"{counts['swa_attention']} = {cfg.n_layers} x {len(prompts)} "
        f"admits, decode_attention {counts['decode_attention']} = "
        f"{cfg.n_layers} x {ticks} ticks; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB allocated "
        f"({base / 1e9:.3f} GB before)")
    del model, reqs
    free_card()
    return counts["decode_attention"], counts["swa_attention"]


def archs_vision(dev):
    """internvl2-2b at full width in f32 through the serve path with the
    vision stub; returns (K4, K5) launches."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import VisionFrontendStub

    cfg = get_config("internvl2-2b")
    torch.cuda.reset_peak_memory_stats(dev)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    stub = VisionFrontendStub(cfg)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (ARCH_VISION_B, ARCH_VISION_TEXT)).astype(
            np.int32)).to(dev)
    generate(cfg, model, prompts[:, :64], 4, stub(gen, ARCH_VISION_B))
    fe = stub(gen, ARCH_VISION_B)
    torch.cuda.synchronize()
    kernels.reset_launches()
    toks, prefill_s, decode_s = generate(cfg, model, prompts,
                                         ARCH_VISION_NEW, fe)
    counts = kernels.launch_counts()
    steps = ARCH_VISION_NEW - 1
    arch_counts(f"{cfg.name} serve", counts, cfg.n_layers,
                cfg.n_layers * steps)
    out = toks.cpu().numpy()
    check(out.shape == (ARCH_VISION_B, ARCH_VISION_NEW) and (out >= 0).all()
          and (out < cfg.vocab_size).all(), f"archs: {cfg.name} {out}")
    log(f"archs: {cfg.name}: {T.param_count(cfg)} f32 parameters, B "
        f"{ARCH_VISION_B} x ({cfg.n_frontend_tokens} patch embeddings + "
        f"{ARCH_VISION_TEXT} text tokens), {ARCH_VISION_NEW} new: prefill "
        f"{prefill_s * 1e3:.3f} ms, decode {decode_s / steps * 1e3:.3f} ms "
        f"per tick, {ARCH_VISION_B * ARCH_VISION_NEW / (prefill_s + decode_s):.1f} "
        f"tokens/s; launches swa_attention {counts['swa_attention']}, "
        f"decode_attention {counts['decode_attention']} = {cfg.n_layers} x "
        f"{steps}; peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    del model, toks, fe
    free_card()
    return counts["decode_attention"], counts["swa_attention"]


# the bf16 checks at mistral's shapes: a row attends over up to 4,096 keys,
# so its output is about 0.02 in size where a fixed bar would be as large as
# the values.  The bar scales with each output row (hd values): |out - want|
# <= row_rms * rms(row of want) + rtol * |want|, want being the plain
# version computed in f32 on the same bf16 inputs and rounded to bf16.
# rtol covers a bf16 ulp of either rounding; row_rms the kernel's bf16
# softmax weights.  A key too many or too few at the window edge, or a ring
# slot off by one, is read against the same bar and logged beside it.
ARCH_BF16_TOL = {"row_rms": 2e-2, "rtol": 1.6e-2}


def scaled_err(out, want):
    """max |out - want| / bar, the bar of ``ARCH_BF16_TOL``: at most 1
    passes."""
    import torch
    torch.cuda.synchronize()
    want = want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    bar = ARCH_BF16_TOL["row_rms"] * rms + ARCH_BF16_TOL["rtol"] * want.abs()
    return ((out.float() - want).abs() / bar).max().item()


def bf16_check(name, out, want, where):
    """``scaled_err`` of a bf16 kernel output, checked to be at most 1."""
    check(out.shape == want.shape and out.dtype == want.dtype,
          f"{name} shape/dtype at {where}")
    e = scaled_err(out, want)
    check(e <= 1.0, f"{name} differs from its plain version by {e} of the "
          f"bar {ARCH_BF16_TOL} at {where}")
    return e


def archs_kernel_checks(dev):
    """K5 (windowed, chunk reshape) and K4 (rings at the wrap) against
    their plain versions at the new shapes: f32 to ``ATTN_TOL``, bf16 to
    the scaled bar of ``ARCH_BF16_TOL``, with a planted one-key error read
    against the same bar.  Returns the readings."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.models import attention as A

    def f32(*ts):
        return [t.float() for t in ts]

    gen = torch.Generator(device=dev).manual_seed(6)
    err = {"f32": 0.0, "bf16_k5": 0.0, "bf16_k4": 0.0,
           "planted_k5": [], "planted_k4": []}
    kernels.reset_launches()
    B, S, H, Kv, hd = ARCH_K5_CHECK
    W = ARCH_SWA_WINDOW
    pos = torch.arange(S, device=dev)
    chunk_bias = A._causal_bias(pos, pos, "chunk", W)
    q, k, v = attn_inputs((B, S, H, hd), (B, S, Kv, hd), torch.float32,
                          gen, dev)
    where = f"window {W} < S {S} f32"
    err["f32"] = max(
        attn_check("swa_attention", sops.swa_attention(q, k, v, W),
                   sref.swa_attention(q, k, v, W), "f32", where),
        attn_check("swa_attention (chunk reshape)",
                   A._prefill_attention(q, k, v, "chunk", W),
                   A._sdpa(q, k, v, chunk_bias), "f32",
                   f"chunks of {W}, S {S} f32"))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    want = sref.swa_attention(*f32(q, k, v), W).to(torch.bfloat16)
    err["bf16_k5"] = bf16_check("swa_attention",
                                sops.swa_attention(q, k, v, W), want,
                                f"window {W} < S {S} bf16")
    # planted: one key more at the window's edge on every row past it
    err["planted_k5"].append(scaled_err(sops.swa_attention(q, k, v, W + 1),
                                        want))
    del want
    want = A._sdpa(*f32(q, k, v), chunk_bias).to(torch.bfloat16)
    err["bf16_k5"] = max(err["bf16_k5"], bf16_check(
        "swa_attention (chunk reshape)",
        A._prefill_attention(q, k, v, "chunk", W), want,
        f"chunks of {W}, S {S} bf16"))
    del q, k, v, want, chunk_bias
    k5_calls = kernels.launch_counts()["swa_attention"]
    check(k5_calls == 5, f"archs: swa_attention launched {k5_calls} for 5")
    check(min(err["planted_k5"]) > 1.0,
          f"archs: a one-key window error reads {err['planted_k5']} of the "
          f"bf16 bar, which does not see it")
    B, W, Kv, hd = ARCH_K4_RING
    calls = 0
    idx = torch.arange(W, device=dev)
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for G in ARCH_K4_GROUPS:
            q, k, v = attn_inputs((B, 1, G * Kv, hd), (B, W, Kv, hd), dtype,
                                  gen, dev)
            for kind in ("swa", "chunk"):
                for p in ARCH_K4_POSITIONS:
                    pt = torch.tensor(p, dtype=torch.int32, device=dev)
                    live = pt.clamp(max=W - 1) if kind == "swa" else pt % W
                    out = dops.decode_attention(q[:, 0], k, v, live)
                    calls += 1
                    ok = (p - (p % W - idx) % W >= 0 if kind == "swa"
                          else idx <= p % W)
                    bias = torch.where(ok, 0.0, -1e30).reshape(1, 1, 1, W)
                    where = f"{kind} W {W} G {G} pos {p} {tag}"
                    if tag == "f32":
                        err["f32"] = max(
                            err["f32"],
                            attn_check("decode_attention (ring)", out,
                                       dref.decode_attention(q[:, 0], k, v,
                                                             live),
                                       tag, where),
                            attn_check("decode_attention (ring bias)", out,
                                       A._sdpa(q, k, v, bias)[:, 0], tag,
                                       where))
                        continue
                    want = dref.decode_attention(
                        *f32(q[:, 0], k, v), live).to(dtype)
                    err["bf16_k4"] = max(
                        err["bf16_k4"],
                        bf16_check("decode_attention (ring)", out, want,
                                   where),
                        bf16_check("decode_attention (ring bias)", out,
                                   A._sdpa(*f32(q, k, v), bias)[:, 0].to(
                                       dtype), where))
                    # planted: pos' one slot off (one more, or one fewer
                    # where the ring is full)
                    at = min(p, W - 1) if kind == "swa" else p % W
                    off = torch.tensor(at + 1 if at < W - 1 else at - 1,
                                       dtype=torch.int32, device=dev)
                    err["planted_k4"].append(scaled_err(
                        dops.decode_attention(q[:, 0], k, v, off), want))
                    calls += 1
    k4_calls = kernels.launch_counts()["decode_attention"]
    check(k4_calls == calls,
          f"archs: decode_attention launched {k4_calls} for {calls}")
    log(f"archs: swa_attention at H {H} Kv {Kv} hd {hd}, B 1 S {S}: window "
        f"{ARCH_SWA_WINDOW} < S and chunks of {ARCH_SWA_WINDOW} (2 rows, the "
        f"second padded), f32 and bf16 ({k5_calls} launches); "
        f"decode_attention over a ring of {W} (B {B}, Kv {Kv}, hd {hd}) at G "
        f"{ARCH_K4_GROUPS}, pos {ARCH_K4_POSITIONS}, swa (pos' = min(pos, W "
        f"- 1)) and chunk (pos' = pos % W), against its plain version and "
        f"repro's ring bias ({k4_calls} launches): max_abs_err f32 "
        f"{err['f32']} (tol {ATTN_TOL['f32']}); bf16 against the plain "
        f"version in f32, max |diff| / bar ({ARCH_BF16_TOL}): "
        f"swa_attention {err['bf16_k5']}, decode_attention "
        f"{err['bf16_k4']}; planted one-key errors read: window W + 1 "
        f"{err['planted_k5']}, pos' one slot off min "
        f"{min(err['planted_k4'])} max {max(err['planted_k4'])} over "
        f"{len(err['planted_k4'])} ring cases {err['planted_k4']}")
    free_card()
    return err


def archs_vs_cpu(dev):
    """The reduced configs card against CPU, one CPU init (QKV biases set
    non-zero): prefill past the window and teacher-forced decode steps."""
    import copy

    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import VisionFrontendStub

    worst = {}
    for label, cfg in arch_cpu_configs().items():
        cpu = T.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        bias_gen = torch.Generator().manual_seed(1)
        for name, p in cpu.named_parameters():
            if name.endswith(("mixer.bq", "mixer.bk", "mixer.bv")):
                p.copy_(torch.randn(p.shape, generator=bias_gen) * 0.1)
        gpu = copy.deepcopy(cpu).to(dev)
        prompt = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, ARCH_CPU_PROMPT)).astype(np.int64))
        fe = None
        if cfg.frontend == "vision":
            fe = VisionFrontendStub(cfg)(torch.Generator().manual_seed(4), 2)
        start = ARCH_CPU_PROMPT + (cfg.n_frontend_tokens if fe is not None
                                   else 0)
        lc, cc = T.prefill(cfg, cpu, prompt, fe)
        lg, cg = T.prefill(cfg, gpu, prompt.to(dev),
                           None if fe is None else fe.to(dev))
        diffs = [(lg.cpu() - lc).abs().max().item()]
        check(torch.allclose(lg.cpu(), lc, **SERVE_CPU_TOL),
              f"archs vs CPU: {label} prefill logits differ by {diffs[0]}")
        cc = T.grow_cache(cfg, cc, 2, start + ARCH_CPU_STEPS)
        cg = T.grow_cache(cfg, cg, 2, start + ARCH_CPU_STEPS)
        forced = torch.argmax(lc[:, -1:], -1)
        for i in range(ARCH_CPU_STEPS):
            lc, cc = T.decode_step(cfg, cpu, forced, cc, start + i)
            lg, cg = T.decode_step(cfg, gpu, forced.to(dev), cg, start + i)
            diffs.append((lg.cpu() - lc).abs().max().item())
            check(torch.allclose(lg.cpu(), lc, **SERVE_CPU_TOL),
                  f"archs vs CPU: {label} step {i} differs by {diffs[-1]}")
            forced = torch.argmax(lc, -1)
        cache_diff = max((a.cpu() - b).abs().max().item()
                         for sub_g, sub_c in zip(cg["stack"].values(),
                                                 cc["stack"].values())
                         for a, b in zip(sub_g["mixer"].values(),
                                         sub_c["mixer"].values()))
        worst[label] = max(diffs)
        log(f"archs vs CPU: {label} (window {cfg.sliding_window}, chunk "
            f"{cfg.attn_chunk}, qkv_bias {cfg.qkv_bias}, frontend "
            f"{cfg.frontend}): prefill of {ARCH_CPU_PROMPT} tokens + "
            f"{ARCH_CPU_STEPS} teacher-forced steps, logits max |diff| "
            f"{max(diffs)}, cache max |diff| {cache_diff} (atol "
            f"{SERVE_CPU_TOL['atol']}, rtol {SERVE_CPU_TOL['rtol']})")
    return worst


def archs_timings(dev):
    """K5 at mistral's windowed prefill and K4 over its ring, each beside
    its plain version and SDPA, in turns; returns ({label: K5 row},
    {label: K4 row})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref

    gen = torch.Generator(device=dev).manual_seed(8)
    B, S, H, Kv, hd = ARCH_K5_TIMED
    W = ARCH_SWA_WINDOW
    G = H // Kv
    dt = torch.bfloat16

    def pairs(w):                     # (query, key) pairs a window admits
        w = min(w, S)
        return w * (w + 1) // 2 + (S - w) * w
    bytes_moved = (2 * B * S * H * hd + 2 * B * S * Kv * hd) * 2
    flops = {w: 4 * B * H * pairs(w) * hd for w in (W, S)}
    n_sets = max(1, int(np.ceil(2 * L2_BYTES / bytes_moved)))
    sets = [attn_inputs((B, S, H, hd), (B, S, Kv, hd), dt, gen, dev)
            for _ in range(n_sets)]
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)

    def kernel(q, k, v):
        return sops.swa_attention(q, k, v, W)

    def kernel_full(q, k, v):
        return sops.swa_attention(q, k, v, S)

    def plain(q, k, v):
        return sref.swa_attention(q, k, v, W)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)
    attn_check("SDPA yardstick", sdpa(*sets[0]), kernel(*sets[0]), "bf16",
               ARCH_K5_TIMED_LABEL)
    runs = {"kernel": rotating(kernel, sets),
            "kernel_full": rotating(kernel_full, sets),
            "plain": rotating(plain, sets), "library": rotating(sdpa, sets)}
    ms, samples = in_turns(runs, reps=4, iters=10, warmup=2)
    bound = {w: max(bytes_moved / HBM_BYTES_PER_S,
                    flops[w] / BF16_FLOP_PER_S) * 1e3 for w in (W, S)}
    log(f"kernels: swa_attention {ARCH_K5_TIMED_LABEL} (B {B}, H {H}, Kv "
        f"{Kv}, G {G}, hd {hd}; {n_sets} input sets, {bytes_moved} bytes; "
        f"{pairs(W)} key pairs a head at W {W}, {pairs(S)} at W = S): "
        f"kernel {ms['kernel']:.6f} ms (bound {bound[W]:.6f}, operations), "
        f"window S {ms['kernel_full']:.6f} ms (bound {bound[S]:.6f}); "
        f"windowed / full {ms['kernel'] / ms['kernel_full']:.4f} (bounds "
        f"{bound[W] / bound[S]:.4f}); plain {ms['plain']:.6f} ms, SDPA with "
        f"a bool window mask {ms['library']:.6f} ms; samples {samples}")
    k5_row = {"ms": ms["kernel"], "plain_ms": ms["plain"],
              "bound_ms": bound[W],
              "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                           >= flops[W] / BF16_FLOP_PER_S else "operations"),
              "library_ms": ms["library"], "window_S_ms": ms["kernel_full"],
              "window_S_bound_ms": bound[S]}
    # one launch a call: the time per recorded event stays a reading when
    # the profiler keeps fewer events than calls
    device_time_later(f"swa_attention {ARCH_K5_TIMED_LABEL}", k5_row,
                      rotating(kernel, sets),
                      ("swa_kernel", "swa_mma_kernel"), iters=20,
                      per_event=True)
    del sets, mask

    B, W, Kv, hd = ARCH_K4_RING
    G = 4
    H = G * Kv
    pos = W - 1
    bytes_moved = (2 * B * W * Kv * hd + 2 * B * H * hd) * 2
    flops = 4 * B * H * W * hd
    n_sets = max(1, int(np.ceil(2 * L2_BYTES / bytes_moved)))
    sets = [attn_inputs((B, H, hd), (B, W, Kv, hd), dt, gen, dev)
            for _ in range(n_sets)]
    posv = torch.full((B,), pos, dtype=torch.int32, device=dev)
    rmask = torch.ones(B, 1, 1, W, dtype=torch.bool, device=dev)

    def k4(q, k, v, posv=posv):
        return dops.decode_attention(q, k, v, posv)

    def k4_plain(q, k, v):
        return dref.decode_attention(q, k, v, pos)

    def k4_sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=rmask, enable_gqa=True)[:, :, 0]
    attn_check("SDPA yardstick", k4_sdpa(*sets[0]), k4(*sets[0]), "bf16",
               ARCH_K4_TIMED_LABEL)
    n_chunks = dops.split(B, W, Kv)
    k4_row = attn_timings(
        f"decode_attention {ARCH_K4_TIMED_LABEL} G={G} hd={hd} pos=W-1",
        {"kernel": rotating(k4, sets), "plain": rotating(k4_plain, sets),
         "library": rotating(k4_sdpa, sets)},
        f"{n_sets} input sets; {B * Kv * n_chunks} blocks, {n_chunks} "
        f"chunks a row", bytes_moved, flops, BF16_FLOP_PER_S, 6, 100, 10)
    device_time_later(f"decode_attention {ARCH_K4_TIMED_LABEL}", k4_row,
                      rotating(k4, sets),
                      ("decode_chunk_kernel", "decode_combine_kernel"))
    return {ARCH_K5_TIMED_LABEL: k5_row}, {ARCH_K4_TIMED_LABEL: k4_row}


def phase_archs(dev):
    """The dense archs on the card (mistral-nemo-12b's sliding-window
    variant in bf16, qwen1.5-4b, internvl2-2b and musicgen-large in f32,
    each at full width), then K4/K5 at their new shapes, card against CPU
    on the reduced configs, and the timings (llama3-405b runs in
    ``phase_llama3``).  Returns ({path: K4 launches}, {path: K5 launches},
    K5 rows, K4 rows)."""
    from repro_torch.configs import get_config
    from repro_torch.models.frontends import AudioFrontendStub
    import torch

    k4, k5 = {}, {}
    k4["mistral-nemo-12b swa"], k5["mistral-nemo-12b swa"] = archs_swa(dev)
    mark("archs: mistral-nemo-12b swa")
    qwen = get_config("qwen1.5-4b")
    k4["qwen1.5-4b"], k5["qwen1.5-4b"] = archs_server(
        dev, qwen.name, serve_prompts(qwen.vocab_size), SERVE_NEW)
    k4["internvl2-2b"], k5["internvl2-2b"] = archs_vision(dev)
    music = get_config("musicgen-large")
    stub = AudioFrontendStub(music)
    gen = torch.Generator().manual_seed(3)
    codes = [stub(gen, 1, len(p))[0].numpy()
             for p in serve_prompts(2)[:ARCH_AUDIO_REQUESTS]]
    k4["musicgen-large"], k5["musicgen-large"] = archs_server(
        dev, music.name, codes, ARCH_AUDIO_NEW)
    mark("archs: qwen1.5-4b, internvl2-2b, musicgen-large")
    archs_kernel_checks(dev)
    archs_vs_cpu(dev)
    mark("archs: kernel checks, card against CPU")
    k5_rows, k4_rows = archs_timings(dev)
    free_card()
    return k4, k5, k5_rows, k4_rows


# MoE + MLA (phase_moe, after phase_archs), random weights from a seed,
# each model freed in turn: deepseek-v2-lite-16b at full size in bf16 (27
# layers, MLA latent 512, 64 routed + 2 shared experts top-6, the first
# layer dense) through generate (B 2, prompts of 1,024, 64 new) with naive
# and then absorbed MLA decode, then behind the serve phase's BatchedServer;
# llama4-scout-17b-a16e at full width over one period (3 chunked layers and
# a global one; the whole model is 215.5 GB of bf16 and does not fit one
# card) through generate (B 1, a 10,240-token prompt: chunks of 8,192 as K5
# rows, 32 new); the 5-layer deepseek (the dense prefix and 4 MoE periods)
# trained in f32 at B 4, S 512 under each checkpoint policy;
# repro_torch.optim on smollm-360m's param dict; card against CPU on the
# reduced configs.  MLA's attention is torch products (its q/k head of 192
# against v's 128 and the absorbed form's 16 query heads over one latent key
# are outside K5 and K4), so deepseek launches no K4/K5.
MOE_GEN_B, MOE_GEN_P, MOE_GEN_NEW = 2, 1024, 64
# naive against absorbed decode logits, teacher-forced from one prefill
MOE_ABSORB_STEPS = 8
SCOUT_LAYERS, SCOUT_B, SCOUT_P, SCOUT_NEW = 4, 1, 10240, 32
# naive and absorbed MLA decode in bf16 on identical inputs, at full width,
# every MLA layer of deepseek: its MLA prefilled on random hidden states of
# B 2 x 1,025 (the cache one zero row longer), then one decode step at the
# scalar position 1,024 and at the [B] positions (1,024, 1,017), each form
# against the naive form in f32 on the same bf16 numbers and the two against
# each other.  The output is wo's sum of 2,048 bf16 products: its error
# against f32 is about 0.6% of the row's rms on either form (a CPU run at
# full width), so the largest of 27 layers x 4,096 values reaches the tail
# of ARCH_BF16_TOL's per-element bar (1.17 in that run).  Each output row's
# rms error is held to ARCH_BF16_TOL's row_rms of that row's rms, the
# per-element reading logged.  Planted: the step one position late (the
# prefilled row at 1,024 attended as one key more, the rotation one off)
MLA_CHECK_B, MLA_CHECK_P, MLA_CHECK_BACK = 2, 1024, 7
# K5 and K4 against their plain versions at scout's shapes (B 1, H 40, Kv
# 8, hd 128: G 5, bf16), those its generate launches: K5 through the chunk
# reshape (10,240 tokens as 2 rows of 8,192) and over the global layer's
# whole prompt, K4 over the chunk ring of 8,192 (pos' = pos % C: full, just
# wrapped, and at the generate's first and last steps) and over the global
# layer's full cache of 10,272 (its first step and its last slot).  The
# plain versions run in f32 one block of query rows at a time (the dense
# [H, S, S] scores of 10,240 tokens would take 17 GB).
SCOUT_K4_CHUNK_POSITIONS = (8191, 8192, 10240, 10270)
SCOUT_K4_FULL_POSITIONS = (10240, 10271)
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_TIMED = 5, 4, 512, 2
MOE_POLICIES = (("full", {}), ("dots", {"remat_policy": "dots"}),
                ("dots_nb", {"remat_policy": "dots_nb"}),
                ("remat_sublayer", {"remat_sublayer": True}),
                ("no_remat", {"no_remat": True}))
# the policies run the same forward and backward: only the order of a sum
# (index_add's atomics) may differ
MOE_POLICY_LOSS_RTOL = 1e-5
# card against CPU, both sides f32 (reduced configs, optimizer steps)
MOE_CPU_TOL = dict(atol=1e-5, rtol=1e-5)
OPTIM_STEPS, OPTIM_TOL = 3, dict(rtol=1e-6, atol=1e-7)


def moe_model(cfg, dev, dtype, tag, phase="moe", desc=None):
    """``cfg`` initialised on the card from a seed, logged under ``phase``
    with ``desc`` (by default the MoE layout) and the card; returns (model,
    allocated before it)."""
    import torch
    from repro_torch.models import transformer as T
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=dtype, device=dev)
    torch.cuda.synchronize()
    if desc is None:
        desc = (f"{cfg.n_layers} layers (first_k_dense {cfg.first_k_dense})"
                f" d_model {cfg.d_model} heads {cfg.n_heads}/"
                f"{cfg.n_kv_heads} mla {cfg.use_mla} (latent "
                f"{cfg.kv_lora_rank}) experts {cfg.n_routed_experts} + "
                f"{cfg.n_shared_experts} shared top-{cfg.moe_top_k} d_ff "
                f"{cfg.moe_d_ff} vocab {cfg.vocab_size}, "
                f"{T.param_count(cfg, active_only=True)} parameters active")
    log(f"{phase}: {tag}: {desc}: {T.param_count(cfg)} parameters, "
        f"{(torch.cuda.memory_allocated(dev) - base) / 1e9:.3f} GB "
        f"{str(dtype).removeprefix('torch.')}, init "
        f"{time.perf_counter() - t0:.3f} s; card {card_line()}")
    return model, base


def peak_log(dev, phase, tag, base):
    """The peak allocated since the last reset, beside ``base`` (what
    earlier phases hold) and the card."""
    import torch
    log(f"{phase}: {tag}: peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB allocated "
        f"({base / 1e9:.3f} GB of earlier phases); card {card_line()}")


def moe_generate(cfg, model, prompts, new, tag, k5, k4, phase="moe"):
    """One counted ``generate``, logged under ``phase``; returns (tokens,
    the launch counts, ms per decode tick)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve import generate
    torch.cuda.synchronize()
    kernels.reset_launches()
    toks, prefill_s, decode_s = generate(cfg, model, prompts, new)
    counts = kernels.launch_counts()
    arch_counts(tag, counts, k5, k4)
    out = toks.cpu().numpy()
    B, P = prompts.shape
    check(out.shape == (B, new) and (out >= 0).all()
          and (out < cfg.vocab_size).all(), f"{phase}: {tag} tokens {out}")
    steps = new - 1
    log(f"{phase}: {tag}: B {B} x {P} prompt tokens, {new} new: prefill "
        f"{prefill_s * 1e3:.3f} ms, decode {decode_s / steps * 1e3:.3f} ms "
        f"per tick over {steps} ticks, {B * new / (prefill_s + decode_s):.1f}"
        f" tokens/s ({B * steps / decode_s:.1f} decoding); launches "
        f"swa_attention {counts['swa_attention']}, decode_attention "
        f"{counts['decode_attention']}")
    return toks, counts, decode_s / steps * 1e3


def moe_absorb_check(cfg, model, prompts, forced, hold):
    """Naive against absorbed MLA decode logits, teacher-forced on
    ``forced`` from one prefill: the largest |diff| over the bar of
    ``ARCH_BF16_TOL``, checked to be at most 1 where ``hold``."""
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    steps = min(MOE_ABSORB_STEPS, forced.shape[1])
    logits, cache = T.prefill(cfg, model, prompts)
    del logits
    runs = []
    for absorb in (False, True):
        c = T.grow_cache(cfg, cache, B, P + steps,
                         model.embed.table.dtype)   # a grown copy
        cfg_a = cfg.variant(mla_absorb=absorb)
        runs.append([T.decode_step(cfg_a, model, forced[:, i:i + 1], c,
                                   P + i)[0] for i in range(steps)])
    errs = [scaled_err(a, n) for n, a in zip(*runs)]
    e = max(errs)
    dtype = str(model.embed.table.dtype).removeprefix("torch.")
    if hold:
        check(e <= 1.0, f"moe: absorbed MLA decode logits ({dtype}) differ "
              f"from naive by {e} of the bar {ARCH_BF16_TOL}")
    diff = max((a.float() - n.float()).abs().max().item()
               for n, a in zip(*runs))
    log(f"moe: naive vs absorbed MLA decode, {dtype}, {cfg.n_layers} "
        f"layers, {steps} teacher-forced steps from one prefill of B {B} x "
        f"{P}: logits max |diff| {diff}, max |diff| / bar {e} (per step "
        f"{[round(x, 4) for x in errs]}; bar {ARCH_BF16_TOL}, "
        f"{'held' if hold else 'logged'})")
    return e


def row_rms_err(out, want):
    """max over output rows of rms(out - want) / (the ``row_rms`` of
    ``ARCH_BF16_TOL`` x rms(want)): at most 1 passes."""
    import torch
    torch.cuda.synchronize()
    want = want.float()
    diff = (out.float() - want).pow(2).mean(-1).sqrt()
    rms = want.pow(2).mean(-1).sqrt()
    return (diff / (ARCH_BF16_TOL["row_rms"] * rms)).max().item()


def mla_layer_checks(cfg, model, dev):
    """``mla_decode`` naive and absorbed in bf16 on identical inputs at
    every MLA layer of ``model`` (``MLA_CHECK_*``): each against the naive
    form in f32 and the two against each other, held by ``row_rms_err``
    with ``scaled_err`` logged beside it; a planted step one position late
    read against the same bar.  Returns the readings."""
    import copy
    import torch
    from repro_torch.models import attention as A
    B, P = MLA_CHECK_B, MLA_CHECK_P
    gen = torch.Generator(device=dev).manual_seed(8)
    absorbed = cfg.variant(mla_absorb=True)
    forms = {"scalar": P, "[B]": torch.tensor(
        [P, P - MLA_CHECK_BACK], dtype=torch.int32, device=dev)}
    pairs = ("naive", "absorbed", "absorbed vs naive")
    err = {"rows": dict.fromkeys(pairs, 0.0),
           "elements": dict.fromkeys(pairs, 0.0), "planted": []}

    def step(c, m, xs, at, cache, dtype=None):
        fresh = {k: v.clone().to(dtype or v.dtype) for k, v in cache.items()}
        with torch.no_grad():
            return A.mla_decode(c, m, xs, fresh, at)[0]
    mlas = [m for m in model.modules() if isinstance(m, A.MLA)]
    for i, mla in enumerate(mlas):
        x = torch.randn(B, P + 2, cfg.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        positions = torch.arange(P + 1, dtype=torch.int32, device=dev)
        with torch.no_grad():
            _, cache = A.mla_fwd(cfg, mla, x[:, :P + 1], positions)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1))
                 for k, v in cache.items()}
        x_new = x[:, P + 1:]
        mla32 = copy.deepcopy(mla).float()
        for tag, pos in forms.items():
            want = step(cfg, mla32, x_new.float(), pos, cache,
                        torch.float32).to(torch.bfloat16)
            naive = step(cfg, mla, x_new, pos, cache)
            absd = step(absorbed, mla, x_new, pos, cache)
            where = f"layer {i}, {tag} position, B {B} x {P + 1} cached"
            for pair, out, ref in (("naive", naive, want),
                                   ("absorbed", absd, want),
                                   ("absorbed vs naive", absd, naive)):
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      f"mla_decode {pair} shape/dtype at {where}")
                e = row_rms_err(out, ref)
                check(e <= 1.0, f"mla_decode {pair} (bf16) differs by {e} "
                      f"of the row bar {ARCH_BF16_TOL['row_rms']} at {where}")
                err["rows"][pair] = max(err["rows"][pair], e)
                err["elements"][pair] = max(err["elements"][pair],
                                            scaled_err(out, ref))
            err["planted"].append(row_rms_err(
                step(absorbed, mla, x_new, pos + 1, cache), want))
        del mla32, cache, x
    check(min(err["planted"]) > 1.0,
          f"moe: an MLA decode step one position late reads "
          f"{err['planted']} of the row bar, which does not see it")
    log(f"moe: mla_decode naive and absorbed, bf16 on identical inputs at "
        f"all {len(mlas)} MLA layers of {cfg.name} (full width), one step "
        f"at a scalar position {P} and at [B] positions ({P}, "
        f"{P - MLA_CHECK_BACK}) over a cache prefilled with {P + 1} rows, "
        f"against the naive form in f32 on the same bf16 numbers and "
        f"absorbed against naive: max rms(diff) / (row_rms x rms) per "
        f"output row (held) {err['rows']}; max |diff| / bar "
        f"({ARCH_BF16_TOL}, logged) {err['elements']}; planted (the step "
        f"one position late, row bar) min {min(err['planted'])} max "
        f"{max(err['planted'])} over {len(err['planted'])} cases")
    return err


def moe_deepseek(dev):
    """deepseek-v2-lite-16b at full size in bf16: generate (naive, then
    absorbed MLA decode), the two held to each other, then the serve
    phase's BatchedServer.  Returns {path: (K4, K5)}."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    model, base = moe_model(cfg, dev, torch.bfloat16, cfg.name)
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_GEN_B, MOE_GEN_P)).astype(np.int32)).to(dev)
    from repro_torch.launch.serve import generate
    t0 = time.perf_counter()
    generate(cfg, model, prompts[:, :128], 4)    # warm-up, not counted
    log(f"moe:   warm-up (B {MOE_GEN_B}, 128 tokens, 3 steps) "
        f"{time.perf_counter() - t0:.3f} s")
    toks, _, _ = moe_generate(cfg, model, prompts, MOE_GEN_NEW,
                           f"{cfg.name} generate, naive MLA decode", 0, 0)
    moe_generate(cfg.variant(mla_absorb=True), model, prompts, MOE_GEN_NEW,
                 f"{cfg.name} generate, absorbed MLA decode", 0, 0)
    # logged, not held: in bf16 the two forms round the scores and weights
    # differently, and a top-6 of 64 router turns such a difference into
    # another expert; the forms are held to each other in f32 (moe_train)
    moe_absorb_check(cfg, model, prompts, toks, hold=False)
    # what routing cannot reach: the two forms layer by layer, held
    mla_layer_checks(cfg, model, dev)
    peak_log(dev, "moe", f"{cfg.name} generate", base)
    torch.cuda.reset_peak_memory_stats(dev)
    serve_run(cfg, model, serve_prompts(cfg.vocab_size)[:2], max_new=4)
    stats = {"prefill_ms": [], "tick_ms": []}
    from repro_torch import kernels
    kernels.reset_launches()
    prompts_s = serve_prompts(cfg.vocab_size)
    reqs, ticks, wall = serve_run(cfg, model, prompts_s, stats, SERVE_NEW)
    counts = kernels.launch_counts()
    arch_counts(f"{cfg.name} BatchedServer", counts, 0, 0)
    for r in reqs:
        check(r.done and len(r.out) == SERVE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"moe: {cfg.name} request {r.rid} out {r.out}")
    log(f"moe: {cfg.name} BatchedServer: {len(prompts_s)} requests "
        f"({SERVE_NEW} new each) over {SERVE_SLOTS} slots of "
        f"{SERVE_MAX_SEQ}: {ticks} ticks in {wall:.3f} s, "
        f"{len(prompts_s) * SERVE_NEW / wall:.1f} tokens/s; prefill ms per "
        f"request mean {np.mean(stats['prefill_ms']):.3f}, decode ms per "
        f"tick mean {np.mean(stats['tick_ms']):.3f} (median "
        f"{np.median(stats['tick_ms']):.3f}); peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB allocated")
    del model, reqs, toks, prompts
    free_card()
    return {f"{cfg.name} (MLA: no K4/K5)": (0, 0)}


def plain_prefill(q, k, v, kind, width):
    """The plain causal attention of a prompt under ``kind`` in f32, one
    block of ``SDPA_BLOCK_Q`` query rows at a time, rounded to q's
    dtype."""
    import torch
    from repro_torch.models import attention as A
    qf, kf, vf = (t.float() for t in (q, k, v))
    pos = torch.arange(q.shape[1], device=q.device)
    return torch.cat([A._sdpa_block(qf, kf, vf, pos, start, kind, width)
                      for start in range(0, q.shape[1], A.SDPA_BLOCK_Q)],
                     dim=1).to(q.dtype)


def scout_kernel_checks(dev, cfg):
    """K5 and K4 against their plain versions at scout's shapes
    (``SCOUT_K4_*``), bf16 under the scaled bar of ``ARCH_BF16_TOL``, with
    planted errors read against the same bar.  Returns the readings."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.models import attention as A
    bf16 = torch.bfloat16
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    C, S, B = cfg.attn_chunk, SCOUT_P, SCOUT_B
    gen = torch.Generator(device=dev).manual_seed(7)
    err = {"k5": {}, "k4": 0.0, "planted_k5": {}, "planted_k4": []}
    kernels.reset_launches()
    q, k, v = attn_inputs((B, S, H, hd), (B, S, Kv, hd), bf16, gen, dev)
    want = plain_prefill(q, k, v, "chunk", C)
    err["k5"]["chunk"] = bf16_check(
        "swa_attention (scout chunk reshape)",
        A._prefill_attention(q, k, v, "chunk", C), want,
        f"chunks of {C}, S {S}, G {H // Kv} bf16")
    # planted: the chunk boundary one token late
    err["planted_k5"]["chunk"] = scaled_err(
        A._prefill_attention(q, k, v, "chunk", C + 1), want)
    want = plain_prefill(q, k, v, "full", 0)
    err["k5"]["global"] = bf16_check(
        "swa_attention (scout global)", A._prefill_attention(
            q, k, v, "full", 0), want, f"window S {S}, G {H // Kv} bf16")
    # planted: the global layer windowed as wide as a chunk
    err["planted_k5"]["global"] = scaled_err(
        sops.swa_attention(q, k, v, window=C), want)
    del q, k, v, want
    k5_calls = kernels.launch_counts()["swa_attention"]
    check(k5_calls == 4, f"scout: swa_attention launched {k5_calls} for 4")
    check(min(err["planted_k5"].values()) > 1.0,
          f"scout: planted K5 errors read {err['planted_k5']} of the bf16 "
          f"bar, which does not see them")
    calls = 0
    for kind, W, positions in (("chunk", C, SCOUT_K4_CHUNK_POSITIONS),
                               ("full", S + SCOUT_NEW,
                                SCOUT_K4_FULL_POSITIONS)):
        q, k, v = attn_inputs((B, 1, H, hd), (B, W, Kv, hd), bf16, gen, dev)
        idx = torch.arange(W, device=dev)
        for p in positions:
            at = p % W if kind == "chunk" else p
            live = torch.tensor(at, dtype=torch.int32, device=dev)
            out = dops.decode_attention(q[:, 0], k, v, live)
            calls += 1
            qf, kf, vf = (t.float() for t in (q, k, v))
            want = dref.decode_attention(qf[:, 0], kf, vf, live).to(bf16)
            bias = torch.where(idx <= at, 0.0, -1e30).reshape(1, 1, 1, W)
            where = f"{kind} W {W} G {H // Kv} pos {p} (pos' {at}) bf16"
            err["k4"] = max(
                err["k4"],
                bf16_check("decode_attention (scout)", out, want, where),
                bf16_check("decode_attention (scout bias)", out,
                           A._sdpa(qf, kf, vf, bias)[:, 0].to(bf16), where))
            # planted: pos' one slot off (one more, or one fewer where the
            # cache is full)
            off = torch.tensor(at + 1 if at < W - 1 else at - 1,
                               dtype=torch.int32, device=dev)
            err["planted_k4"].append(scaled_err(
                dops.decode_attention(q[:, 0], k, v, off), want))
            calls += 1
        del q, k, v, qf, kf, vf
    k4_calls = kernels.launch_counts()["decode_attention"]
    check(k4_calls == calls,
          f"scout: decode_attention launched {k4_calls} for {calls}")
    log(f"moe: scout kernel checks (B {B}, H {H}, Kv {Kv}, hd {hd}, G "
        f"{H // Kv}, bf16) against the plain versions in f32, max |diff| / "
        f"bar ({ARCH_BF16_TOL}): swa_attention through the chunk reshape "
        f"(S {S}, chunks of {C}) {err['k5']['chunk']}, over the global "
        f"layer's prompt (window S) {err['k5']['global']} ({k5_calls} "
        f"launches); decode_attention over the chunk ring of {C} at pos "
        f"{SCOUT_K4_CHUNK_POSITIONS} and the full cache of {S + SCOUT_NEW} "
        f"at pos {SCOUT_K4_FULL_POSITIONS}, against the plain version and "
        f"the bias mask, {err['k4']} ({k4_calls} launches); planted: chunk "
        f"boundary one token late {err['planted_k5']['chunk']}, global "
        f"layer windowed at {C} {err['planted_k5']['global']}, pos' one "
        f"slot off {err['planted_k4']}")
    free_card()
    return err


def moe_scout(dev):
    """llama4-scout-17b-a16e at full width over one period in bf16 through
    generate; returns {path: (K4, K5)}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    full = get_config("llama4-scout-17b-a16e")
    cfg = full.variant(n_layers=SCOUT_LAYERS)
    from repro_torch.models import transformer as T
    log(f"moe: {full.name}: the whole model, {full.n_layers} layers, is "
        f"{T.param_count(full)} parameters ({T.param_count(full) * 2 / 1e9:.1f}"
        f" GB of bf16): one card cannot hold it; run over one period of "
        f"{SCOUT_LAYERS} layers")
    scout_kernel_checks(dev, cfg)
    model, base = moe_model(cfg, dev, torch.bfloat16,
                            f"{cfg.name} variant(n_layers={SCOUT_LAYERS})")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SCOUT_B, SCOUT_P)).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    generate(cfg, model, prompts[:, :128], 4)    # warm-up, not counted
    log(f"moe:   warm-up (128 tokens, 3 steps) "
        f"{time.perf_counter() - t0:.3f} s")
    steps = SCOUT_NEW - 1
    _, counts, _ = moe_generate(
        cfg, model, prompts, SCOUT_NEW,
        f"{cfg.name} 4 layers generate (chunk {cfg.attn_chunk}: K5 rows "
        f"of {-(-SCOUT_P // cfg.attn_chunk)} chunks; global every "
        f"{cfg.global_attn_every}; G {cfg.n_heads // cfg.n_kv_heads})",
        cfg.n_layers, cfg.n_layers * steps)
    peak_log(dev, "moe", f"{cfg.name} 4 layers", base)
    del model, prompts
    free_card()
    return {f"{full.name} 4 layers": (counts["decode_attention"],
                                       counts["swa_attention"])}


def moe_saved_gb(cfg, model, params, tokens):
    """GB the training forward keeps for the backward under ``cfg``'s
    checkpoint policy: allocated after the loss, before the backward,
    less allocated before it."""
    import torch
    from repro_torch.kernels.cross_entropy.ops import lm_loss
    from repro_torch.models import transformer as T
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    logits, aux = T.apply_params(cfg, model, leaves, tokens[:, :-1])
    loss = lm_loss(logits, tokens[:, 1:]) + aux
    del logits
    torch.cuda.synchronize()
    saved = (torch.cuda.memory_allocated() - before) / 1e9
    del loss, aux, leaves
    return saved


def policy_train(cfg, dev, model, params, batch, policies, timed, phase,
                 tag, note=""):
    """make_train_step under each of ``policies`` from the same params and
    batch after one warm-up step, ``timed`` steps each: K3 once a step and
    every policy's first loss within ``MOE_POLICY_LOSS_RTOL`` of full's,
    held; ms per step, memory kept for the backward and the step's peak
    logged under ``phase``.  Returns (K3 launches, {policy: GB kept for
    the backward})."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.steps import make_train_step
    B, S = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    make_train_step(cfg, lr=0.01)(model, params, batch)     # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    k3, saved, first = 0, {}, {}
    for name, kw in policies:
        pcfg = cfg.variant(**kw)
        saved[name] = moe_saved_gb(pcfg, model, params, batch["tokens"])
        step = make_train_step(pcfg, lr=0.01)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        losses = []
        t0 = time.perf_counter()
        for _ in range(timed):
            new, metrics = step(model, params, batch)
            losses.append(metrics["loss"])
            del new
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed * 1e3
        counts = kernels.launch_counts()
        check(counts["cross_entropy"] == timed
              and counts["swa_attention"] == counts["decode_attention"] == 0,
              f"{phase} train {name}: launches {counts}, want cross_entropy "
              f"{timed} (one a step)")
        k3 += counts["cross_entropy"]
        losses = [float(v) for v in losses]
        first[name] = losses[0]
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        log(f"{phase}: train {tag}, B {B} S {S}, {name}: {ms:.3f} ms per "
            f"step over {timed} steps, {B * S / ms * 1e3:.1f} tokens/s; "
            f"saved for the backward {saved[name]:.3f} GB; step peak "
            f"{peak:.3f} GB above params and batch (the gradients and the "
            f"new params); loss {losses}{note}; cross_entropy launches "
            f"{counts['cross_entropy']}; card {card_line()}")
    ref = first["full"]
    for name, loss in first.items():
        check(abs(loss - ref) <= MOE_POLICY_LOSS_RTOL * abs(ref),
              f"{phase} train: {name} loss {loss} against full's {ref}")
    return k3, saved


def moe_train(dev):
    """make_train_step on the 5-layer deepseek in f32 under every
    checkpoint policy, from the same params and batch, then the two MLA
    decode forms held to each other; returns the K3 launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synth_tokens
    from repro_torch.models import transformer as T
    cfg = get_config("deepseek-v2-lite-16b").variant(
        n_layers=MOE_TRAIN_LAYERS)
    model, _ = moe_model(cfg, dev, torch.float32,
                         f"{cfg.name} variant(n_layers="
                         f"{MOE_TRAIN_LAYERS}) training")
    params = T.param_dict(model)
    batch = {"tokens": torch.from_numpy(synth_tokens(
        MOE_TRAIN_B, MOE_TRAIN_S + 1, cfg.vocab_size, seed=6)).to(dev)}
    with torch.no_grad():
        _, aux = T.forward(cfg, model, batch["tokens"][:, :-1])
    k3, saved = policy_train(
        cfg, dev, model, params, batch, MOE_POLICIES, MOE_TRAIN_TIMED, "moe",
        f"{cfg.name} {MOE_TRAIN_LAYERS} layers f32",
        f" (aux {float(aux)} included)")
    cut = MOE_TRAIN_S - MOE_ABSORB_STEPS
    moe_absorb_check(cfg, model, batch["tokens"][:2, :cut],
                     batch["tokens"][:2, cut:MOE_TRAIN_S], hold=True)
    order = sorted(saved, key=lambda n: -saved[n])
    log(f"moe: train memory saved for the backward, most first: "
        f"{[(n, round(saved[n], 3)) for n in order]} (expected no_remat "
        f">= dots >= dots_nb >= full: "
        f"{saved['no_remat'] >= saved['dots'] >= saved['dots_nb'] >= saved['full']})")
    del model, params, batch
    free_card()
    return k3


def moe_optim(dev):
    """adam under linear_warmup_cosine and momentum SGD, each after
    clip_by_global_norm, on smollm-360m's f32 param dict: three steps from
    one gradient on the card and on the CPU."""
    import torch
    import repro_torch.optim as O
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(SERVE_ARCH)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                          device=dev)
    params = T.param_dict(model)
    gen = torch.Generator(device=dev).manual_seed(5)
    grads = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3
             for k, v in params.items()}
    n = sum(v.numel() for v in params.values())
    for label, opt in (
            ("adam(linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.1)",
             O.adam(O.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.1)),
            ("momentum_sgd(0.01)", O.momentum_sgd(0.01))):
        out, ms = [], []
        for where in (dev, "cpu"):
            p = {k: v.to(where) for k, v in params.items()}
            g = {k: v.to(where) for k, v in grads.items()}
            state = opt.init(p)
            for _ in range(OPTIM_STEPS):
                if where == dev:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                gc, norm = O.clip_by_global_norm(g, 1.0)
                u, state = opt.update(gc, state, p)
                p = O.apply_updates(p, u)
                if where == dev:
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            check(state["step"].device.type == torch.device(where).type
                  and int(state["step"]) == OPTIM_STEPS,
                  f"moe optim {label}: step {state['step']}")
            out.append(p)
            del g, gc, u, state
        # |card - CPU| over the band atol + rtol |CPU|: at most 1 passes
        pairs = [(a.cpu(), b) for a, b in zip(out[0].values(),
                                               out[1].values())]
        diff = max((a - b).abs().max().item() for a, b in pairs)
        band = max(((a - b).abs() / (OPTIM_TOL["atol"] + OPTIM_TOL["rtol"]
                                      * b.abs())).max().item()
                   for a, b in pairs)
        check(band <= 1.0, f"moe optim {label}: card against CPU max |diff| "
              f"{diff}, {band} of the band {OPTIM_TOL}")
        log(f"moe: optim {label} with clip_by_global_norm(1.0) on "
            f"{cfg.name}'s {len(params)} f32 leaves ({n} parameters), "
            f"{OPTIM_STEPS} steps from one gradient: card against CPU max "
            f"|diff| {diff}, {band} of the band {OPTIM_TOL}; ms per update "
            f"on the card (clip + update + apply) "
            f"{[round(x, 3) for x in ms]}")
        del out
    del model, params, grads
    free_card()


def moe_vs_cpu(dev):
    """The reduced configs card against CPU, one CPU init: prefill of 80
    tokens and 16 teacher-forced decode steps, and a training forward's
    aux; deepseek in both MLA decode forms."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    ds = get_config("deepseek-v2-lite-16b").reduced()
    cfgs = {"deepseek-v2-lite-16b": ds,
            "deepseek-v2-lite-16b absorbed": ds.variant(mla_absorb=True),
            "llama4-scout-17b-a16e": get_config(
                "llama4-scout-17b-a16e").reduced()}
    for label, cfg in cfgs.items():
        cpu = T.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        prompt = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, ARCH_CPU_PROMPT)).astype(np.int64))
        lc, cc = T.prefill(cfg, cpu, prompt)
        lg, cg = T.prefill(cfg, gpu, prompt.to(dev))
        diffs = [(lg.cpu() - lc).abs().max().item()]
        end = max([ARCH_CPU_PROMPT + ARCH_CPU_STEPS,
                   *(w for _, w in attn.ring_specs(cfg))])
        cc, cg = T.grow_cache(cfg, cc, 2, end), T.grow_cache(cfg, cg, 2, end)
        forced = torch.argmax(lc[:, -1:], -1)
        for i in range(ARCH_CPU_STEPS):
            lc, cc = T.decode_step(cfg, cpu, forced, cc, ARCH_CPU_PROMPT + i)
            lg, cg = T.decode_step(cfg, gpu, forced.to(dev), cg,
                                   ARCH_CPU_PROMPT + i)
            diffs.append((lg.cpu() - lc).abs().max().item())
            check(torch.allclose(lg.cpu(), lc, **MOE_CPU_TOL),
                  f"moe vs CPU: {label} step {i} differs by {diffs[-1]}")
            forced = torch.argmax(lc, -1)
        (_, ac), (_, ag) = (T.forward(cfg, m, t) for m, t in (
            (cpu, prompt), (gpu, prompt.to(dev))))
        check(torch.allclose(ag.cpu(), ac, rtol=1e-5),
              f"moe vs CPU: {label} aux {float(ag)} against {float(ac)}")
        log(f"moe vs CPU: {label} (reduced): prefill of {ARCH_CPU_PROMPT} "
            f"tokens + {ARCH_CPU_STEPS} teacher-forced steps, logits max "
            f"|diff| {max(diffs)} ({MOE_CPU_TOL}); aux {float(ag)} against "
            f"{float(ac)}")


def phase_moe(dev):
    """The MoE + MLA archs and the training side on the card.  Returns
    ({path: K4 launches}, {path: K5 launches}, K3 launches)."""
    paths = moe_deepseek(dev)
    mark("moe: deepseek-v2-lite-16b serving")
    paths.update(moe_scout(dev))
    mark("moe: llama4-scout-17b-a16e serving")
    k3 = moe_train(dev)
    mark("moe: training under five policies")
    moe_optim(dev)
    moe_vs_cpu(dev)
    mark("moe: optim, card against CPU")
    return ({p: k4 for p, (k4, _) in paths.items()},
            {p: k5 for p, (_, k5) in paths.items()}, k3)


# SSM layers (phase_ssm, after phase_moe), random weights from a seed, each
# model freed in turn: rwkv6-1.6b whole (24 layers of time-mix and
# channel-mix under LayerNorm, d_model 2048, 32 heads of 64) in bf16
# through generate (B 2 x 1,024, 64 new) and behind the serve phase's
# BatchedServer (8 slots of 2,048, its first 8 requests, 32 new): no K4 or
# K5; K5 and K4 against their plain versions at jamba-v0.1-52b's attention
# shapes (B 2, H 32, Kv 8: G 4, hd 128, bf16; K5 over a 1,024-token prompt,
# K4 over the 1,056-slot cache at generate's first and last steps) under
# ARCH_BF16_TOL, with planted errors; jamba at full width over one period
# of 8 layers (7 Mamba, 1 attention, 4 MoE of 16 experts top-2; the whole
# model is 103 GB of bf16) through generate (B 2 x 1,024, 32 new: K5 once,
# K4 once a step); rwkv6 cut to 4 layers trained in f32 (B 2, S 256: four
# checkpointed chunks of the scan) under full and no_remat (K3 once a
# step); card against CPU on the reduced configs.  The recurrences are
# torch ops a step (repro's are lax.scan, not Pallas).  One decode tick of
# each model and two rwkv6 prefills (32 and 64 tokens: their difference is
# the scan's launches per token) are profiled with the other profiler
# readings, last.
SSM_GEN_B, SSM_GEN_P = 2, 1024
RWKV_GEN_NEW, RWKV_SERVE_REQUESTS, RWKV_SERVE_NEW = 64, 8, 32
JAMBA_LAYERS, JAMBA_GEN_NEW = 8, 32
SSM_TRAIN_LAYERS, SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_TIMED = 4, 2, 256, 2
SSM_POLICIES = (("full", {}), ("no_remat", {"no_remat": True}))
SSM_PROFILE_PROMPTS = (32, 64)
# card against CPU, both sides f32: jamba's logits within MOE_CPU_TOL
# (6.2e-6 measured on an H100 80GB HBM3 at 700 W), rwkv6's within
# SSM_CPU_TOL, the port's bar against repro on the CPU
# (tests/_torch_archs.py's LOGIT_TOL): the time-mix's per-head group norm
# (eps 64e-5) scales up the rounding of its wkv state, so reduced rwkv6's
# prefill logits differ by 2.25e-5 card against CPU (the same card), past
# MOE_CPU_TOL's 1e-5, and by up to 1.55e-5 between the port and repro on
# the CPU; a state leaf
# within atol max(1e-5, 4e-6 x its largest |value|): the wkv state sums 81
# decayed k v^T products into values up to ~50, where the card's f32 sums
# differ from the CPU's by 1.04e-6 of the largest value (6.6e-7 between
# the port and repro on the CPU, tests/test_torch_archs_ssm.py), growing
# with the steps summed; one train step's parameters within MOE_CPU_TOL
SSM_CPU_TOL = dict(atol=1e-4, rtol=1e-4)
SSM_LOGIT_TOL = {"rwkv6-1.6b": SSM_CPU_TOL, "jamba-v0.1-52b": MOE_CPU_TOL}
SSM_STATE_SCALE = 4e-6
SSM_CPU_TRAIN_S = 128


def ssm_layout(cfg):
    """``moe_model``'s description of an SSM config."""
    pattern = [f"{s.mixer}+{s.mlp}" for s in cfg.sublayers()]
    return (f"{cfg.n_layers} layers (period {pattern}) d_model "
            f"{cfg.d_model} vocab {cfg.vocab_size}")


def ssm_profile_later(cfg, dtype, tag, prompts=()):
    """Queue the profiler readings of ``cfg`` at full width (built anew
    from the same seed, then freed): each prefill of ``prompts`` tokens
    (after one warm-up) and one decode tick after a 128-token prompt.
    The prefill pair gives the recurrence's launches per token."""
    import torch
    from repro_torch.models import transformer as T

    def measure():
        model = T.init_params(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(0), dtype=dtype, device=DEVICE)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (SSM_GEN_B, max(prompts + (128,))))
            .astype(np.int32)).to(DEVICE)
        launched = {}
        for P in prompts:
            def fn(P=P):
                return T.prefill(cfg, model, toks[:, :P])
            fn()
            torch.cuda.synchronize()
            _, launched[P] = profile_call(
                f"ssm: {tag} prefill B {SSM_GEN_B} x {P}", fn)
        if len(launched) == 2:
            (p0, n0), (p1, n1) = sorted(launched.items())
            per = (n1 - n0) / (p1 - p0)
            log(f"ssm: {tag}: prefill launches per token {per:.2f} "
                f"({per / cfg.n_layers:.2f} a layer; {n0} at {p0} tokens, "
                f"{n1} at {p1}, as recorded by the profiler)")
        _, cache = T.prefill(cfg, model, toks[:, :128])
        cache = T.grow_cache(cfg, cache, SSM_GEN_B, 130, dtype)
        token = toks[:, :1]
        T.decode_step(cfg, model, token, cache, 128)
        _, n = profile_call(f"ssm: {tag} one decode tick (B {SSM_GEN_B})",
                            lambda: T.decode_step(cfg, model, token, cache,
                                                  129))
        log(f"ssm: {tag}: {n} launches per decode tick "
            f"({n / cfg.n_layers:.1f} a layer) as recorded by the profiler")
        del model, cache
        free_card()
    PROFILED.append(measure)


def ssm_rwkv(dev):
    """rwkv6-1.6b whole in bf16 through generate and behind
    BatchedServer; returns {path: (K4, K5)}."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    cfg = get_config("rwkv6-1.6b")
    model, base = moe_model(cfg, dev, torch.bfloat16, cfg.name, "ssm",
                            ssm_layout(cfg))
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (SSM_GEN_B, SSM_GEN_P)).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    generate(cfg, model, prompts[:, :128], 4)    # warm-up, not counted
    log(f"ssm:   warm-up (B {SSM_GEN_B}, 128 tokens, 3 steps) "
        f"{time.perf_counter() - t0:.3f} s")
    moe_generate(cfg, model, prompts, RWKV_GEN_NEW, f"{cfg.name} generate",
                 0, 0, "ssm")
    peak_log(dev, "ssm", f"{cfg.name} generate", base)
    torch.cuda.reset_peak_memory_stats(dev)
    prompts_s = serve_prompts(cfg.vocab_size)[:RWKV_SERVE_REQUESTS]
    stats = {"prefill_ms": [], "tick_ms": []}
    kernels.reset_launches()
    reqs, ticks, wall = serve_run(cfg, model, prompts_s, stats,
                                  RWKV_SERVE_NEW)
    arch_counts(f"{cfg.name} BatchedServer", kernels.launch_counts(), 0, 0)
    for r in reqs:
        check(r.done and len(r.out) == RWKV_SERVE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"ssm: {cfg.name} request {r.rid} out {r.out}")
    tokens = sum(len(p) for p in prompts_s)
    log(f"ssm: {cfg.name} BatchedServer: {len(prompts_s)} requests of "
        f"{min(map(len, prompts_s))}-{max(map(len, prompts_s))} prompt "
        f"tokens ({tokens} in all; {RWKV_SERVE_NEW} new each) over "
        f"{SERVE_SLOTS} slots of {SERVE_MAX_SEQ}: {ticks} ticks in "
        f"{wall:.3f} s, {len(prompts_s) * RWKV_SERVE_NEW / wall:.1f} "
        f"tokens/s; prefill ms per request mean "
        f"{np.mean(stats['prefill_ms']):.3f} "
        f"({np.sum(stats['prefill_ms']) / tokens:.4f} per prompt token), "
        f"decode ms per tick mean {np.mean(stats['tick_ms']):.3f} (median "
        f"{np.median(stats['tick_ms']):.3f}); launches K4 0, K5 0")
    peak_log(dev, "ssm", f"{cfg.name} BatchedServer", base)
    ssm_profile_later(cfg, torch.bfloat16, cfg.name, SSM_PROFILE_PROMPTS)
    del model, reqs, prompts
    free_card()
    return {f"{cfg.name} generate": (0, 0),
            f"{cfg.name} BatchedServer": (0, 0)}


def ssm_kernel_checks(dev, cfg):
    """K5 and K4 against their plain versions at jamba's attention shapes
    (those its generate launches), bf16 under ``ARCH_BF16_TOL``, with
    planted errors: K5 windowed at half the prompt (held to read above the
    bar), K4 one key short (logged).  Returns the readings."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.models import attention as A
    bf16 = torch.bfloat16
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S, W = SSM_GEN_B, SSM_GEN_P, SSM_GEN_P + JAMBA_GEN_NEW
    where = f"B {B}, H {H}, Kv {Kv} (G {H // Kv}), hd {hd}, bf16"
    gen = torch.Generator(device=dev).manual_seed(9)
    kernels.reset_launches()
    q, k, v = attn_inputs((B, S, H, hd), (B, S, Kv, hd), bf16, gen, dev)
    want = plain_prefill(q, k, v, "full", 0)
    k5 = bf16_check("swa_attention (jamba)", A._prefill_attention(
        q, k, v, "full", 0), want, f"{where}, S {S}, window S")
    planted_k5 = scaled_err(sops.swa_attention(q, k, v, window=S // 2), want)
    del q, k, v, want
    q, k, v = attn_inputs((B, 1, H, hd), (B, W, Kv, hd), bf16, gen, dev)
    qf, kf, vf = (t.float() for t in (q, k, v))
    idx = torch.arange(W, device=dev)
    k4, planted_k4 = 0.0, []
    for p in (S, W - 2):           # generate's first and last decode steps
        live = torch.tensor(p, dtype=torch.int32, device=dev)
        out = dops.decode_attention(q[:, 0], k, v, live)
        want = dref.decode_attention(qf[:, 0], kf, vf, live).to(bf16)
        bias = torch.where(idx <= p, 0.0, -1e30).reshape(1, 1, 1, W)
        at = f"{where}, cache {W}, pos {p}"
        k4 = max(k4, bf16_check("decode_attention (jamba)", out, want, at),
                 bf16_check("decode_attention (jamba bias)", out,
                            A._sdpa(qf, kf, vf, bias)[:, 0].to(bf16), at))
        short = torch.tensor(p - 1, dtype=torch.int32, device=dev)
        planted_k4.append(scaled_err(
            dops.decode_attention(q[:, 0], k, v, short), want))
    counts = kernels.launch_counts()
    check(counts["swa_attention"] == 2 and counts["decode_attention"] == 4,
          f"ssm: jamba kernel checks launched {counts}")
    check(planted_k5 > 1.0, f"ssm: K5 windowed at {S // 2} reads "
          f"{planted_k5} of the bf16 bar, which does not see it")
    log(f"ssm: jamba kernel checks ({where}) against the plain versions in "
        f"f32, max |diff| / bar ({ARCH_BF16_TOL}): swa_attention over a "
        f"{S}-token prompt (window S) {k5}; decode_attention over the "
        f"{W}-slot cache at pos {S} and {W - 2}, against the plain version "
        f"and the bias mask, {k4}; planted: K5 windowed at {S // 2} "
        f"{planted_k5} (held > 1), K4 one key short {planted_k4} "
        f"(logged)")
    del q, k, v, qf, kf, vf
    free_card()
    return {"k5": k5, "k4": k4}


def ssm_jamba(dev):
    """jamba-v0.1-52b at full width over one period of 8 layers in bf16
    through generate; returns {path: (K4, K5)}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    full = get_config("jamba-v0.1-52b")
    cfg = full.variant(n_layers=JAMBA_LAYERS)
    log(f"ssm: {full.name}: the whole model, {full.n_layers} layers, is "
        f"{T.param_count(full)} parameters ({T.param_count(full) * 2 / 1e9:.1f}"
        f" GB of bf16): one card cannot hold it; run over one period of "
        f"{JAMBA_LAYERS} layers")
    ssm_kernel_checks(dev, cfg)
    model, base = moe_model(cfg, dev, torch.bfloat16,
                            f"{cfg.name} variant(n_layers={JAMBA_LAYERS})",
                            "ssm", ssm_layout(cfg))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SSM_GEN_B, SSM_GEN_P)).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    generate(cfg, model, prompts[:, :128], 4)    # warm-up, not counted
    log(f"ssm:   warm-up (B {SSM_GEN_B}, 128 tokens, 3 steps) "
        f"{time.perf_counter() - t0:.3f} s")
    attn = sum(s.mixer == "attn" for s in cfg.sublayers()) * cfg.n_periods
    steps = JAMBA_GEN_NEW - 1
    _, counts, _ = moe_generate(
        cfg, model, prompts, JAMBA_GEN_NEW,
        f"{cfg.name} {JAMBA_LAYERS} layers generate ({attn} attention "
        f"layer, G {cfg.n_heads // cfg.n_kv_heads})", attn, attn * steps,
        "ssm")
    peak_log(dev, "ssm", f"{cfg.name} {JAMBA_LAYERS} layers generate",
             base)
    ssm_profile_later(cfg, torch.bfloat16,
                      f"{cfg.name} {JAMBA_LAYERS} layers")
    del model, prompts
    free_card()
    return {f"{full.name} {JAMBA_LAYERS} layers": (
        counts["decode_attention"], counts["swa_attention"])}


def ssm_train(dev):
    """make_train_step on rwkv6 cut to 4 layers in f32 under full and
    no_remat, from the same params and batch; returns the K3 launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synth_tokens
    from repro_torch.models import transformer as T
    cfg = get_config("rwkv6-1.6b").variant(n_layers=SSM_TRAIN_LAYERS)
    model, _ = moe_model(cfg, dev, torch.float32,
                         f"{cfg.name} variant(n_layers="
                         f"{SSM_TRAIN_LAYERS}) training", "ssm",
                         ssm_layout(cfg))
    params = T.param_dict(model)
    batch = {"tokens": torch.from_numpy(synth_tokens(
        SSM_TRAIN_B, SSM_TRAIN_S + 1, cfg.vocab_size, seed=6)).to(dev)}
    k3, _ = policy_train(
        cfg, dev, model, params, batch, SSM_POLICIES, SSM_TRAIN_TIMED, "ssm",
        f"{cfg.name} {SSM_TRAIN_LAYERS} layers f32 ({SSM_TRAIN_S // 64} "
        f"checkpointed chunks of the scan)")
    del model, params, batch
    free_card()
    return k3


def state_err(got, want):
    """max |got - want| over the state bar, atol max(1e-5, SSM_STATE_SCALE
    x max |want|): at most 1 passes."""
    want = want.float()
    bar = max(MOE_CPU_TOL["atol"],
              SSM_STATE_SCALE * want.abs().max().item())
    return (got.float().cpu() - want).abs().max().item() / bar


def ssm_vs_cpu(dev):
    """The reduced configs card against CPU, one CPU init: prefill logits
    of 80 tokens, one decode step's logits, every state leaf after each,
    and one training step's parameters (S 128: two checkpointed chunks).
    Every reading is logged before any is held."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T

    def over(got, want, tol):
        """max |got - want| / (atol + rtol |want|): at most 1 passes."""
        want = want.float()
        return ((got.float().cpu() - want).abs()
                / (tol["atol"] + tol["rtol"] * want.abs())).max().item()
    for name in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        cfg = get_config(name).reduced()
        cpu = T.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(3)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, ARCH_CPU_PROMPT)).astype(np.int64))
        read = {"logits": [], "logits / bar": [], "states / bar": {}}
        tol = SSM_LOGIT_TOL[name]

        def logits(lg, lc):
            read["logits"].append((lg.cpu() - lc).abs().max().item())
            read["logits / bar"].append(over(lg, lc, tol))

        def states(cc, cg):
            for j, sub in enumerate(cfg.sublayers()):
                for group, leaves in cc["stack"][f"sub{j}"].items():
                    if T.is_state(sub, group):
                        for k, v in leaves.items():
                            key = f"sub{j}.{group}.{k}"
                            e = state_err(cg["stack"][f"sub{j}"][group][k], v)
                            read["states / bar"][key] = max(
                                read["states / bar"].get(key, 0.0), e)
        lc, cc = T.prefill(cfg, cpu, prompt)
        lg, cg = T.prefill(cfg, gpu, prompt.to(dev))
        logits(lg, lc)
        states(cc, cg)
        cc = T.grow_cache(cfg, cc, 2, ARCH_CPU_PROMPT + 1)
        cg = T.grow_cache(cfg, cg, 2, ARCH_CPU_PROMPT + 1)
        forced = torch.argmax(lc[:, -1:], -1)
        lc, cc = T.decode_step(cfg, cpu, forced, cc, ARCH_CPU_PROMPT)
        lg, cg = T.decode_step(cfg, gpu, forced.to(dev), cg, ARCH_CPU_PROMPT)
        logits(lg, lc)
        states(cc, cg)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, SSM_CPU_TRAIN_S + 1)).astype(np.int64))
        step = make_train_step(cfg, lr=0.05)
        pc, mc = step(cpu, T.param_dict(cpu), {"tokens": toks})
        pg, mg = step(gpu, T.param_dict(gpu), {"tokens": toks.to(dev)})
        pdiff = max((pg[k].cpu() - pc[k]).abs().max().item() for k in pc)
        pbar = max(over(pg[k], pc[k], MOE_CPU_TOL) for k in pc)
        loss = abs(float(mg["loss"]) / float(mc["loss"]) - 1)
        log(f"ssm vs CPU: {name} (reduced, f32): prefill of "
            f"{ARCH_CPU_PROMPT} tokens and one decode step, logits max "
            f"|diff| {read['logits']}, / bar ({tol}) "
            f"{read['logits / bar']}; state leaves, max |diff| / bar (atol "
            f"max(1e-5, {SSM_STATE_SCALE} x max |leaf|)) "
            f"{read['states / bar']}; one train step at S {SSM_CPU_TRAIN_S}"
            f": params max |diff| {pdiff}, / bar ({MOE_CPU_TOL}) {pbar}, "
            f"loss {float(mg['loss'])} against {float(mc['loss'])}")
        check(max(read["logits / bar"]) <= 1.0
              and max(read["states / bar"].values()) <= 1.0
              and pbar <= 1.0 and loss <= 1e-5,
              f"ssm vs CPU: {name} past a bar: {read}, params {pbar}, loss "
              f"relative {loss}")


def phase_ssm(dev):
    """The SSM archs on the card.  Returns ({path: K4 launches}, {path: K5
    launches}, K3 launches)."""
    paths = ssm_rwkv(dev)
    mark("ssm: rwkv6-1.6b serving")
    paths.update(ssm_jamba(dev))
    mark("ssm: jamba-v0.1-52b serving")
    k3 = ssm_train(dev)
    ssm_vs_cpu(dev)
    mark("ssm: training, card against CPU")
    return ({p: k4 for p, (k4, _) in paths.items()},
            {p: k5 for p, (_, k5) in paths.items()}, k3)


# llama3-405b (128 query heads over 8 kv heads: K4 and K5 at G 16) at full
# width over 4 of its 126 layers in bf16 (~34 GB): generate at B 2 x 1,024
# prompt tokens, 32 new (K5 once a layer in the prefill, K4 once a layer a
# tick); each layer's attention held first, on its own projections of the
# prompt, against the plain versions in f32 under ARCH_BF16_TOL, with a
# planted error read against the same bar
LLAMA3_LAYERS, LLAMA3_B, LLAMA3_P, LLAMA3_NEW = 4, 2, 1024, 32
# K4's llama3-405b decode shape: B 2, a cache of P + NEW slots, bf16
LLAMA3_K4_POSITIONS = (1023, 1040, 1055)
# the sharded train step on a one-rank NCCL ("data", "model") mesh:
# reduced deepseek-v2-lite-16b (MoE and MLA exercise the most rules) with
# shard_activations, grad_specs, FSDP forced on and 2 microbatches, in f32;
# its params within 1e-6 of the unsharded step's (one rank: the same
# products, DTensor adds only no-op redistributions)
SHARD_B, SHARD_S, SHARD_STEPS, SHARD_TOL = 4, 64, 2, 1e-6


def llama3_layer_checks(dev, cfg, model):
    """Each layer's K5 (its prompt, window S) and K4 (a cache of P + NEW
    slots at ``LLAMA3_K4_POSITIONS``), on that layer's own q, k, v of the
    RMS-normed prompt embeddings, against the plain versions in f32 under
    ``ARCH_BF16_TOL``; planted: K5 at half the window, K4 at half the
    position (the layers' scores are small, their weights near uniform:
    one key of a thousand moves an output row by about the bar).  Returns
    the readings."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.models import attention as A
    from repro_torch.models.modules import apply_rope, embed_lookup
    bf16 = torch.bfloat16
    B, P, W = LLAMA3_B, LLAMA3_P, LLAMA3_P + LLAMA3_NEW
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (B, W), generator=gen,
                           device=dev)
    pos = torch.arange(W, dtype=torch.int32, device=dev)
    idx = torch.arange(W, device=dev)
    err = {"k5": 0.0, "k4": 0.0, "planted_k5": [], "planted_k4": []}
    kernels.reset_launches()
    k4_calls = 0
    with torch.no_grad():
        h = embed_lookup(model.embed.table, prompt)
        for i, period in enumerate(model.stack):
            layer = period.sub0
            q, k, v = A._qkv(layer.mixer, layer.ln1(h))
            q = apply_rope(q, pos, layer.mixer.rope_freqs)
            k = apply_rope(k, pos, layer.mixer.rope_freqs)
            where = f"layer {i} B {B} S {P} G {cfg.n_heads // cfg.n_kv_heads}"
            qp, kp, vp = (t[:, :P].contiguous() for t in (q, k, v))
            want = plain_prefill(qp, kp, vp, "full", 0)
            err["k5"] = max(err["k5"], bf16_check(
                "swa_attention (llama3-405b)",
                A._prefill_attention(qp, kp, vp, "full", 0), want, where))
            err["planted_k5"].append(scaled_err(
                sops.swa_attention(qp, kp, vp, window=P // 2), want))
            kc, vc = k.contiguous(), v.contiguous()
            for p in LLAMA3_K4_POSITIONS:
                live = torch.tensor(p, dtype=torch.int32, device=dev)
                out = dops.decode_attention(q[:, p].contiguous(), kc, vc,
                                            live)
                qf, kf, vf = (t.float() for t in (q[:, p], kc, vc))
                want = dref.decode_attention(qf, kf, vf, live).to(bf16)
                bias = torch.where(idx <= p, 0.0, -1e30).reshape(1, 1, 1, W)
                at = f"{where} pos {p} of {W}"
                err["k4"] = max(
                    err["k4"],
                    bf16_check("decode_attention (llama3-405b)", out, want,
                               at),
                    bf16_check("decode_attention (llama3-405b bias)", out,
                               A._sdpa(qf[:, None], kf, vf, bias)[:, 0]
                               .to(bf16), at))
                err["planted_k4"].append(scaled_err(dops.decode_attention(
                    q[:, p].contiguous(), kc, vc, live // 2), want))
                k4_calls += 2
            del q, k, v, qp, kp, vp, kc, vc, qf, kf, vf, want
    counts = kernels.launch_counts()
    check(counts["swa_attention"] == 2 * cfg.n_layers
          and counts["decode_attention"] == k4_calls,
          f"llama3: layer checks launched {counts}")
    check(min(err["planted_k5"] + err["planted_k4"]) > 1.0,
          f"llama3: planted errors read {err['planted_k5']} (K5) and "
          f"{err['planted_k4']} (K4) of the bf16 bar, which does not see "
          "them")
    log(f"llama3: layer checks, each of {cfg.n_layers} layers on its own "
        f"q, k, v (B {B}, H {cfg.n_heads}, Kv {cfg.n_kv_heads}, hd "
        f"{cfg.resolved_head_dim}, G 16, bf16) against the plain versions "
        f"in f32, max |diff| / bar ({ARCH_BF16_TOL}): swa_attention over "
        f"the {P}-token prompt {err['k5']}; decode_attention over {W} slots "
        f"at pos {LLAMA3_K4_POSITIONS}, against the plain version and the "
        f"bias mask, {err['k4']}; planted: half the window "
        f"{[round(e, 3) for e in err['planted_k5']]}, half the position "
        f"{[round(e, 3) for e in err['planted_k4']]}")
    return err


def llama3_k4_timing(dev, cfg):
    """K4 at llama3-405b's decode shape (B 2, P + NEW slots, pos S - 1,
    bf16) beside its plain version and SDPA with ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    B, S = LLAMA3_B, LLAMA3_P + LLAMA3_NEW
    Kv, hd, H = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(12)
    pos = S - 1
    bytes_moved = (2 * B * Kv * (pos + 1) * hd + 2 * B * H * hd) * 2
    flops = 4 * B * H * (pos + 1) * hd
    n_sets = max(1, int(np.ceil(2 * L2_BYTES / bytes_moved)))
    sets = [attn_inputs((B, H, hd), (B, S, Kv, hd), torch.bfloat16, gen,
                        dev) for _ in range(n_sets)]
    posv = torch.full((B,), pos, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev) <= pos).expand(B, 1, 1, S)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
    runs = {"kernel": rotating(lambda q, k, v: ops.decode_attention(
                q, k, v, posv), sets),
            "plain": rotating(lambda q, k, v: ref.decode_attention(
                q, k, v, pos), sets),
            "library": rotating(sdpa, sets)}
    n_chunks = ops.split(B, S, Kv)
    return attn_timings(
        f"decode_attention llama3-405b B={B} S={S} G=16 hd={hd} bf16 "
        f"pos=S-1", runs, f"{n_sets} input sets; {B * Kv * n_chunks} blocks, "
        f"{n_chunks} chunks a row", bytes_moved, flops, BF16_FLOP_PER_S,
        6, 100, 10)


def phase_llama3(dev):
    """llama3-405b over 4 layers at full width in bf16.  Returns
    ({path: K4 launches}, {path: K5 launches}, {label: K4 timing row})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    full = get_config("llama3-405b")
    cfg = full.variant(n_layers=LLAMA3_LAYERS)
    log(f"llama3: {full.name}: the whole model, {full.n_layers} layers, is "
        f"{T.param_count(full)} parameters "
        f"({T.param_count(full) * 2 / 1e9:.1f} GB of bf16): run over "
        f"{LLAMA3_LAYERS} layers at full width")
    free_card()
    model, base = moe_model(
        cfg, dev, torch.bfloat16, f"{cfg.name} variant(n_layers="
        f"{LLAMA3_LAYERS})", phase="llama3",
        desc=f"{cfg.n_layers} layers d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} (G 16) hd "
        f"{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}")
    llama3_layer_checks(dev, cfg, model)
    free_card()
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (LLAMA3_B, LLAMA3_P)).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    from repro_torch.launch.serve import generate
    generate(cfg, model, prompts[:, :128], 4)    # warm-up, not counted
    log(f"llama3:   warm-up (128 tokens, 3 steps) "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    steps = LLAMA3_NEW - 1
    _, counts, tick_ms = moe_generate(
        cfg, model, prompts, LLAMA3_NEW,
        f"{cfg.name} {LLAMA3_LAYERS} layers generate (G 16)",
        cfg.n_layers, cfg.n_layers * steps, phase="llama3")
    # a tick reads every weight once but the embedding table's B rows
    read = sum(p.numel() * p.element_size() for n, p in
               model.named_parameters() if n != "embed.table")
    log(f"llama3:   tick {tick_ms:.3f} ms against its weight-read bound "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms ({read / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); card {card_line()}")
    peak_log(dev, "llama3", f"{cfg.name} {LLAMA3_LAYERS} layers", base)
    del model, prompts
    free_card()
    row = llama3_k4_timing(dev, cfg)
    path = f"{full.name} {LLAMA3_LAYERS} layers"
    return ({path: counts["decode_attention"]},
            {path: counts["swa_attention"]},
            {"llama3-405b decode B=2 S=1056 G=16 bf16": row})


def phase_shard_train(dev):
    """The sharded train step on a one-rank NCCL ("data", "model") mesh
    against the unsharded step on the card.  Returns its K3 launches."""
    import copy

    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor as dt
    from repro_torch.sharding.specs import (batch_spec, param_specs,
                                            placements)
    cfg = get_config("deepseek-v2-lite-16b").reduced().variant(
        microbatches=2)
    scfg = cfg.variant(shard_activations=True)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                          device=dev)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (SHARD_B, SHARD_S + 1)).astype(np.int32)).to(dev)
    step = make_train_step(cfg, lr=0.1)
    params = T.param_dict(model)
    kernels.reset_launches()
    for _ in range(SHARD_STEPS):
        params, _ = step(model, params, {"tokens": tokens})
    plain_k3 = kernels.launch_counts()["cross_entropy"]
    mesh = make_host_mesh(dev)
    try:
        specs = param_specs(scfg, mesh, fsdp=True)
        smodel = dt.shard_module(copy.deepcopy(model), mesh, specs)
        # the deep copy holds the init: the unsharded run replaced params
        batch = {"tokens": dt.shard(mesh, tokens, placements(
            mesh, batch_spec(mesh, SHARD_B) + (None,)))}
        sstep = make_train_step(scfg, lr=0.1, grad_specs=specs)
        sparams = T.param_dict(smodel)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(SHARD_STEPS):
            sparams, metrics = sstep(smodel, sparams, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SHARD_STEPS * 1e3
        counts = kernels.launch_counts()
        worst = max((sparams[k].full_tensor() - v).abs().max().item()
                    for k, v in params.items())
        kept = all(list(sparams[k].placements) == list(placements(
            mesh, specs[k])) for k in sparams)
    finally:
        dist.destroy_process_group()
    want = SHARD_STEPS * cfg.microbatches
    check(counts["cross_entropy"] == want == plain_k3,
          f"shard: cross_entropy launched {counts['cross_entropy']} (the "
          f"unsharded step {plain_k3}) for {want}")
    check(worst <= SHARD_TOL, f"shard: params {worst} from the unsharded "
          f"step's (tol {SHARD_TOL})")
    check(kept, "shard: a parameter left its spec's placements")
    log(f"shard: {cfg.name} reduced on a one-rank NCCL (data 1, model 1) "
        f"mesh, shard_activations, grad_specs, FSDP forced, "
        f"{cfg.microbatches} microbatches, B {SHARD_B} S {SHARD_S}, "
        f"{SHARD_STEPS} steps: params max |diff| {worst} from the unsharded "
        f"step (tol {SHARD_TOL}), placements kept; {ms:.3f} ms per step; "
        f"cross_entropy {counts['cross_entropy']} launches; card "
        f"{card_line()}")
    del model, smodel
    free_card()
    return counts["cross_entropy"]


# K3 cross_entropy: (nll, lse) within 1e-4 of the plain version in f32
# (repro's bar for its kernel, tests/test_kernels.py) and 3e-2 in bf16; rows
# of +-1e4 logits within 1e-3 (repro's bar for them: lse ~ 1e4, where one
# f32 ulp is 1e-3); d logits within 1e-6 of plain autograd
CE_TOL = {"f32": 1e-4, "bf16": 3e-2}
CE_EXTREME_TOL, CE_GRAD_TOL = 1e-3, 1e-6
# (V 65,536 is rwkv6-1.6b's vocab, whose training step runs K3 at R 512)
CE_R, CE_V = (1, 7, 512, 4096), (512, 1111, 49152, 65536, 131072)
CE_GRAD_CASES = ((7, 1111), (512, 49152), (512, 65536), (4096, 49152))
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
# the profiled training run is cut to 3 rounds: post-processing the trace
# of all 10 (about 300,000 kernel launches and their host ops) took
# minutes of host time
TRAIN_PROFILE_ROUNDS = 3
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
    from repro_torch.kernels.weighted_agg import ops as agg_ops
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
    per_merge = agg_ops.launches(leaves)
    check(counts["weighted_agg"] == per_merge * args.rounds,
          f"train: {counts['weighted_agg']} weighted_agg launches for "
          f"{args.rounds} merges of {leaves} leaves (expected {per_merge} "
          f"per merge)")
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
        f"{per_merge} launches for {leaves} leaves x {args.rounds} merges)")
    prof_args = train_args("--rounds", str(TRAIN_PROFILE_ROUNDS))
    profile_later(f"train {cfg.name} {TRAIN_PROFILE_ROUNDS} rounds",
                  lambda: train.run_training(cfg, model, prof_args,
                                             log=lambda *a: None))
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


def guarded(n, dev, dtype=None):
    """(buffer, view): ``n`` elements (f32 by default) with GUARD NaNs on
    each side."""
    import torch
    buf = torch.full((n + 2 * GUARD,), float("nan"), device=dev,
                     dtype=dtype or torch.float32)
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
    import ctypes
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
    sizes, dt = KERNEL_CASES[kid].args
    check(dt == torch.float32 and len(sizes) <= wa.MAX_LEAVES,
          f"{kid}: case is one f32 table")
    offsets, total = wa.flat_layout(sizes, dt)
    buf, out = guarded(total, dev)
    leaves = [(randn(n), randn(n), out.data_ptr() + 4 * off)
              for n, off in zip(sizes, offsets)]
    ptrs = (ctypes.c_int64 * (3 * len(leaves)))(*(
        p for g, l, o in leaves for p in (g.data_ptr(), l.data_ptr(), o)))
    b, coef = wa_ref.agg_scalars(0.5, 0.8719)
    wa.KERNEL.launch("weighted_agg_f32", dev, ptrs,
                     (ctypes.c_int64 * len(sizes))(*sizes), len(sizes), b,
                     coef, stream)
    (geo,) = KERNEL_CASES[kid].launches()
    written[kid] = check_written(kid, geo, "out", buf)

    kid = "weighted_agg.ring_agg"
    P, U, dt = KERNEL_CASES[kid].args
    g, locs, coeffs = randn(P), randn(U, P), randn(U, 2)
    buf, out = guarded(P, dev)
    wa.RING_KERNEL.launch("ring_agg_f32", dev, out.data_ptr(), g.data_ptr(),
                          locs.data_ptr(), coeffs.data_ptr(), P, U, 1, U * P,
                          stream)
    (geo,) = KERNEL_CASES[kid].launches()
    written[kid] = check_written(kid, geo, "out", buf)

    kid = "weighted_agg.ring_agg_worlds"
    P, U, dt, W = KERNEL_CASES[kid].args
    g, locs, coeffs = randn(W, P), randn(W, U + 1, P), randn(W, U, 2)
    buf, out = guarded(W * P, dev)
    wa.RING_KERNEL.launch("ring_agg_f32", dev, out.data_ptr(), g.data_ptr(),
                          locs.data_ptr(), coeffs.data_ptr(), P, U, W,
                          (U + 1) * P, stream)
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
    n_chunks = da.split(B, S, Kv)
    chunk_geo, combine_geo = KERNEL_CASES[kid].launches()
    written[kid] = {}
    # every block writes its whole slot whatever its share: an empty share
    # writes the neutral state
    for fn, dt in (("decode_attention_f32", torch.float32),
                   ("decode_attention_bf16", torch.bfloat16)):
        q, k, v = (x.to(dt) for x in (randn(B, H, hd), randn(B, S, Kv, hd),
                                      randn(B, S, Kv, hd)))
        for pname, pos in (("0", torch.zeros(B, dtype=torch.int32,
                                             device=dev)),
                           ("S-1", torch.full((B,), S - 1, dtype=torch.int32,
                                              device=dev)),
                           ("mixed", torch.tensor([70, S - 2][:B] + [5] * (
                               B - 2), dtype=torch.int32, device=dev))):
            out_buf, out = guarded(B * H * hd, dev, dt)
            part_buf, part = guarded(da.part_size(B, H, hd, n_chunks), dev)
            da.KERNEL.launch(fn, dev, out.data_ptr(), part.data_ptr(),
                             q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             pos.data_ptr(), B, S, H, Kv, hd, n_chunks,
                             1.0 / math.sqrt(hd), stream)
            label = f"{kid} {fn} pos={pname}"
            written[kid][f"{fn} pos={pname}"] = (
                check_written(label, chunk_geo, "part", part_buf)
                + check_written(label, combine_geo, "out", out_buf))

    for kid, fn in (("swa_attention.swa_attention", "swa_attention_f32"),
                    ("swa_attention.swa_attention_bf16",
                     "swa_attention_bf16")):
        B, S, H, Kv, hd, dt = KERNEL_CASES[kid].args
        q, k, v = (x.to(dt) for x in (randn(B, S, H, hd), randn(B, S, Kv, hd),
                                      randn(B, S, Kv, hd)))
        buf, out = guarded(B * S * H * hd, dev, dt)
        sa.KERNEL.launch(fn, dev, out.data_ptr(), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), B, S, H, Kv, hd, S,
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
    from repro_torch.core.codegen import codegen_fingerprint
    log(f"codegen: fingerprint of this card {codegen_fingerprint(dev)}")

    k2 = phase_kernels(dev)
    k1 = phase_ring_kernel(dev)
    k4 = phase_decode_kernel(dev)
    k5 = phase_swa_kernel(dev)
    k3 = phase_ce_kernel(dev)
    mark("kernel phases")
    f1_before = racy_kernel.KERNEL.launches
    host_merges = phase_main()
    mark("host engines")
    fleet_chains = phase_fleet()
    mark("fleet engine")
    corridor_chains, corridor_merges, _ = phase_corridor(dev)
    mark("corridor")
    selection_chains, selection_merges = phase_selection(dev)
    mark("selection")
    fault_chains, fault_merges = phase_faults(dev)
    mark("faults")
    # K1 runs on four main paths: the fleet engine's chains, the
    # corridor's per-RSU chains, both under vehicle selection and both
    # under fault injection
    k1["launches"] = (fleet_chains + corridor_chains + selection_chains
                      + fault_chains)
    k1["launches_by_path"] = {"fleet engine": fleet_chains,
                              "corridor": corridor_chains,
                              "selection": selection_chains,
                              "faults": fault_chains}
    k4["launches"], k5["launches"] = phase_serve(dev)
    mark("serve")
    # K4 and K5 also serve the dense archs (ring caches, QKV biases,
    # frontends): one path per model
    arch_k4, arch_k5, k5_rows, k4_rows = phase_archs(dev)
    mark("archs")
    # the MoE + MLA archs (deepseek's MLA takes neither K4 nor K5) and the
    # training side (K3 once a step under each checkpoint policy)
    moe_k4, moe_k5, moe_k3 = phase_moe(dev)
    mark("moe")
    # the SSM archs: jamba's attention layer takes K5 and K4, rwkv6 neither;
    # K3 once a training step
    ssm_k4, ssm_k5, ssm_k3 = phase_ssm(dev)
    mark("ssm")
    # llama3-405b over 4 layers: K5 once a layer, K4 once a layer a tick,
    # both at G 16
    llama3_k4, llama3_k5, llama3_rows = phase_llama3(dev)
    mark("llama3")
    arch_k4.update(llama3_k4)
    arch_k5.update(llama3_k5)
    k4_rows.update(llama3_rows)
    arch_k4.update(moe_k4)
    arch_k5.update(moe_k5)
    arch_k4.update(ssm_k4)
    arch_k5.update(ssm_k5)
    k4["launches_by_path"] = {"serve smollm-360m": k4["launches"], **arch_k4}
    k5["launches_by_path"] = {"serve smollm-360m": k5["launches"], **arch_k5}
    k4["launches"] += sum(arch_k4.values())
    k5["launches"] += sum(arch_k5.values())
    k4["geometries"].update(k4_rows)
    k5["geometries"].update(k5_rows)
    k3["launches"], train_merges = phase_train(dev)
    mark("train")
    k3["launches_by_path"] = {"train smollm-360m": k3["launches"],
                              "moe train deepseek-v2-lite-16b 5 layers":
                              moe_k3,
                              "ssm train rwkv6-1.6b 4 layers": ssm_k3}
    k3["launches"] += moe_k3 + ssm_k3
    # F1 is a fixture: no main path launches it
    f1_main = racy_kernel.KERNEL.launches - f1_before
    check(f1_main == 0,
          f"racy_sum launched {f1_main} times on the main paths")
    phase_train_step(dev)
    mark("train step")
    # the sharded step on a one-rank mesh: K3 once a microbatch, on the
    # rank's local rows
    shard_k3 = phase_shard_train(dev)
    mark("shard train")
    k3["launches"] += shard_k3
    k3["launches_by_path"]["shard train deepseek-v2-lite-16b reduced"] = \
        shard_k3
    phase_host("serial")
    phase_host("jit")
    phase_corridor_vs_cpu()
    phase_selection_vs_cpu()
    phase_faults_vs_cpu()
    mark("card against CPU (host, corridor, selection, faults)")
    telemetry_chains, telemetry_merges = phase_telemetry()
    mark("telemetry")
    sweep_chains = phase_sweep()
    mark("sweep")
    phase_sweep_vs_cpu()
    mark("sweep card against CPU")
    pytree_merges, k2_device_form = phase_pytree(dev)
    mark("pytree")
    phase_pytree_vs_cpu()
    mark("pytree card against CPU")
    mesh_k1, mesh_k2 = phase_mesh(dev)
    mark("mesh")
    phase_serve_vs_cpu(dev)
    phase_train_vs_cpu(dev)
    mark("card against CPU (serve, train)")
    # after every host-clock timing of the main paths (its host-side probe
    # runs the CPU fleet engine), before the profiler readings
    f1 = phase_check(dev)
    mark("check")
    f1["launches"] = f1_main
    f1["launches_by_path"]["main paths"] = f1_main
    # K1 and K2 under telemetry: the metrics-on runs of phase_telemetry
    # (their launches equal the metrics-off runs').  K2 runs on seven main
    # paths: the host engines' merges, the corridor's (EMA reconciles,
    # serial handover merges), those under vehicle selection and under
    # fault injection (kept merges only), training's, telemetry's (none:
    # its corridor worlds reconcile by FedAvg) and the pytree programs'
    # (one a pop under use_kernel, plus the EMA reconciles)
    k1["launches"] += telemetry_chains + sweep_chains + mesh_k1
    k1["launches_by_path"]["telemetry"] = telemetry_chains
    k1["launches_by_path"]["sweep"] = sweep_chains
    # the mesh phase: world 1 in this process, world 2 summed over its
    # ranks (each runs the plan's chains and merges its own cohorts' pops)
    k1["launches_by_path"]["mesh"] = mesh_k1
    k2["launches"] = (host_merges + corridor_merges + selection_merges
                      + fault_merges + train_merges + telemetry_merges
                      + pytree_merges + mesh_k2)
    k2["launches_by_path"] = {"host engines": host_merges,
                              "corridor": corridor_merges,
                              "selection": selection_merges,
                              "faults": fault_merges,
                              "training": train_merges,
                              "telemetry": telemetry_merges,
                              "sweep": 0,
                              "pytree": pytree_merges,
                              "mesh": mesh_k2}
    # K2's two forms: scalars as kernel parameters (the host engines, the
    # reconciles, training) and read on the card (the pytree programs'
    # merges, each pop's weight a device value)
    k2["forms"] = {"device scalars": k2_device_form}
    k1["launches_by_path"]["pytree"] = 0
    profile_run("corridor-r8-k4000", "corridor", 40)
    before = launch_us(dev)
    for measure in PROFILED:            # every profiler reading, last
        measure()
    mark("profiler readings")
    log(f"launch cost: {before:.3f} us per tiny launch before the profiler "
        f"readings, {launch_us(dev):.3f} us after them")
    for rec in (k2, k1, k4, k5, k3):    # the main shape's device time
        rec["device_ms"] = rec["geometries"][rec["shape"]]["device_ms"]

    log(json.dumps({"kernels": [k2, k1, k4, k5, k3, f1]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
