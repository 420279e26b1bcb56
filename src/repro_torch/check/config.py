"""What the analyzers scan and where the module-role boundaries sit: the
port's copy of ``repro.check.config``.

Paths are matched by suffix against posix-style repo-relative paths, so the
CLI works from the repo root (``python -m repro_torch.check src/repro_torch``)
or any parent.
"""
from __future__ import annotations

# Engine modules: the device-resident loops and the kernel wrappers they
# call.  The boundary lint's rules apply to every scanned file; these are the
# modules a test holds to a clean lint after waivers.
ENGINE_MODULES = (
    "repro_torch/core/jit_engine.py",
    "repro_torch/core/sweep.py",
    "repro_torch/corridor/engine.py",
    "repro_torch/core/flat.py",
    "repro_torch/kernels/weighted_agg/ops.py",
    "repro_torch/kernels/cross_entropy/ops.py",
    "repro_torch/kernels/decode_attention/ops.py",
    "repro_torch/kernels/swa_attention/ops.py",
    "repro_torch/telemetry/device.py",
)

# Device-loop functions: the port runs eagerly, so nothing marks device code
# structurally the way jax.jit does in repro.  These are the functions whose
# every call issues device work in a loop, where a host sync stalls the
# card; a host sync in them is a finding.  ``Class.method`` names a method;
# defs nested in a listed function (the steps a builder returns) are device
# loop too.  Bodies handed to torch.func.vmap / grad, T.value_and_grad or
# torch.utils.checkpoint are found in any scanned file without listing.
DEVICE_LOOP_FUNCTIONS = {
    "repro_torch/core/jit_engine.py": (
        "_SlotQueue.pop", "_SlotQueue.upload_delay", "_SlotQueue.admit",
        "_SlotQueue.readmit", "_pop_segment", "_event_segment",
        "keep_coeffs", "_chain_segment", "_run_program", "_run_pytree",
        "_train_wave"),
    "repro_torch/core/aggregation.py": ("arrival_mix",),
    "repro_torch/core/sweep.py": (
        "_SweepQueue.pop", "_SweepQueue.upload_delay", "_SweepQueue.readmit",
        "_div_sigma2", "_event_segment", "_train_group", "_run_program"),
    "repro_torch/corridor/engine.py": (
        "_CorridorQueue.pop", "_CorridorQueue.upload_delay",
        "_CorridorQueue.readmit", "_CorridorQueue.wrap",
        "_CorridorQueue.serving", "_pop_segment", "_chain_segment",
        "_stack_mean", "_reconcile", "_share_ring", "_run_program",
        "_run_pytree"),
    "repro_torch/launch/mesh.py": ("psum_", "_flat", "_split", "pmean_tree",
                                   "share_rows"),
    "repro_torch/core/hierarchical.py": ("pod_local_mafl",
                                         "cross_pod_reconcile"),
    "repro_torch/telemetry/device.py": (
        "stale_bin", "_fold", "fleet_pop", "corridor_pop", "RingStats.count",
        "RingStats.wrap"),
    "repro_torch/models/transformer.py": ("decode_step", "forward_hidden",
                                          "_run_stack", "PeriodBlock.forward",
                                          "prefill"),
    "repro_torch/models/attention.py": ("attention_decode", "mla_fwd",
                                        "mla_decode"),
    "repro_torch/models/moe.py": ("_router", "moe_fwd", "moe_decode"),
    "repro_torch/models/rwkv.py": ("time_mix_fwd", "time_mix_decode",
                                   "channel_mix_fwd", "channel_mix_decode"),
    "repro_torch/models/mamba.py": ("mamba_fwd", "mamba_decode"),
    "repro_torch/models/modules.py": ("chunked_scan",),
    "repro_torch/optim/optimizers.py": ("sgd", "momentum_sgd", "adam",
                                        "apply_updates", "global_norm",
                                        "clip_by_global_norm"),
    "repro_torch/optim/schedule.py": ("constant", "cosine_decay",
                                      "linear_warmup_cosine"),
    "repro_torch/launch/serve.py": ("generate",),
    "repro_torch/launch/steps.py": (
        "make_train_step", "make_prefill_step", "make_serve_step",
        "make_mafl_step"),
    "repro_torch/serving/batcher.py": ("BatchedServer.tick",
                                       "BatchedServer._admit"),
}

# Planner modules: pure f64 host numpy, no engine/kernel imports, no torch
# (PLN001/PLN002).  selection/runtime.py is the f64 selection replay every
# planner runs; the telemetry spec and replay are plan data and the channel
# oracle; the bad-planner fixture is linted as one.
PLANNER_MODULES = (
    "repro_torch/corridor/plan.py",
    "repro_torch/selection/runtime.py",
    "repro_torch/telemetry/spec.py",
    "repro_torch/telemetry/replay.py",
    "repro_torch/check/corpus/bad_planner.py",
)

# Fault planner modules (FLT001, DESIGN.md §16): the stochastic client-state
# sampler, its replays and the composition helpers every planner runs are
# planners too — the same lint as PLN001/PLN002, reported under FLT001.
FAULT_PLANNER_MODULES = (
    "repro_torch/faults/__init__.py",
    "repro_torch/faults/spec.py",
    "repro_torch/faults/runtime.py",
    "repro_torch/faults/replay.py",
)

# Planner functions living inside engine modules: the f64 dry runs.  The
# PLN rules apply to these function bodies only, not their whole module.
PLANNER_FUNCTIONS = {
    "repro_torch/core/jit_engine.py": ("plan_fleet",),
}

# Imports a planner may take from repro_torch.*: everything else under
# repro_torch (and torch) is engine internals from the planner's view.
PLANNER_ALLOWED_IMPORTS = (
    "repro_torch.channel",
    "repro_torch.selection",
    "repro_torch.faults",       # fault tables and the composition helpers
    "repro_torch.core.mafl",    # _Timeline: the shared f64 event-queue replay
    "repro_torch.telemetry",    # MetricsSpec is plan data (DESIGN.md §14)
)

# The known-positive fixture corpus is deliberately broken; default scans
# skip it (tests point the analyzers at it explicitly).
EXCLUDE_PARTS = ("repro_torch/check/corpus/",)


def is_excluded(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(part in p for part in EXCLUDE_PARTS)


def matches(path: str, suffixes) -> bool:
    p = path.replace("\\", "/")
    return any(p.endswith(s) for s in suffixes)
