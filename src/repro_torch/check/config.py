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
    "repro_torch/core/flat.py",
    "repro_torch/kernels/weighted_agg/ops.py",
    "repro_torch/kernels/cross_entropy/ops.py",
    "repro_torch/kernels/decode_attention/ops.py",
    "repro_torch/kernels/swa_attention/ops.py",
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
        "_SlotQueue.pop", "_SlotQueue.upload_delay", "_event_segment",
        "_chain_segment", "_run_program"),
    "repro_torch/models/transformer.py": ("decode_step",),
    "repro_torch/models/attention.py": ("attention_decode",),
    "repro_torch/launch/steps.py": (
        "make_train_step", "make_prefill_step", "make_serve_step",
        "make_mafl_step"),
    "repro_torch/serving/batcher.py": ("BatchedServer.tick",
                                       "BatchedServer._admit"),
}

# Planner modules: pure f64 host numpy, no engine/kernel imports, no torch
# (PLN001/PLN002).  None of the port's own is ported yet (corridor/plan.py
# waits for item 7, selection/ for item 8); the bad-planner fixture is
# linted as one.
PLANNER_MODULES = ("repro_torch/check/corpus/bad_planner.py",)

# Planner functions living inside engine modules: the f64 dry runs.  The
# PLN rules apply to these function bodies only, not their whole module.
PLANNER_FUNCTIONS = {
    "repro_torch/core/jit_engine.py": ("plan_fleet",),
}

# Imports a planner may take from repro_torch.*: everything else under
# repro_torch (and torch) is engine internals from the planner's view.
PLANNER_ALLOWED_IMPORTS = (
    "repro_torch.channel",
    "repro_torch.core.mafl",    # _Timeline: the shared f64 event-queue replay
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
