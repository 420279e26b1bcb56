"""Dtype-flow checker (DTF rules): the counterpart of
``repro.check.dtype_flow``, which walks the staged jaxprs.

The bf16 snapshot-ring contract (DESIGN.md §12) is: bf16 is a *storage*
dtype only.  Ring rows and upload rows may hold bf16, but every arithmetic
consumer (the mix chain, local training, evaluation) widens to f32 first.
The port runs eagerly, so there is no staged program to walk; instead a
``TorchDispatchMode`` records every aten op of a real
``run_scenario(engine="jit")`` run on quick-k5 and checks each op that
reads or writes bf16: ops that only move data (copies, conversions, views,
index select/copy, concatenation, allocation) may; a matrix product or
convolution is DTF001, any other op DTF002; in an f32-ring run any bf16 at
all is DTF003.

The probe runs on the CPU.  There every op of the run passes through the
dispatcher, the ``ring_agg`` chain's plain version included; on a card the
chain is a ctypes launch of the CUDA kernel, which the mode cannot see.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.check.findings import Finding

# aten ops that relocate, convert or allocate values without arithmetic on
# them: the only places the storage dtype may appear (views are recognised
# by their schema, ``OpOverload.is_view``)
MOVEMENT_OPS = frozenset({
    "_to_copy", "copy_", "clone", "index_select", "index_copy_",
    "index_copy", "cat", "stack", "empty", "empty_like", "empty_strided",
    "new_empty", "zeros", "zeros_like", "new_zeros", "zero_", "fill_",
    "full", "lift_fresh", "detach", "alias", "constant_pad_nd",
    "_unsafe_view", "contiguous",
})
CONTRACTION_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "mv", "addmv",
    "convolution", "_convolution", "convolution_backward",
    "cudnn_convolution", "mkldnn_convolution",
})


def _has_bf16(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bfloat16
    if isinstance(x, (list, tuple)):
        return any(_has_bf16(v) for v in x)
    if isinstance(x, dict):
        return any(_has_bf16(v) for v in x.values())
    return False


class OpRecorder(TorchDispatchMode):
    """Counts every aten op that reads or writes bf16, by op name."""

    def __init__(self):
        super().__init__()
        self.bf16_ops: dict[str, int] = {}
        self.views: set[str] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _has_bf16(args) or _has_bf16(kwargs) or _has_bf16(out):
            name = func.overloadpacket.__name__
            self.bf16_ops[name] = self.bf16_ops.get(name, 0) + 1
            if func.is_view:
                self.views.add(name)
        return out


def check_ops(rec: OpRecorder, *, allow_bf16: bool,
              path: str) -> list[Finding]:
    """DTF findings for one recorded run: one finding per (rule, op) with
    an occurrence count (one bad chain shows up in hundreds of ops)."""
    counts: dict = {}
    for op, n in rec.bf16_ops.items():
        if not allow_bf16:
            rule = "DTF003"
        elif op in CONTRACTION_OPS:
            rule = "DTF001"
        elif op in MOVEMENT_OPS or op in rec.views:
            continue
        else:
            rule = "DTF002"
        counts[(rule, op)] = counts.get((rule, op), 0) + n
    what = {"DTF001": "contraction consumes bf16 operands",
            "DTF002": "arithmetic on bf16 (storage dtype escaped into "
                      "compute)",
            "DTF003": "bf16 present in an f32-ring run"}
    return [Finding(rule, path, 0, f"{what[rule]}: op {op!r} x{n}")
            for (rule, op), n in sorted(counts.items())]


def _jit_probe(ring_dtype: str) -> list[Finding]:
    from repro_torch.core.scenarios import run_scenario

    with OpRecorder() as rec:
        run_scenario("quick-k5", engine="jit", ring_dtype=ring_dtype,
                     rounds=6, l_iters=1, eval_every=3, device="cpu")
    return check_ops(rec, allow_bf16=ring_dtype == "bf16",
                     path=f"<probe:jit-flat-{ring_dtype}>")


def probe_dtype_flow() -> list[Finding]:
    """Run the fleet engine on quick-k5 with both rings and dtype-check
    every op: the f32 ring must be bf16-free, the bf16 ring bf16 in
    storage roles only."""
    return _jit_probe("f32") + _jit_probe("bf16")
