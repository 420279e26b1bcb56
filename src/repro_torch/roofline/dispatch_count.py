"""Per-device operation, collective and memory counts of one step, read
from the ops it dispatches: the counterpart of ``repro.roofline.hlo_parse``
(eager PyTorch has no HLO to parse).

:class:`DispatchCounter` is a ``TorchDispatchMode`` that sits *below*
DTensor: for an op on DTensors it returns ``NotImplemented``, so DTensor
runs the op and the mode sees what DTensor dispatches on each rank's local
tensors, the collectives among them.  (A mode that counted the DTensor op
itself would count the global product, not one device's share.)  Ops on
FakeTensors are DTensor's own shape propagation, not work, and are not
counted.  All numbers are PER DEVICE:

  * matmul FLOPs: ``2 * m * n * k`` for each ``mm``/``addmm``/``bmm``/
    ``baddbmm`` (times the batch), and each kernel's formula
    (``kernels/meta.py:FLOPS``) where a step calls one on ``meta`` tensors;
  * collective bytes by ``repro``'s five kinds with its ring conventions:
    all-reduce 2x its result, reduce-scatter its input, all-gather,
    all-to-all and collective-permute their result;
  * memory: bytes of the tensors the step creates that are alive at once
    (their storages, each counted once), at the peak.
"""
from __future__ import annotations

import time
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_DOTS = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2),
         _aten.bmm.default: (0, 1), _aten.baddbmm.default: (1, 2)}

# op name (``func.name()``) -> (kind, the bytes it moves: "result",
# "2x result" or "input")
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "result"),
    "_c10d_functional::all_gather_into_tensor_coalesced":
        ("all-gather", "result"),
    "_c10d_functional::all_reduce": ("all-reduce", "2x result"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "2x result"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "input"),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", "input"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "result"),
    "_dtensor::shard_dim_alltoall": ("all-to-all", "result"),
    "c10d::allreduce_": ("all-reduce", "2x result"),
    "c10d::_allgather_base_": ("all-gather", "result"),
    "c10d::allgather_": ("all-gather", "result"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "input"),
    "c10d::alltoall_base_": ("all-to-all", "result"),
    "c10d::broadcast_": ("collective-permute", "result"),
}


@dataclass
class DispatchStats:
    dot_flops: float = 0.0
    collective_bytes: dict = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    collective_counts: dict = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    ops: Counter = field(default_factory=Counter)   # op name -> calls

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


@dataclass
class MemoryStats:
    """One step's bytes on one device, under the field names of XLA's
    ``memory_analysis`` that ``roofline_terms`` reads: arguments (the local
    parameters, batch and cache), outputs, temporaries (the peak of what
    the step creates, outputs excluded) and outputs written into their
    arguments (a cache updated in place)."""
    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    temp_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat_tensors(items):
    """The tensors among ``items`` and the lists and tuples in them (an
    op's arguments or results: cheaper than a pytree walk)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def local_tensor(t):
    """A DTensor's local shard, or the tensor itself."""
    return getattr(t, "_local_tensor", t)


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``, each storage
    once."""
    seen = {}
    for t in _tensors(tree):
        lt = local_tensor(t)
        seen[_storage_key(lt)] = lt.untyped_storage().nbytes()
    return sum(seen.values())


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class DispatchCounter(TorchDispatchMode):
    """Counts what one device runs: see the module docstring.  ``known``
    are tensors alive before the step (arguments): views of them are not
    new memory."""

    def __init__(self, known=()):
        super().__init__()
        self.stats = DispatchStats()
        self._external = {_storage_key(local_tensor(t))
                          for t in _tensors(known)}
        self._live: dict[int, int] = {}
        self._refs: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs it; we see its ops
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _flat_tensors(args)):
            return out                      # DTensor's shape propagation
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, args, kwargs, out):
        from repro_torch.kernels.meta import FLOPS
        st = self.stats
        name = func.name()
        st.ops[name] += 1
        if func in _DOTS:
            i, j = _DOTS[func]
            a, b = args[i], args[j]
            batch = a.shape[0] if a.dim() == 3 else 1
            st.dot_flops += 2.0 * batch * a.shape[-2] * a.shape[-1] \
                * b.shape[-1]
        elif func in FLOPS:
            st.dot_flops += float(FLOPS[func](*args, **kwargs))
        elif name in _COLLECTIVE_OPS:
            kind, rule = _COLLECTIVE_OPS[name]
            if rule == "input":
                moved = _nbytes(args[0])
            else:
                moved = _nbytes(out) * (2 if rule == "2x result" else 1)
            st.collective_bytes[kind] += float(moved)
            st.collective_counts[kind] += 1

    def _track(self, out):
        for t in _flat_tensors(out if isinstance(out, (list, tuple))
                               else (out,)):
            key = _storage_key(t)
            if key in self._external:
                continue
            if key not in self._live:
                self._live[key] = t.untyped_storage().nbytes()
                self.live_bytes += self._live[key]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._refs[key] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        self._refs[key] -= 1
        if self._refs[key] == 0 and key in self._live:
            self.live_bytes -= self._live.pop(key)


def count_step(fn, *args, weights=(), in_place=()):
    """``fn(*args)`` under a :class:`DispatchCounter`.  ``weights``: the
    tensors the step reads that are not among ``args`` (a model's own
    parameters), counted as arguments; ``in_place``: the arguments the
    step writes into (a decode cache).  Returns ``(out, stats, memory,
    seconds)``."""
    counter = DispatchCounter(known=(args, weights))
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    arg_b = local_bytes((args, weights))
    alias_b = local_bytes(in_place)
    out_b = local_bytes(out)
    memory = MemoryStats(
        argument_size_in_bytes=arg_b, output_size_in_bytes=out_b,
        temp_size_in_bytes=max(counter.peak_bytes - (out_b - alias_b), 0),
        alias_size_in_bytes=alias_b)
    return out, counter.stats, memory, seconds
