"""Wrapper of K3, the per-row cross-entropy kernel
(``csrc/cross_entropy.cu``), and the mean next-token loss of the training
path.

``nll_and_lse`` takes its plain version (``ref``) on a CPU tensor; on a
CUDA tensor it launches the kernel, one launch per call, or raises.
``cross_entropy`` wraps it in a ``torch.autograd.Function`` (the
``setup_context`` form, so ``torch.func`` transforms take it too) whose
backward is torch ops on the saved logits and log-sum-exp, the same code on
both devices: ``repro`` has no backward kernel either (XLA differentiates
its ``log_softmax``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, current_stream
from repro_torch.kernels.cross_entropy import ref
from repro_torch.kernels.geometry import GRIDS_ARG, LaunchGeometry, Output

# (device, logits, labels, nll, lse, R, V, stream)
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
_EXPORTS = {torch.float32: "cross_entropy_f32",
            torch.bfloat16: "cross_entropy_bf16"}
_LABEL_DTYPES = (torch.int32, torch.int64)
MAX_ROWS = 2 ** 31 - 1            # one block per row on the grid's x axis
THREADS = 256

KERNEL = CudaKernel("cross_entropy", "cross_entropy.cu",
                    {**{fn: _ARGS for fn in _EXPORTS.values()},
                     "cross_entropy_geometry": [ctypes.c_int64, GRIDS_ARG]})


def geometry(R: int, V: int) -> list[LaunchGeometry]:
    """The launch of ``nll_and_lse`` on ``[R, V]`` logits
    (``csrc/cross_entropy.cu:launch``): block ``r`` walks row ``r`` and
    writes ``nll[r]`` and ``lse[r]``.  ``R == 0`` launches nothing."""
    if R == 0:
        return []

    def row(block):
        return [(block[0], block[0] + 1)]
    return [LaunchGeometry("cross_entropy_kernel", (R,), THREADS,
                           {"nll": Output(R, row), "lse": Output(R, row)})]


def cu_grids(R: int, V: int) -> list[tuple]:
    """The grids ``csrc/cross_entropy.cu`` computes for the same
    arguments."""
    return KERNEL.grids("cross_entropy_geometry", 1, R)


def _check(logits, labels):
    if logits.dim() != 2 or labels.dim() != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"cross_entropy: logits must be [R, V] and labels [R]; got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.shape[1] == 0:
        raise ValueError("cross_entropy: V must be at least 1")
    if logits.dtype not in _EXPORTS:
        raise TypeError(f"cross_entropy: logits must be one of "
                        f"{list(_EXPORTS)}; got {logits.dtype}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"cross_entropy: labels must be one of "
                        f"{list(_LABEL_DTYPES)}; got {labels.dtype}")
    if logits.device != labels.device:
        raise ValueError(f"cross_entropy: logits on {logits.device}, labels "
                         f"on {labels.device}")


def nll_and_lse(logits, labels):
    """logits [R, V] (f32 or bf16), labels [R] (int32 or int64) -> (nll,
    lse), both f32 [R]: ``lse = log sum exp(x)``, ``nll = lse - x[label]``.
    A label outside ``[0, V)`` gives NaN on the card; labels are not checked
    on the host (that would wait for the card)."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return ref.nll_and_lse(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"cross_entropy: unsupported device {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("cross_entropy: logits must be contiguous")
    R, V = logits.shape
    if R > MAX_ROWS:
        raise ValueError(f"cross_entropy: {R} rows exceed {MAX_ROWS}")
    labels = labels.to(torch.int32).contiguous()     # on the device
    nll = torch.empty(R, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    KERNEL.launch(_EXPORTS[logits.dtype], logits.device, logits.data_ptr(),
                  labels.data_ptr(), nll.data_ptr(), lse.data_ptr(), R, V,
                  current_stream(logits.device))
    return nll, lse


def grad_logits(logits, labels, lse, g):
    """d/d logits of ``sum_r g[r] * nll[r]``: ``g * (exp(x - lse) -
    one_hot(label))``, in the logits' dtype."""
    d = torch.exp(logits.float() - lse[:, None])
    d.mul_(g[:, None])
    d.scatter_add_(1, labels.long()[:, None], -g[:, None])
    return d.to(logits.dtype)


class CrossEntropy(torch.autograd.Function):
    """``(logits, labels) -> (nll, lse)``; only ``nll`` is differentiable."""

    @staticmethod
    def forward(logits, labels):
        if logits.device.type == "meta":    # shapes only (kernels/meta.py)
            return torch.ops.repro_torch.cross_entropy(logits, labels)
        return nll_and_lse(logits, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(logits, labels, output[1])

    @staticmethod
    def backward(ctx, g, _g_lse):
        logits, labels, lse = ctx.saved_tensors
        return grad_logits(logits, labels, lse, g), None


def cross_entropy(logits, labels):
    """logits [R, V], labels [R] -> per-row NLL [R] f32, differentiable in
    ``logits``."""
    return CrossEntropy.apply(logits, labels)[0]


def lm_loss(logits, targets, *, use_kernel=True):
    """Mean next-token NLL for [B, S, V] logits vs [B, S] targets.
    ``use_kernel=False`` takes ``ref.cross_entropy`` (plain autograd).
    ``repro``'s ``interpret`` argument has no counterpart: the wrapper
    follows the logits' device.  DTensor logits take the kernel on each
    rank's rows: batch rows over the batch axes, the vocab gathered; the
    mean of the rows' NLL is then DTensor's."""
    # imported here: the sharding package imports the models, which import
    # this module
    from repro_torch.sharding import dtensor as dt
    if dt.is_dtensor(logits):
        rows = dt.layout(logits.device_mesh, logits.shape,
                         {0: dt.BATCH_AXES})
        nll = dt.on_shards(
            lambda lg, tg: _rows_nll(lg, tg, use_kernel),
            (logits, dt.like(logits, targets)), (rows, rows), rows)
        return dt.replicate(nll.mean())
    return _rows_nll(logits, targets, use_kernel).mean()


def _rows_nll(logits, targets, use_kernel):
    """[B, S] next-token NLL of [B, S, V] logits."""
    B, S, V = logits.shape
    flat_l = logits.reshape(B * S, V)
    flat_t = targets.reshape(B * S)
    if use_kernel:
        nll = cross_entropy(flat_l, flat_t)
    else:
        nll = ref.cross_entropy(flat_l, flat_t)
    return nll.reshape(B, S)
