"""Wrappers of the fused aggregation kernel (``csrc/weighted_agg.cu``).

``weighted_agg`` takes one leaf; ``weighted_agg_tree`` maps it over two
param dicts with the same keys.  On a CPU tensor the wrapper runs the plain
version (``ref.weighted_agg``); on a CUDA tensor it launches the kernel —
one launch per leaf, whatever its size — or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.weighted_agg import ref

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_EXPORTS = {torch.float32: "weighted_agg_f32",
            torch.bfloat16: "weighted_agg_bf16"}

KERNEL = CudaKernel("weighted_agg", "weighted_agg.cu",
                    {fn: _ARGS for fn in _EXPORTS.values()})


def weighted_agg(g, l, beta: float, weight: float):
    """out = beta*g + ((1-beta)*weight)*l in f32, cast to ``g.dtype``."""
    if g.shape != l.shape or g.dtype != l.dtype or g.device != l.device:
        raise ValueError(
            f"weighted_agg: g and l must match in shape, dtype and device; "
            f"got {tuple(g.shape)} {g.dtype} {g.device} and "
            f"{tuple(l.shape)} {l.dtype} {l.device}")
    if g.dtype not in _EXPORTS:
        raise TypeError(f"weighted_agg: unsupported dtype {g.dtype}; "
                        f"expected one of {list(_EXPORTS)}")
    if g.device.type == "cpu":
        return ref.weighted_agg(g, l, beta, weight)
    if g.device.type != "cuda":
        raise ValueError(f"weighted_agg: unsupported device {g.device}")
    if not (g.is_contiguous() and l.is_contiguous()):
        raise ValueError("weighted_agg: g and l must be contiguous")
    b, coef = ref.agg_scalars(beta, weight)
    out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    if g.numel():
        KERNEL.launch(_EXPORTS[g.dtype], g.device, out.data_ptr(),
                      g.data_ptr(), l.data_ptr(), g.numel(), b, coef,
                      torch.cuda.current_stream(g.device).cuda_stream)
    return out


def weighted_agg_tree(global_params, local_params, beta: float,
                      weight: float):
    """Drop-in for ``aggregation.mafl_update(..., use_kernel=True)``."""
    return {k: weighted_agg(g, local_params[k], beta, weight)
            for k, g in global_params.items()}
