"""Wrapper of K5, the causal sliding-window attention kernel
(``csrc/swa_attention.cu``).

It takes the model's ``[B, S, H, hd]`` / ``[B, S, Kv, hd]`` layout directly.
On a CPU tensor it runs the plain version (``ref``); on a CUDA tensor it
launches the kernel, one launch per call, or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.geometry import GRIDS_ARG, LaunchGeometry, Output
from repro_torch.kernels.swa_attention import ref

HEAD_DIMS = (64, 128)          # the kernel's instantiations
THREADS = 256
BLOCK_Q = 64                   # query rows per block

# (device, out, q, k, v, B, S, H, Kv, hd, window, scale, stream)
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_void_p]
_EXPORTS = {torch.float32: "swa_attention_f32",
            torch.bfloat16: "swa_attention_bf16"}

KERNEL = CudaKernel("swa_attention", "swa_attention.cu",
                    {**{fn: _ARGS for fn in _EXPORTS.values()},
                     "swa_attention_geometry": [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, GRIDS_ARG]})


def geometry(B: int, S: int, H: int, Kv: int, hd: int
             ) -> list[LaunchGeometry]:
    """The launch of ``swa_attention`` (``csrc/swa_attention.cu:
    launch_hd``): block ``(query tile, head, batch row)`` writes head ``h``
    of the rows of its 64-row query tile (fewer in the last tile)."""
    def rows(block):
        qt, h, b = block
        out = []
        for i in range(qt * BLOCK_Q, min((qt + 1) * BLOCK_Q, S)):
            start = ((b * S + i) * H + h) * hd
            out.append((start, start + hd))
        return out
    return [LaunchGeometry("swa_kernel", (-(-S // BLOCK_Q), H, B), THREADS,
                           {"out": Output(B * S * H * hd, rows)})]


def cu_grids(B: int, S: int, H: int, Kv: int, hd: int) -> list[tuple]:
    """The grids ``csrc/swa_attention.cu`` computes for the same
    arguments."""
    return KERNEL.grids("swa_attention_geometry", 1, B, S, H)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"swa_attention: q must be [B, S, H, hd] and k, v [B, S, Kv, hd]; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd) \
            or H % k.shape[2]:
        raise ValueError(
            f"swa_attention: k/v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (same B, S, hd and H % Kv == 0)")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _EXPORTS:
        raise TypeError(f"swa_attention: q, k, v must share one dtype of "
                        f"{list(_EXPORTS)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"swa_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if window < 1:
        raise ValueError(f"swa_attention: window must be >= 1, got {window}")


def swa_attention(q, k, v, window: int):
    """q: [B, S, H, hd]; k, v: [B, S, Kv, hd] -> [B, S, H, hd].  Key j is
    visible to query i iff ``j <= i`` and ``i - j < window``; any S, any
    ``window >= 1`` (``window >= S`` is causal attention)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.swa_attention(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention: unsupported device {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa_attention: head dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("swa_attention: q, k and v must be contiguous")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15:
        raise ValueError("swa_attention: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    KERNEL.launch(_EXPORTS[q.dtype], q.device, out.data_ptr(), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), B, S, H, k.shape[2], hd,
                  min(int(window), S), 1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
