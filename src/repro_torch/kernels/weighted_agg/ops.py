"""Wrappers of the fused aggregation kernels (``csrc/weighted_agg.cu`` and
``csrc/ring_agg.cu``).

``weighted_agg`` takes one leaf; ``weighted_agg_tree`` maps it over two
param dicts with the same keys.  ``ring_agg`` streams a chain of U mixes
over packed ``[P]`` buffers (the fleet engine's aggregation).  On a CPU
tensor each wrapper runs its plain version (``ref``); on a CUDA tensor it
launches its kernel — one launch per leaf or per chain — or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.geometry import GRIDS_ARG, LaunchGeometry, Output
from repro_torch.kernels.weighted_agg import ref

LANE = 128      # ring_agg's buffers are ParamLayout buffers: P % LANE == 0
# launch constants of csrc/weighted_agg.cu and csrc/ring_agg.cu
THREADS = 256
MAX_BLOCKS = 132 * 8

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_EXPORTS = {torch.float32: "weighted_agg_f32",
            torch.bfloat16: "weighted_agg_bf16"}

KERNEL = CudaKernel("weighted_agg", "weighted_agg.cu",
                    {**{fn: _ARGS for fn in _EXPORTS.values()},
                     "weighted_agg_geometry": [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int, GRIDS_ARG]})

# (device, out, g, locs, coeffs, P, U, stream)
_RING_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_void_p]
_RING_EXPORTS = {torch.float32: "ring_agg_f32",
                 torch.bfloat16: "ring_agg_bf16"}

RING_KERNEL = CudaKernel("ring_agg", "ring_agg.cu",
                         {**{fn: _RING_ARGS for fn in _RING_EXPORTS.values()},
                          "ring_agg_geometry": [ctypes.c_int64, ctypes.c_int,
                                                GRIDS_ARG]})


def geometry(n: int, dtype, aligned: bool) -> list[LaunchGeometry]:
    """The launch of ``weighted_agg`` on ``n`` elements of ``dtype``
    (``csrc/weighted_agg.cu:launch``): a grid-stride loop over 16-byte
    packs when ``out``, ``g`` and ``l`` are all 16-byte aligned, then over
    the scalar tail; thread ``t`` of block ``b`` takes pack (or element)
    ``b * THREADS + t`` and every ``blocks * THREADS``-th after it."""
    pack = 16 // dtype.itemsize
    n_pack = n // pack if aligned else 0
    tail = n - n_pack * pack
    blocks = min(max(-(-max(n_pack, tail) // THREADS), 1), MAX_BLOCKS)
    stride = blocks * THREADS

    def ranges(block):
        first = block[0] * THREADS
        out = [(i * pack, min(i + THREADS, n_pack) * pack)
               for i in range(first, n_pack, stride)]
        out += [(i, min(i + THREADS, n))
                for i in range(n_pack * pack + first, n, stride)]
        return out
    return [LaunchGeometry("weighted_agg_kernel", (blocks,), THREADS,
                           {"out": Output(n, ranges)})]


def cu_grids(n: int, dtype, aligned: bool) -> list[tuple]:
    """The grids ``csrc/weighted_agg.cu`` computes for the same arguments
    (its ``weighted_agg_geometry`` export; needs the built library)."""
    return KERNEL.grids("weighted_agg_geometry", 1, n, dtype.itemsize,
                        int(aligned))


def ring_geometry(P: int, U: int, dtype) -> list[LaunchGeometry]:
    """The launch of ``ring_agg`` over a ``[P]`` buffer and U upload rows
    of ``dtype`` (``csrc/ring_agg.cu:launch``): thread ``t`` of block ``b``
    owns the 16-byte pack of upload elements ``(b * THREADS + t) * elems``
    onward for the whole chain.  ``U == 0`` launches nothing."""
    if U == 0:
        return []
    per_block = THREADS * (16 // dtype.itemsize)

    def ranges(block):
        return [(block[0] * per_block, min((block[0] + 1) * per_block, P))]
    return [LaunchGeometry("ring_agg_kernel", (-(-P // per_block),), THREADS,
                           {"out": Output(P, ranges)})]


def ring_cu_grids(P: int, U: int, dtype) -> list[tuple]:
    """The grids ``csrc/ring_agg.cu`` computes for the same arguments."""
    if U == 0:
        return []
    return RING_KERNEL.grids("ring_agg_geometry", 1, P, dtype.itemsize)


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


def _check_ring_inputs(g, locs, coeffs) -> None:
    if g.dtype != torch.float32 or g.dim() != 1 or not g.is_contiguous():
        raise ValueError(
            f"ring_agg: g must be a contiguous f32 [P] buffer; got "
            f"{tuple(g.shape)} {g.dtype} contiguous={g.is_contiguous()}")
    P = g.shape[0]
    if P % LANE:
        raise ValueError(f"ring_agg: P={P} is not a multiple of {LANE} "
                         "(a ParamLayout buffer)")
    if locs.dim() != 2 or locs.shape[1] != P:
        raise ValueError(f"ring_agg: locs must be [U, {P}]; got "
                         f"{tuple(locs.shape)}")
    if locs.dtype not in _RING_EXPORTS:
        raise TypeError(f"ring_agg: locs dtype {locs.dtype}; expected one "
                        f"of {list(_RING_EXPORTS)}")
    if not locs.is_contiguous():
        raise ValueError("ring_agg: locs must be contiguous rows")
    U = locs.shape[0]
    if (coeffs.dtype != torch.float32 or tuple(coeffs.shape) != (U, 2)
            or not coeffs.is_contiguous()):
        raise ValueError(
            f"ring_agg: coeffs must be a contiguous f32 [{U}, 2] tensor; "
            f"got {tuple(coeffs.shape)} {coeffs.dtype} "
            f"contiguous={coeffs.is_contiguous()}")
    if not g.device == locs.device == coeffs.device:
        raise ValueError(f"ring_agg: g, locs and coeffs on {g.device}, "
                         f"{locs.device}, {coeffs.device}")


def ring_agg(g, locs, coeffs):
    """Fused multi-upload chain over packed flat buffers (DESIGN.md §12):
    ``acc <- c_u*acc + d_u*locs[u]`` for u = 0..U-1 from ``acc = g``, in
    f32; returns a new f32 ``[P]`` tensor and never writes its inputs.

    ``g``: contiguous f32 ``[P]``, ``P % 128 == 0``; ``locs``: contiguous
    ``[U, P]`` f32 or bf16; ``coeffs``: contiguous f32 ``[U, 2]`` of
    ``(c, d)`` pairs on the same device (the host never reads them).
    ``U == 0`` returns a copy of ``g`` and launches nothing."""
    _check_ring_inputs(g, locs, coeffs)
    U, P = locs.shape
    if U == 0:
        return g.to(torch.float32, copy=True)
    if g.device.type == "cpu":
        return ref.ring_agg(g, locs, coeffs)
    if g.device.type != "cuda":
        raise ValueError(f"ring_agg: unsupported device {g.device}")
    out = torch.empty_like(g)
    # 16-byte packs of g, locs rows and out; 8-byte (c, d) pairs.  Rows are
    # P apart with P % 128 == 0, so an aligned base aligns every row.
    if ((g.data_ptr() | locs.data_ptr() | out.data_ptr()) & 15
            or coeffs.data_ptr() & 7):
        raise ValueError("ring_agg: g and locs must start 16-byte aligned "
                         "and coeffs 8-byte aligned")
    RING_KERNEL.launch(_RING_EXPORTS[locs.dtype], g.device, out.data_ptr(),
                       g.data_ptr(), locs.data_ptr(), coeffs.data_ptr(), P,
                       U, torch.cuda.current_stream(g.device).cuda_stream)
    return out


def prefix_weights(coeffs) -> np.ndarray:
    """The chain's closed form: weights ``w[U+1]`` (f64) such that

        ring_agg(g, locs, coeffs) ~= w[0]*g + sum_u w[1+u]*locs[u]

    with ``w[0] = prod_u c_u`` and ``w[1+u] = d_u * prod_{v>u} c_v``.
    Equality is algebraic, not bitwise: evaluating this form reassociates
    the f32 arithmetic, which is why the kernel evaluates the chain in
    order."""
    c = np.asarray(coeffs, np.float64)
    U = c.shape[0]
    w = np.empty(U + 1)
    suffix = 1.0
    for u in range(U - 1, -1, -1):
        w[1 + u] = c[u, 1] * suffix
        suffix *= c[u, 0]
    w[0] = suffix
    return w
