"""Wrapper of K4, the one-token GQA decode attention kernel
(``csrc/decode_attention.cu``).

It reads ``q [B, H, hd]`` and the caches ``[B, S, Kv, hd]`` in the model's
layout, with a position per sequence.  On a CPU tensor it runs the plain
version (``ref``); on a CUDA tensor it launches the kernel, one launch per
call, or raises.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels.build import CudaKernel, current_stream
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.geometry import GRIDS_ARG, LaunchGeometry, Output

HEAD_DIMS = (64, 128)          # the kernel's instantiations
MAX_GROUP = 16                 # query heads per kv head: 1..8 and 16
GROUPS = (*range(1, 9), MAX_GROUP)   # 16: llama3-405b's 128 over 8
# the sequence split (csrc/decode_attention.cu:share_of): the live prefix
# of a row is cut into shares of whole KV_TILE-position tiles, one per
# (b, kv head, chunk) block; n_chunks makes the grid WAVE_BLOCKS blocks or
# more (several even waves of the H100's 132 SMs), at most one chunk a tile
SMS = 132
WAVE_BLOCKS = 16 * SMS
KV_TILE = 64
MAX_CHUNKS = 256               # chunks one combine block takes (kMaxChunks)

# (device, out, part, q, k, v, pos, B, S, H, Kv, hd, n_chunks, scale,
#  stream)
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_EXPORTS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}

THREADS = 128


def combine_threads(G: int) -> int:
    """Threads of a combine block (``combine_threads<G>``): a warp per
    head, at least 256."""
    return max(256, 32 * G)


KERNEL = CudaKernel("decode_attention", "decode_attention.cu",
                    {**{fn: _ARGS for fn in _EXPORTS.values()},
                     "decode_attention_geometry": [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_int, GRIDS_ARG]})


def split(B: int, S: int, Kv: int) -> int:
    """``n_chunks``: the blocks per (b, kv head).  Fixed by the shapes
    alone, so the host never reads ``pos``; each block takes its share of
    the live prefix on the card (:func:`chunk_bounds`)."""
    want = -(-WAVE_BLOCKS // (B * Kv))
    return max(1, min(want, -(-S // KV_TILE), MAX_CHUNKS))


def chunk_bounds(pos, S: int, n_chunks: int):
    """The shares the chunk blocks take, as the kernel computes them
    (``share_of``): for ``pos`` (an int or an int array) the arrays
    ``(starts, stops)`` of shape ``pos.shape + (n_chunks,)``.  Chunk c of
    a row covers positions ``[starts[c], stops[c])``: shares of
    ``roundup(ceil(live / n_chunks), KV_TILE)`` positions, ``live =
    min(pos + 1, S)``, the last live share cut at ``live`` and the rest
    empty (``starts == stops == live``).  A mirror for the tests; the card
    computes its own."""
    live = np.minimum(np.asarray(pos, np.int64) + 1, S)[..., None]
    per = -(-live // n_chunks)                  # ceil(live / n_chunks)
    per = -(-per // KV_TILE) * KV_TILE          # whole tiles
    c = np.arange(n_chunks)
    return np.minimum(c * per, live), np.minimum((c + 1) * per, live)


def part_size(B: int, H: int, hd: int, n_chunks: int) -> int:
    """f32 elements of the chunks' partial states: ``(m, l, 0, 0,
    acc[hd])`` per (b, query head, chunk), ``acc`` 16-byte aligned."""
    return B * H * n_chunks * (hd + 4)


def geometry(B: int, S: int, H: int, Kv: int, hd: int
             ) -> list[LaunchGeometry]:
    """The launches of one ``decode_attention`` call
    (``csrc/decode_attention.cu:launch_g``).  The chunk kernel's block
    ``(b * Kv + kv head, c)`` writes the ``G`` query heads of its kv head:
    into ``out`` when there is one chunk, else its partial states
    ``(m, l, 0, 0, acc[hd])`` into ``part``, the neutral state when its
    share is empty; then the combine kernel's block ``b * Kv + kv head``
    writes those heads of ``out``.  Every block writes its whole range at
    every ``pos``."""
    n_chunks = split(B, S, Kv)
    G = H // Kv

    def heads(block):
        b, kvh = divmod(block[0], Kv)
        start = (b * H + kvh * G) * hd
        return [(start, start + G * hd)]
    out = Output(B * H * hd, heads)
    if n_chunks == 1:
        return [LaunchGeometry("decode_chunk_kernel", (B * Kv, 1), THREADS,
                               {"out": out})]

    def states(block):
        start = (block[0] * n_chunks + block[1]) * G * (hd + 4)
        return [(start, start + G * (hd + 4))]
    return [LaunchGeometry("decode_chunk_kernel", (B * Kv, n_chunks),
                           THREADS,
                           {"part": Output(part_size(B, H, hd, n_chunks),
                                           states)}),
            LaunchGeometry("decode_combine_kernel", (B * Kv,),
                           combine_threads(G), {"out": out})]


def cu_grids(B: int, S: int, H: int, Kv: int, hd: int) -> list[tuple]:
    """The grids ``csrc/decode_attention.cu`` computes for the same
    arguments (its ``decode_attention_geometry`` export)."""
    return KERNEL.grids("decode_attention_geometry", 2, B, Kv,
                        split(B, S, Kv))


def _check(q, k_cache, v_cache, pos):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"decode_attention: q must be [B, H, hd] and the caches "
            f"[B, S, Kv, hd]; got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    if (k_cache.shape[0], k_cache.shape[3]) != (B, hd) \
            or H % k_cache.shape[2]:
        raise ValueError(
            f"decode_attention: caches {tuple(k_cache.shape)} do not fit q "
            f"{tuple(q.shape)} (same B and hd, H % Kv == 0)")
    if not q.dtype == k_cache.dtype == v_cache.dtype \
            or q.dtype not in _EXPORTS:
        raise TypeError(f"decode_attention: q and the caches must share one "
                        f"dtype of {list(_EXPORTS)}; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if not q.device == k_cache.device == v_cache.device:
        raise ValueError(f"decode_attention: q and the caches on "
                         f"{q.device}, {k_cache.device}, {v_cache.device}")
    if isinstance(pos, torch.Tensor):
        if pos.device != q.device:
            raise ValueError(f"decode_attention: pos on {pos.device}, q on "
                             f"{q.device}")
        if pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != B):
            raise ValueError(f"decode_attention: pos must be a scalar or "
                             f"[{B}]; got {tuple(pos.shape)}")


def positions(pos, B: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d tensor or an ``[B]`` tensor on ``device``) as
    a contiguous ``i32[B]`` on ``device``, without a host sync."""
    if isinstance(pos, torch.Tensor):
        return pos.to(torch.int32).expand(B).contiguous()
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def decode_attention(q, k_cache, v_cache, pos):
    """q: [B, H, hd]; caches [B, S, Kv, hd]; ``pos`` an int, a 0-d tensor
    or an ``[B]`` tensor of positions >= 0.  Row b attends over cache
    entries ``0 .. pos[b]``.  Returns [B, H, hd]."""
    _check(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, pos)
    if q.device.type == "meta":             # shapes only (kernels/meta.py)
        return torch.ops.repro_torch.decode_attention(q, k_cache, v_cache)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if H // Kv not in GROUPS:
        raise ValueError(f"decode_attention: {H // Kv} query heads per kv "
                         f"head; the kernel takes 1..8 and {MAX_GROUP}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the caches must be "
                         "contiguous")
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) & 15:
        raise ValueError("decode_attention: q and the caches must be "
                         "16-byte aligned")
    posv = positions(pos, B, q.device)
    out = torch.empty_like(q)
    n_chunks = split(B, S, Kv)
    part = (torch.empty(part_size(B, H, hd, n_chunks), dtype=torch.float32,
                        device=q.device) if n_chunks > 1 else None)
    KERNEL.launch(_EXPORTS[q.dtype], q.device, out.data_ptr(),
                  None if part is None else part.data_ptr(), q.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), posv.data_ptr(),
                  B, S, H, Kv, hd, n_chunks, 1.0 / math.sqrt(hd),
                  current_stream(q.device))
    return out
