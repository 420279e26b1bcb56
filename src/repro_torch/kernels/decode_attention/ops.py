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

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (64, 128)          # the kernel's instantiations
MAX_GROUP = 8                  # query heads per kv head, 1..8
# the sequence split: enough (b, kv head, chunk) blocks for a few waves of
# the card's 132 SMs, chunks of at least MIN_CHUNK positions
TARGET_BLOCKS = 4 * 132
MIN_CHUNK = 128

# (device, out, part, q, k, v, pos, B, S, H, Kv, hd, chunk, n_chunks,
#  scale, stream)
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_EXPORTS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}

KERNEL = CudaKernel("decode_attention", "decode_attention.cu",
                    {fn: _ARGS for fn in _EXPORTS.values()})


def split(B: int, S: int, Kv: int) -> tuple[int, int]:
    """``(chunk, n_chunks)``: how many positions one block takes.  Fixed by
    the shapes alone, so the host never reads ``pos``."""
    want = max(1, -(-TARGET_BLOCKS // (B * Kv)))
    n = max(1, min(want, S // MIN_CHUNK))
    chunk = -(-S // n)
    return chunk, -(-S // chunk)


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
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if H // Kv > MAX_GROUP:
        raise ValueError(f"decode_attention: {H // Kv} query heads per kv "
                         f"head; the kernel takes 1..{MAX_GROUP}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the caches must be "
                         "contiguous")
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) & 15:
        raise ValueError("decode_attention: q and the caches must be "
                         "16-byte aligned")
    posv = positions(pos, B, q.device)
    out = torch.empty_like(q)
    chunk, n_chunks = split(B, S, Kv)
    part = (torch.empty(B * H * n_chunks * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_chunks > 1 else None)
    KERNEL.launch(_EXPORTS[q.dtype], q.device, out.data_ptr(),
                  None if part is None else part.data_ptr(), q.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), posv.data_ptr(),
                  B, S, H, Kv, hd, chunk, n_chunks, 1.0 / math.sqrt(hd),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
