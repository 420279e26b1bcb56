"""GQA softmax attention with RoPE, the counterpart of the GQA half of
``repro.models.attention``.

Cache layout per layer (the transformer stacks a leading period axis):
``k, v [B, S, Kv, hd]`` with S the maximum context.  Serving ports only
full (causal) attention: prefill runs K5 (``swa_attention`` with
``window = S``, which is causal attention) and every decode step runs K4
(``decode_attention``).  Each wrapper takes its plain version for CPU
tensors and launches its CUDA kernel for CUDA tensors.  Sliding-window and
chunked ring caches, QKV biases and MLA raise ``NotImplementedError``
(ROADMAP queue 1, item 12).

Training (``attention_fwd(..., train=True)``) takes the differentiable
path of ``repro``'s ``_sdpa_any``: torch matmuls and softmax with an
additive ``-1e30`` mask (full, sliding-window or chunked), q-blocked with
each block checkpointed above ``BLOCKED_SDPA_THRESHOLD``.  It is XLA code
in ``repro``, not a kernel; K5 has no backward.

Unlike ``repro``, ``attention_decode`` writes the new K/V into the cache
in place: a full-width cache is gigabytes, and the caller never needs the
old one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MIXER_ATTN_GLOBAL
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.swa_attention.ops import swa_attention
from repro_torch.models.modules import apply_rope, dense_init, rope_freqs

UNPORTED = "not ported yet (ROADMAP queue 1, item 12)"
NEG_INF = -1e30
BLOCKED_SDPA_THRESHOLD = 1024   # S above which the q-blocked path is used
SDPA_BLOCK_Q = 128


def mask_spec_for(cfg, mixer_kind):
    """Resolve (mask_kind, width) for a sublayer's attention."""
    if mixer_kind == MIXER_ATTN_GLOBAL:
        return "full", 0
    if cfg.sliding_window:
        return "swa", cfg.sliding_window
    if cfg.attn_chunk:
        return "chunk", cfg.attn_chunk
    return "full", 0


def _full_only(mask_kind):
    if mask_kind != "full":
        raise NotImplementedError(
            f"{mask_kind!r} attention masks (ring caches) are {UNPORTED}")


class Attention(nn.Module):
    """GQA projections in ``repro``'s shapes: ``wq [d, H, hd]``,
    ``wk``/``wv [d, Kv, hd]``, ``wo [H, hd, d]``."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.use_mla:
            raise NotImplementedError(f"MLA attention is {UNPORTED}")
        if cfg.qkv_bias:
            raise NotImplementedError(f"QKV biases are {UNPORTED}")
        hd = cfg.resolved_head_dim
        shapes = {"wq": (cfg.d_model, cfg.n_heads, hd),
                  "wk": (cfg.d_model, cfg.n_kv_heads, hd),
                  "wv": (cfg.d_model, cfg.n_kv_heads, hd),
                  "wo": (cfg.n_heads, hd, cfg.d_model)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(hd, cfg.rope_theta)).to(device), persistent=False)

    def reset_parameters(self, generator):
        """``repro``'s ``init_attention`` distributions."""
        d, H, hd = self.wq.shape
        Kv = self.wk.shape[1]
        dev, dt = self.wq.device, self.wq.dtype
        self.wq.copy_(dense_init(generator, d, (H, hd), dt, device=dev))
        self.wk.copy_(dense_init(generator, d, (Kv, hd), dt, device=dev))
        self.wv.copy_(dense_init(generator, d, (Kv, hd), dt, device=dev))
        self.wo.copy_(dense_init(generator, H * hd, d, dt,
                                 scale=1.0 / np.sqrt(H * hd),
                                 device=dev).reshape(H, hd, d))


def init_attention(cfg, generator, dtype=torch.float32, device=None):
    p = Attention(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _proj(x, w):
    """x: [B, S, d] @ w: [d, N, hd] -> [B, S, N, hd]."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def _qkv(p, x):
    return _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)


def _out(p, o):
    """o: [B, S, H, hd] @ wo: [H, hd, d] -> [B, S, d]."""
    H, hd, d = p.wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ p.wo.reshape(H * hd, d)


def _sdpa(q, k, v, bias):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, Kv, hd]; bias: [B or 1, 1, Sq, Sk]
    additive.  Scores in f32, the softmax cast back to q's dtype."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd) + bias[:, :, None]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _causal_bias(q_pos, k_pos, mask_kind, width):
    """Additive f32 bias ``[1, 1, Sq, Sk]`` from absolute positions."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = kp <= qp
    if mask_kind == "swa":
        ok &= (qp - kp) < width
    elif mask_kind == "chunk":
        ok &= (qp // width) == (kp // width)
    bias = torch.full(ok.shape, NEG_INF, dtype=torch.float32,
                      device=ok.device).masked_fill_(ok, 0.0)
    return bias[None, None]


def _sdpa_block(q, k, v, positions, start, mask_kind, width):
    stop = start + SDPA_BLOCK_Q
    bias = _causal_bias(positions[start:stop], positions, mask_kind, width)
    return _sdpa(q[:, start:stop], k, v, bias)


def _sdpa_any(q, k, v, positions, mask_kind, width):
    """Dense S x S scores up to ``BLOCKED_SDPA_THRESHOLD``; beyond it (for
    S a multiple of ``SDPA_BLOCK_Q``) one checkpointed block of query rows
    at a time, so the backward holds one block's scores, not ``[H, S, S]``.
    """
    S = q.shape[1]
    if S <= BLOCKED_SDPA_THRESHOLD or S % SDPA_BLOCK_Q:
        bias = _causal_bias(positions, positions, mask_kind, width)
        return _sdpa(q, k, v, bias)
    blocks = [checkpoint(_sdpa_block, q, k, v, positions, start, mask_kind,
                         width, use_reentrant=False,
                         preserve_rng_state=False)
              for start in range(0, S, SDPA_BLOCK_Q)]
    return torch.cat(blocks, dim=1)


def attention_fwd(cfg, p, x, positions, mask_kind="full", width=0,
                  train=False):
    """Full-sequence attention.  Prefill (``train=False``): causal through
    K5; returns (y, cache_kv), the cache ``k, v [B, S, Kv, hd]`` already in
    decode layout.  Training (``train=True``): the differentiable torch
    path for any mask; returns (y, None)."""
    if not train:
        _full_only(mask_kind)
    q, k, v = _qkv(p, x)
    q = apply_rope(q, positions, p.rope_freqs)
    k = apply_rope(k, positions, p.rope_freqs)
    if train:
        return _out(p, _sdpa_any(q, k, v, positions, mask_kind, width)), None
    out = swa_attention(q, k, v, window=x.shape[1])   # causal: window = S
    return _out(p, out), {"k": to_decode_layout(k, mask_kind, width),
                          "v": to_decode_layout(v, mask_kind, width)}


def to_decode_layout(kv, mask_kind, width):
    """A prefilled ``[B, S, Kv, hd]`` tensor in decode-cache layout: for
    full attention, unchanged."""
    _full_only(mask_kind)
    return kv


def _write(cache, new, pos, per_seq):
    """cache[b, pos or pos[b]] = new[b, 0], in place and without a host
    sync.  The values of ``repro``'s one-hot blend at finite entries."""
    if per_seq:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((rows, pos.long()), new[:, 0])
    else:
        cache.index_copy_(1, pos.reshape(1).long(), new)


def as_positions(pos, device) -> torch.Tensor:
    """``pos`` (an int or an int tensor, 0-d or ``[B]``) as an i32 tensor on
    ``device``.  An int is filled on the device: copying it from the host
    would wait for the card."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def attention_decode(cfg, p, x, cache, pos, mask_kind="full", width=0):
    """One-token decode.  x: [B, 1, d]; ``pos``: an int, a 0-d tensor or a
    per-sequence ``[B]`` tensor (continuous batching).  Writes the new K/V
    into ``cache`` in place at ``pos`` and attends over ``0 .. pos``.
    Returns (y, cache)."""
    _full_only(mask_kind)
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, x)
    pos = as_positions(pos, x.device)
    per_seq = pos.dim() == 1
    posv = pos[:, None] if per_seq else pos.reshape(1)
    q = apply_rope(q, posv, p.rope_freqs)
    k_new = apply_rope(k_new, posv, p.rope_freqs)
    _write(cache["k"], k_new, pos, per_seq)
    _write(cache["v"], v_new, pos, per_seq)
    out = decode_attention(q[:, 0], cache["k"], cache["v"], pos)
    return _out(p, out.reshape(B, 1, *out.shape[1:])), cache


def init_attn_cache(cfg, batch, max_seq, mask_kind, width, dtype, device):
    _full_only(mask_kind)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
