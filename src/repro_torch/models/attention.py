"""Softmax attention, the counterpart of ``repro.models.attention``: GQA
with RoPE, QKV biases, sliding-window and chunked masks, and DeepSeek's
multi-head latent attention (MLA, at the end of this module).

Cache layouts per layer (the transformer stacks a leading period axis), as
``repro``'s:

  full  : k, v [B, S, Kv, hd]   S the maximum context
  swa   : k, v [B, W, Kv, hd]   a ring over the window: position p at p % W
  chunk : k, v [B, C, Kv, hd]   the chunk in progress: position p at p % C
  mla   : c_kv [B, S, lora], k_rope [B, S, rope]

Serving runs two kernels.  Prefill runs K5 (``swa_attention``): window S
for full attention, the sliding window for ``swa``, and for ``chunk`` the
sequence cut into chunks of C (zero-padded at the tail) as a batch of
``B * ceil(S / C)`` rows, each causal inside itself, in one launch.  Every
decode step runs K4 (``decode_attention``) over the slots ``0 .. pos'``
with ``pos'`` computed on the card: ``pos`` for full attention, ``min(pos,
W - 1)`` for ``swa`` (once the ring is full every slot is in the window),
``pos % C`` for ``chunk``.  Those are the keys ``repro``'s mask admits,
summed in another order.  Each wrapper takes its plain version for CPU
tensors and launches its CUDA kernel for CUDA tensors.  Ring caches take a
scalar position only (``repro`` asserts so).

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
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ArchConfig, MIXER_ATTN,
                                      MIXER_ATTN_GLOBAL)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.swa_attention.ops import swa_attention
from repro_torch.models.modules import (RMSNorm, apply_rope, dense_init,
                                        rope_freqs)
from repro_torch.sharding import dtensor as dt

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


def ring_specs(cfg):
    """(mask_kind, width) of each attention sublayer of a period whose
    cache is a ring (``swa`` or ``chunk``); empty for full attention
    throughout and for MLA, Mamba and RWKV mixers."""
    specs = (mask_spec_for(cfg, sub.mixer) for sub in cfg.sublayers()
             if sub.mixer in (MIXER_ATTN, MIXER_ATTN_GLOBAL))
    return [(kind, width) for kind, width in specs if kind != "full"]


class Attention(nn.Module):
    """GQA projections in ``repro``'s shapes: ``wq [d, H, hd]``,
    ``wk``/``wv [d, Kv, hd]``, ``wo [H, hd, d]``, and with ``qkv_bias`` the
    biases ``bq [H, hd]``, ``bk``/``bv [Kv, hd]`` (``None`` without)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        hd = cfg.resolved_head_dim
        shapes = {"wq": (cfg.d_model, cfg.n_heads, hd),
                  "wk": (cfg.d_model, cfg.n_kv_heads, hd),
                  "wv": (cfg.d_model, cfg.n_kv_heads, hd),
                  "wo": (cfg.n_heads, hd, cfg.d_model)}
        biases = {"bq": (cfg.n_heads, hd), "bk": (cfg.n_kv_heads, hd),
                  "bv": (cfg.n_kv_heads, hd)}
        if cfg.qkv_bias:
            shapes.update(biases)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))
        if not cfg.qkv_bias:
            for name in biases:
                self.register_parameter(name, None)
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(hd, cfg.rope_theta)).to(device), persistent=False)

    def reset_parameters(self, generator):
        """``repro``'s ``init_attention`` distributions (zero biases)."""
        d, H, hd = self.wq.shape
        Kv = self.wk.shape[1]
        dev, dt = self.wq.device, self.wq.dtype
        self.wq.copy_(dense_init(generator, d, (H, hd), dt, device=dev))
        self.wk.copy_(dense_init(generator, d, (Kv, hd), dt, device=dev))
        self.wv.copy_(dense_init(generator, d, (Kv, hd), dt, device=dev))
        self.wo.copy_(dense_init(generator, H * hd, d, dt,
                                 scale=1.0 / np.sqrt(H * hd),
                                 device=dev).reshape(H, hd, d))
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()


def init_attention(cfg, generator, dtype=torch.float32, device=None):
    p = Attention(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _proj(x, w):
    """x: [B, S, d] @ w: [d, N, hd] -> [B, S, N, hd].  A DTensor product
    whose flat ``N * hd`` columns came out sharded over an axis that does
    not divide N (the heads' spec degraded) is gathered there before the
    split into heads."""
    d, n, hd = w.shape
    y = x @ w.reshape(d, n * hd)
    if dt.is_dtensor(y):
        y = dt.unshard_uneven(y, y.dim() - 1, n)
    return y.reshape(*x.shape[:-1], n, hd)


def _qkv(p, x):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


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
    scores = scores / math.sqrt(hd) + dt.like(scores, bias[:, :, None])
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


def _prefill_attention(q, k, v, mask_kind, width):
    """Causal attention of a whole prompt under ``mask_kind``, through K5
    in one launch."""
    B, S, H, hd = q.shape
    if mask_kind == "full" or (mask_kind == "chunk" and S <= width):
        return swa_attention(q, k, v, window=S)
    if mask_kind == "swa":
        return swa_attention(q, k, v, window=width)
    # chunk: chunks of C as rows of a batch; the zero rows padding the last
    # chunk come after every real row, so causality keeps them out of it
    n = -(-S // width)

    def rows(t):
        t = F.pad(t, (0, 0, 0, 0, 0, n * width - S))
        return t.reshape(B * n, width, *t.shape[2:])
    out = swa_attention(rows(q), rows(k), rows(v), window=width)
    return out.reshape(B, n * width, H, hd)[:, :S]


def attention_fwd(cfg, p, x, positions, mask_kind="full", width=0,
                  train=False):
    """Full-sequence attention.  Prefill (``train=False``): through K5;
    returns (y, cache_kv), the cache already in decode layout
    (``to_decode_layout``).  Training (``train=True``): the differentiable
    torch path; returns (y, None)."""
    q, k, v = _qkv(p, x)
    q = apply_rope(q, positions, p.rope_freqs)
    k = apply_rope(k, positions, p.rope_freqs)
    if train:
        return _out(p, _on_heads(
            lambda ql, kl, vl: _sdpa_any(ql, kl, vl, positions, mask_kind,
                                         width), q, k, v)[0]), None
    # prefill through K5; on DTensors the cache keeps k/v in the layout K4
    # reads them in
    out, k, v = _on_heads(
        lambda ql, kl, vl: _prefill_attention(ql, kl, vl, mask_kind, width),
        q, k, v)
    return _out(p, out), {"k": to_decode_layout(k, mask_kind, width),
                          "v": to_decode_layout(v, mask_kind, width)}


def _on_heads(fn, q, k, v):
    """``fn(q, k, v)`` -> ``(out, k, v)``.  On DTensors ``fn`` runs on each
    rank's batch rows and query heads, with the kv heads they read
    (``dt.attention_layouts``), and k and v come back in that layout: the
    attention is local to a rank, whatever layout DTensor's rules would
    pick for the products (contracting over a sharded head dim would
    all-reduce every score)."""
    if not dt.is_dtensor(q):
        return fn(q, k, v), k, v
    q_pl, kv_pl, heads = dt.attention_layouts(q.device_mesh, q.shape[0],
                                              q.shape[2], k.shape[2])
    k, v = k.redistribute(placements=kv_pl), v.redistribute(
        placements=kv_pl)
    cut = heads or (lambda t: t)
    out = dt.on_shards(lambda ql, kl, vl: fn(ql, cut(kl), cut(vl)),
                       (q, k, v), (q_pl, None, None), q_pl)
    return out, k, v


def to_decode_layout(kv, mask_kind, width):
    """A prefilled ``[B, S, Kv, hd]`` tensor in decode-cache layout.

    swa  : ring of the last ``width`` entries, position p at slot p % W,
           zero-padded when S < W.
    chunk: the chunk in progress (positions >= S - S % C), at p % C.
    full : unchanged.
    """
    if mask_kind == "full":
        return kv
    B, S, Kv, hd = kv.shape
    W = width
    if mask_kind == "swa":
        if S < W:
            return torch.cat([kv, kv.new_zeros((B, W - S, Kv, hd))], dim=1)
        return torch.roll(kv[:, S - W:], S % W, dims=1)
    filled = S % W
    return torch.cat([kv[:, S - filled:],
                      kv.new_zeros((B, W - filled, Kv, hd))], dim=1)


def _write(cache, new, pos, per_seq):
    """cache[b, pos or pos[b]] = new[b, 0], in place and without a host
    sync.  The values of ``repro``'s one-hot blend at finite entries.  A
    DTensor cache is written on each rank's batch rows, its sequence
    gathered for the write where it is sharded."""
    if dt.is_dtensor(cache):
        mesh = cache.device_mesh
        rows = dt.layout(mesh, cache.shape, {0: dt.BATCH_AXES})
        full = cache.redistribute(placements=rows)
        new = dt.like(cache, new).redistribute(placements=rows)
        pos = dt.like(cache, pos)
        pos = pos.redistribute(placements=(
            dt.layout(mesh, pos.shape, {0: dt.BATCH_AXES}) if per_seq
            else pos.placements))
        _write(full.to_local(), new.to_local(), pos.to_local(), per_seq)
        if list(full.placements) != list(cache.placements):
            cache.copy_(full.redistribute(placements=cache.placements))
        return
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


def ring_slots(pos, mask_kind: str, W: int):
    """(slot, pos') of a decode step at ``pos`` (a tensor on the card): the
    slot the new K/V goes to and the last slot K4 attends to.  ``pos``
    itself for full attention; in a ring of W, ``pos % W`` and
    ``min(pos, W - 1)`` (swa) or ``pos % W`` (chunk)."""
    if mask_kind == "full":
        return pos, pos
    slot = pos % W
    return slot, (pos.clamp(max=W - 1) if mask_kind == "swa" else slot)


def attention_decode(cfg, p, x, cache, pos, mask_kind: str = "full",
                     width: int = 0, slots=None):
    """One-token decode.  x: [B, 1, d]; ``pos``: an int, a 0-d tensor or
    (full attention only) a per-sequence ``[B]`` tensor.  Writes the new
    K/V into ``cache`` in place at slot ``pos`` (``pos % W`` in a ring of
    W) and attends over the slots the mask admits.  ``slots``: the
    :func:`ring_slots` of this step, where the caller computed them once
    for every layer.  Returns (y, cache)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, x)
    pos = as_positions(pos, x.device)
    per_seq = pos.dim() == 1
    if per_seq and mask_kind != "full":
        raise ValueError(f"{mask_kind!r} ring caches require a scalar "
                         f"position, got one per sequence")
    posv = pos[:, None] if per_seq else pos.reshape(1)
    q = apply_rope(q, posv, p.rope_freqs)
    k_new = apply_rope(k_new, posv, p.rope_freqs)
    slot, live = (ring_slots(pos, mask_kind, cache["k"].shape[1])
                  if slots is None else slots)
    if dt.is_dtensor(cache["k"]):
        out = _decode_on_shards(q, k_new, v_new, cache, slot, live, per_seq)
    else:
        _write(cache["k"], k_new, slot, per_seq)
        _write(cache["v"], v_new, slot, per_seq)
        out = decode_attention(q[:, 0], cache["k"], cache["v"], live)
    return _out(p, out.reshape(B, 1, *out.shape[1:])), cache


def _decode_on_shards(q, k_new, v_new, cache, slot, live, per_seq):
    """The cache write and K4 on each rank's shards of a DTensor cache:
    batch rows over the batch axes, kv heads over ``model`` where they
    divide (``dt.attention_layouts``).  A cache in another layout (the
    sequence over ``model``, as ``cache_specs`` lays it out) is gathered to
    that one for the step and written back."""
    mesh = q.device_mesh
    B, _, H, _ = q.shape
    q_pl, kv_pl, heads = dt.attention_layouts(mesh, B, H,
                                              cache["k"].shape[2])
    cut = heads or (lambda t: t)
    kc, vc = cache["k"], cache["v"]
    moved = list(kc.placements) != list(kv_pl)
    if moved:
        kc, vc = kc.redistribute(placements=kv_pl), vc.redistribute(
            placements=kv_pl)
    # per-row positions go with their rows: a replicated [B] vector cut
    # like the batch
    rows = dt.layout(mesh, (B,), {0: dt.BATCH_AXES}) if per_seq else None
    slot, live = (dt.like(q, slot), dt.like(q, live))

    def step(ql, kn, vn, kl, vl, sl, ll):
        _write(kl, kn, sl, per_seq)
        _write(vl, vn, sl, per_seq)
        return decode_attention(ql[:, 0], cut(kl), cut(vl), ll)
    from torch.distributed.tensor import Shard
    out = dt.on_shards(                     # out [B, H, hd]: heads on dim 1
        step, (q, k_new, v_new, kc, vc, slot, live),
        (q_pl, kv_pl, kv_pl, None, None, rows, rows),
        [Shard(1) if pl == Shard(2) else pl for pl in q_pl])
    if moved:
        cache["k"].copy_(kc.redistribute(placements=cache["k"].placements))
        cache["v"].copy_(vc.redistribute(placements=cache["v"].placements))
    return out


def init_attn_cache(cfg, batch, max_seq, mask_kind, width, dtype, device):
    """Zero ``k, v [batch, S, Kv, hd]``: S = ``max_seq`` for full attention,
    ``min(width, max_seq)`` for a ring."""
    S = max_seq if mask_kind == "full" else min(width, max_seq)
    shape = (batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------
# MLA runs plain torch products on every path, as ``repro``'s is plain jnp:
# its q/k head is nope + rope = 192 wide against v's 128, which K5 does not
# take, and the absorbed decode is one 576-wide key shared by every query
# head (G = n_heads = 16) at a head dim of 576, which K4 does not take.
class MLA(nn.Module):
    """``wq [d, H, nope + rope]``, ``w_dkv [d, lora]``, ``w_krope [d,
    rope]``, ``kv_norm`` (RMSNorm over the latent), ``w_uk [lora, H,
    nope]``, ``w_uv [lora, H, v]``, ``wo [H, v, d]``: ``repro``'s
    ``init_mla`` shapes."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        H, L = cfg.n_heads, cfg.kv_lora_rank
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        shapes = {"wq": (cfg.d_model, H, nope + rope),
                  "w_dkv": (cfg.d_model, L),
                  "w_krope": (cfg.d_model, rope),
                  "w_uk": (L, H, nope), "w_uv": (L, H, vd),
                  "wo": (H, vd, cfg.d_model)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))
        self.kv_norm = RMSNorm(L, cfg.norm_eps, dtype, device)
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(rope, cfg.rope_theta)).to(device), persistent=False)

    def reset_parameters(self, generator):
        """``repro``'s ``init_mla`` distributions (unit norm scale)."""
        dev, dt = self.wq.device, self.wq.dtype
        for name in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, w.shape[0], tuple(w.shape[1:]), dt,
                               device=dev))
        H, vd, d = self.wo.shape
        self.wo.copy_(dense_init(generator, H * vd, d, dt,
                                 device=dev).reshape(H, vd, d))
        self.kv_norm.scale.fill_(1)


def init_mla(cfg, generator, dtype=torch.float32, device=None):
    p = MLA(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _mla_compress(cfg, p, x, positions):
    """The latent ``c_kv [B, S, lora]`` (RMS-normed) and the shared
    ``k_rope [B, S, rope]`` (rotated) of x."""
    c_kv = p.kv_norm(x @ p.w_dkv)
    k_rope = (x @ p.w_krope)[:, :, None, :]
    k_rope = apply_rope(k_rope, positions, p.rope_freqs)[:, :, 0, :]
    return c_kv, k_rope


def _mla_q(cfg, p, x, positions):
    q = _proj(x, p.wq)
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], apply_rope(q[..., nope:], positions, p.rope_freqs)


def _mla_scale(cfg):
    return 1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_attend(cfg, q_nope, q_rope, k_nope, k_rope, v, qpos, kpos):
    """Causal MLA attention of queries at ``qpos`` over keys at ``kpos``;
    scores in float32, the softmax cast back to v's dtype."""
    scores = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope) +
              torch.einsum("bshr,btr->bhst", q_rope, k_rope)).float()
    bias = _causal_bias(qpos, kpos, "full", 0)
    w = torch.softmax(scores * _mla_scale(cfg) + dt.like(scores, bias),
                      dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthv->bshv", w, v)


def _mla_block(cfg, q_nope, q_rope, k_nope, k_rope, v, positions, start):
    stop = start + SDPA_BLOCK_Q
    return _mla_attend(cfg, q_nope[:, start:stop], q_rope[:, start:stop],
                       k_nope, k_rope, v, positions[start:stop], positions)


def mla_fwd(cfg: ArchConfig, p, x, positions):
    """Full-sequence MLA (train and prefill).  Dense scores up to
    ``BLOCKED_SDPA_THRESHOLD``; beyond it (S a multiple of
    ``SDPA_BLOCK_Q``) one checkpointed block of query rows at a time, as
    ``_sdpa_any``.  Returns (y, cache ``{"c_kv", "k_rope"}``)."""
    c_kv, k_rope = _mla_compress(cfg, p, x, positions)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    k_nope = _proj(c_kv, p.w_uk)
    v = _proj(c_kv, p.w_uv)
    args = (q_nope, q_rope, k_nope, k_rope, v)
    if dt.is_dtensor(x):
        # each rank's batch rows and heads (k_rope is shared by the heads)
        mesh, (B, S, H) = x.device_mesh, q_nope.shape[:3]
        heads = dt.layout(mesh, (B, S, H),
                          {0: dt.BATCH_AXES, 2: ("model",)})
        rows = dt.layout(mesh, (B,), {0: dt.BATCH_AXES})
        out = dt.on_shards(lambda *a: _mla_core(cfg, *a, positions), args,
                           (heads, heads, heads, rows, heads), heads)
    else:
        out = _mla_core(cfg, *args, positions)
    return _out(p, out), {"c_kv": c_kv, "k_rope": k_rope}


def _mla_core(cfg, q_nope, q_rope, k_nope, k_rope, v, positions):
    """Causal MLA attention over the whole sequence."""
    S = q_nope.shape[1]
    if S <= BLOCKED_SDPA_THRESHOLD or S % SDPA_BLOCK_Q:
        return _mla_attend(cfg, q_nope, q_rope, k_nope, k_rope, v, positions,
                           positions)
    return torch.cat([checkpoint(_mla_block, cfg, q_nope, q_rope, k_nope,
                                 k_rope, v, positions, start,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
                      for start in range(0, S, SDPA_BLOCK_Q)], dim=1)


def mla_decode(cfg: ArchConfig, p, x, cache, pos):
    """One-token MLA decode, naive or absorbed (``cfg.mla_absorb``).
    x: [B, 1, d]; ``pos``: an int, a 0-d tensor or a per-sequence ``[B]``
    tensor.  Writes the new latent and rope key into ``cache`` in place, on
    the device.  Returns (y, cache)."""
    pos = as_positions(pos, x.device)
    per_seq = pos.dim() == 1
    posv = pos[:, None] if per_seq else pos.reshape(1)
    c_new, kr_new = _mla_compress(cfg, p, x, posv)
    _write(cache["c_kv"], c_new, pos, per_seq)
    _write(cache["k_rope"], kr_new, pos, per_seq)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    q_nope, q_rope = _mla_q(cfg, p, x, posv)              # [B, 1, H, *]
    S = c_kv.shape[1]
    ok = (torch.arange(S, device=x.device)[None, :]
          <= (pos[:, None] if per_seq else pos))
    bias = torch.full(ok.shape, NEG_INF, dtype=torch.float32,
                      device=x.device).masked_fill_(ok, 0.0)
    bias = bias.reshape(-1, 1, 1, S)                      # [B or 1, 1, 1, S]
    if cfg.mla_absorb:
        # W_uk into the query and W_uv into the output: the scores and the
        # context stay in the latent space
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, p.w_uk)
        scores = (torch.einsum("bshl,btl->bhst", q_lat, c_kv) +
                  torch.einsum("bshr,btr->bhst", q_rope, k_rope)).float()
        w = torch.softmax(scores * _mla_scale(cfg) + dt.like(scores, bias),
                          dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btl->bshl", w, c_kv)
        out = torch.einsum("bshl,lhv->bshv", ctx, p.w_uv)
    else:
        k_nope = _proj(c_kv, p.w_uk)
        v = _proj(c_kv, p.w_uv)
        scores = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope) +
                  torch.einsum("bshr,btr->bhst", q_rope, k_rope)).float()
        w = torch.softmax(scores * _mla_scale(cfg) + dt.like(scores, bias),
                          dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthv->bshv", w, v)
    return _out(p, out), cache


def init_mla_cache(cfg, batch, max_seq, dtype, device):
    """Zero ``c_kv [batch, max_seq, lora]`` and ``k_rope [batch, max_seq,
    rope]``."""
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
