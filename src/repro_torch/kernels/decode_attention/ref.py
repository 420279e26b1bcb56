"""Plain PyTorch one-token GQA attention against a KV cache: a
transcription of ``repro.kernels.decode_attention.ref`` that also takes a
position per sequence, masked as ``repro.models.attention.attention_decode``
masks it.

The CPU path of ``decode_attention.ops.decode_attention``
and what the tests and ``chip_smoke.py`` hold the CUDA kernel against."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, pos):
    """q: [B, H, hd] (one new token, already rotary-encoded);
    k_cache/v_cache: [B, S, Kv, hd]; ``pos``: an int, a 0-d tensor or an
    ``[B]`` tensor.  Entries past ``pos`` (``pos[b]`` for row b) get zero
    weight.  Returns [B, H, hd]."""
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    G = H // Kv
    qg = q.reshape(B, Kv, G, hd)
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k_cache).float()
    scores = scores / math.sqrt(hd)
    pos = torch.as_tensor(pos, device=q.device)
    pb = pos[:, None] if pos.dim() == 1 else pos
    ok = torch.arange(S, device=q.device)[None, :] <= pb   # [B or 1, S]
    scores = torch.where(ok.reshape(-1, 1, 1, S), scores,
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", w, v_cache)
    return out.reshape(B, H, hd)
