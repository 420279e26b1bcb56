"""Plain PyTorch causal sliding-window attention (GQA): a transcription of
``repro.kernels.swa_attention.ref``.

The CPU path of :func:`repro_torch.kernels.swa_attention.ops.swa_attention`
and what the tests and ``chip_smoke.py`` hold the CUDA kernel against.  It
builds the dense ``[B, Kv, G, S, S]`` scores: no yardstick of speed."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def swa_attention(q, k, v, window: int):
    """q: [B, S, H, hd]; k, v: [B, S, Kv, hd]; H % Kv == 0.  Causal, attends
    only to the last ``window`` positions (inclusive of self).  Returns
    [B, S, H, hd]."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    ok = (pos[None, :] <= pos[:, None]) & \
         (pos[:, None] - pos[None, :] < window)
    scores = torch.where(ok, scores, torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)
