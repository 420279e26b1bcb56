"""Train, prefill, serve and MAFL steps, the counterparts of
``repro.launch.steps``.

``make_train_step`` is paper-faithful plain SGD (Eq. 2) over the mean
next-token cross-entropy (Eq. 1), computed by K3
(``kernels.cross_entropy.ops.lm_loss``), plus the MoE layers'
load-balance loss (zero for a dense model), as ``repro``'s.  A train step takes the model (its
structure and buffers), a ``{name: tensor}`` param dict and the batch, and
returns a new dict.  ``serve_step`` decodes ONE token against a cache
written in place.  ``mafl_step`` is the RSU aggregation (Eq. 10+11) over a
whole param dict.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.cross_entropy.ops import lm_loss
from repro_torch.models import transformer as T

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, lr: float = 1e-2, grad_specs=None):
    """``(model, params, batch) -> (params, metrics)``; ``batch``:
    ``{'tokens': [B, S+1]}`` (+ ``'patch_embeds'`` ``[B, P, d]`` for a
    vision config: the loss scores the text positions only).  Plain SGD
    per the paper's Eq. (2).

    ``cfg.microbatches > 1`` accumulates the gradients of ``M`` equal
    batch splits in ``cfg.grad_accum_dtype``.  ``cfg.loss_chunk > 0``
    computes the loss by ``_chunked_nll`` (the LM head fused with the
    vocab sweep) instead of materialising the logits.  ``grad_specs``
    (FSDP sharding constraints) raises: ROADMAP queue 1, item 13."""
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs (sharding constraints on the gradients) are not "
            "ported yet (ROADMAP queue 1, item 13)")
    P = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    chunk = cfg.loss_chunk
    acc_dt = _ACCUM_DTYPES[cfg.grad_accum_dtype]

    def loss_fn(model, p, mb):
        fe = mb.get("patch_embeds")
        if not chunk:
            logits, aux = T.apply_params(cfg, model, p, mb["inputs"],
                                         frontend_embeds=fe)
            return lm_loss(logits[:, P:], mb["targets"]) + aux
        h, aux = T.apply_params(cfg, model, p, mb["inputs"], hidden=True,
                                frontend_embeds=fe)
        nll = _chunked_nll(cfg, p, h[:, P:], mb["targets"], chunk)
        return torch.mean(nll) + aux

    def train_step(model, params, batch):
        tokens = batch["tokens"]
        mb = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
        if "patch_embeds" in batch:
            mb["patch_embeds"] = batch["patch_embeds"]
        vg = T.value_and_grad(lambda p, m: loss_fn(model, p, m))
        M = cfg.microbatches
        if M == 1:
            loss, grads = vg(params, mb)
        else:
            B = tokens.shape[0]
            acc = {k: torch.zeros(w.shape, dtype=acc_dt, device=w.device)
                   for k, w in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(M):
                rows = slice(i * (B // M), (i + 1) * (B // M))
                loss_i, g_i = vg(params, {k: v[rows] for k, v in mb.items()})
                acc = {k: a + g_i[k].to(acc_dt) for k, a in acc.items()}
                loss = loss + loss_i
            grads = {k: g / M for k, g in acc.items()}
            loss = loss / M
        new_params = {k: (w.float() - lr * grads[k].float()).to(w.dtype)
                      for k, w in params.items()}
        return new_params, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(model, batch):
        logits, cache = T.prefill(cfg, model, batch["tokens"],
                                  batch.get("patch_embeds"))
        return logits[:, -1:, :], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """ONE new token against a pre-filled cache, written in place."""

    def serve_step(model, token, cache, pos):
        logits, cache = T.decode_step(cfg, model, token, cache, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, cache

    return serve_step


def make_mafl_step(cfg: ArchConfig):
    """RSU aggregation (Eq. 10+11) over a whole param dict:
    ``beta * g + ((1 - beta) * weight) * l`` in f32, each scalar rounded to
    f32 as ``repro``'s traced f32 inputs are.  ``beta`` and ``weight`` are
    host numbers (reading a device scalar would wait for the card)."""

    def mafl_step(global_params, local_params, beta: float,
                  weight: float):
        b = np.float32(beta)
        coef = float((np.float32(1.0) - b) * np.float32(weight))
        b = float(b)
        return {k: (b * g.float() + coef * local_params[k].float())
                .to(g.dtype) for k, g in global_params.items()}

    return mafl_step


def _nll_chunk(h, W, targets, m, s, c, start, chunk, V):
    """One vocab chunk of ``_chunked_nll``'s recurrence."""
    logits = (h @ W[:, start:start + chunk]).float()
    idx = start + torch.arange(chunk, device=h.device)
    logits = torch.where(idx < V, logits, -1e30)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(dim=-1)
    local = targets - start
    hit = (local >= 0) & (local < chunk)
    picked = torch.gather(logits, -1,
                          local.clamp(0, chunk - 1)[..., None].long())[..., 0]
    return m_new, s, torch.where(hit, picked, c)


def _chunked_nll(cfg, params, h, targets, chunk):
    """Vocab-chunked cross-entropy (the torch mirror of ``repro``'s
    ``_chunked_nll``): streams ``[B, S, chunk]`` logit tiles keeping only a
    running (max, sumexp, label logit) per position, never the ``[B, S, V]``
    logits; each chunk is checkpointed, so the backward recomputes its
    tile.  Torch ops, not K3: the head product is fused into the sweep."""
    W = T.head_weight(cfg, params)                        # [d, V]
    V = cfg.vocab_size
    n_chunks = -(-V // chunk)
    padV = n_chunks * chunk - V
    if padV:
        W = F.pad(W, (0, padV))
    B, S, _ = h.shape
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=h.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    c = torch.full((B, S), -1e30, dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        m, s, c = checkpoint(_nll_chunk, h, W, targets, m, s, c, i * chunk,
                             chunk, V, use_reentrant=False,
                             preserve_rng_state=False)
    return torch.log(s) + m - c
