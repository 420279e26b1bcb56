"""Decoder LM for dense-attention architectures, the counterpart of
``repro.models.transformer``.

``Transformer`` holds ``embed``, ``final_norm`` and ``stack``, an
``nn.ModuleList`` of the ``n_periods`` period blocks; block i holds
``sub{j}`` with ``ln1``, ``ln2``, ``mixer`` and ``mlp``, as ``repro``'s
pytree does with a leading period axis on ``stack``.  ``prefill`` builds the
cache and ``decode_step`` takes one token against it.

Training differentiates with respect to a ``{name: tensor}`` dict of the
parameters (``param_dict``; 9 leaves per layer, 12 with QKV biases, plus
the embedding, the final norm and an untied head, 290 at smollm-360m):
``apply_params`` runs ``forward`` or
``forward_hidden`` with the module's parameters replaced by the dict
(``torch.func.functional_call``), and ``value_and_grad`` takes gradients by
plain autograd.  The module's own parameters never require grad, so
serving builds no graph.  Each period of the stack runs under one
``torch.utils.checkpoint`` (``repro``'s default ``remat_policy="full"``),
with the period's parameters handed to the checkpointed function, so the
recomputation in the backward sees the same tensors.

The cache is ``{"stack": {"sub0": {"mixer": {"k", "v"}}}}`` as in
``repro``, each leaf ``[n_periods, B, S, Kv, hd]``, S each sublayer's own:
the maximum context for full attention, the ring's width for a
sliding-window or chunked one (``attention.init_attn_cache``).  A period
of ``[chunk, global]`` sublayers (``global_attn_every``) keeps one dict per
``sub{j}``.  ``decode_step`` writes the cache in place and returns the
same dict.

A vision config (``frontend="vision"``) prepends ``frontend_embeds``
``[B, n_frontend_tokens, d]`` to the token embeddings, as ``repro``'s
``_embed_inputs`` does, and raises ``ValueError`` without them; an audio
config's codes are ordinary token ids.

MoE, Mamba, RWKV and MLA sublayers and ``first_k_dense`` prefix layers
raise ``NotImplementedError``, as do the XLA checkpoint policies
``remat_policy="dots"``/``"dots_nb"`` and ``remat_sublayer``: ROADMAP queue
1, item 12.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ArchConfig, MIXER_ATTN,
                                      MIXER_ATTN_GLOBAL, MLP_DENSE)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.modules import (RMSNorm, SwiGLU, dense_init,
                                        embed_init, embed_lookup)

UNPORTED = attn.UNPORTED


def _check_supported(cfg: ArchConfig) -> None:
    for sub in cfg.sublayers():
        if sub.mixer not in (MIXER_ATTN, MIXER_ATTN_GLOBAL):
            raise NotImplementedError(
                f"{cfg.name}: {sub.mixer!r} mixers are {UNPORTED}")
        if sub.mlp != MLP_DENSE:
            raise NotImplementedError(
                f"{cfg.name}: {sub.mlp!r} MLPs are {UNPORTED}")
    if cfg.family == "ssm":
        raise NotImplementedError(f"{cfg.name}: LayerNorm stacks are "
                                  f"{UNPORTED}")
    if cfg.first_k_dense:
        raise NotImplementedError(f"{cfg.name}: first_k_dense prefix layers "
                                  f"are {UNPORTED}")


class SubLayerBlock(nn.Module):
    """One (attention, dense MLP) pair with its two RMSNorms."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mixer = attn.Attention(cfg, dtype, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)


class PeriodBlock(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        for j, _ in enumerate(cfg.sublayers()):
            self.add_module(f"sub{j}", SubLayerBlock(cfg, dtype, device))

    def forward(self, cfg, h, positions):
        """The period's sublayers on the training path."""
        for j, sub in enumerate(cfg.sublayers()):
            h, _ = _apply_sublayer(cfg, getattr(self, f"sub{j}"), sub.mixer,
                                   h, positions, train=True)
        return h


class Embed(nn.Module):
    def __init__(self, vocab, dim, dtype, device):
        super().__init__()
        self.table = nn.Parameter(
            torch.empty((vocab, dim), dtype=dtype, device=device),
            requires_grad=False)


class LMHead(nn.Module):
    def __init__(self, dim, vocab, dtype, device):
        super().__init__()
        self.w = nn.Parameter(
            torch.empty((dim, vocab), dtype=dtype, device=device),
            requires_grad=False)


class Transformer(nn.Module):
    """Parameters only, uninitialised (``init_params`` draws them,
    ``convert.transformer_params_from_jax`` copies them in)."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        _check_supported(cfg)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.stack = nn.ModuleList(
            PeriodBlock(cfg, dtype, device) for _ in range(cfg.n_periods))
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model, cfg.vocab_size, dtype, device)

    def forward(self, cfg, tokens, hidden=False, frontend_embeds=None):
        """Training forward (``forward_hidden`` when ``hidden``) with the
        parameters the module holds: what ``apply_params`` calls."""
        return (forward_hidden if hidden else forward)(cfg, self, tokens,
                                                       frontend_embeds)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Transformer:
    """``repro``'s init distributions (normal embeddings times 0.02,
    variance-scaled dense weights, unit norm scales), drawn from
    ``generator`` on its own device and placed on ``device`` (``None``: the
    card)."""
    device = resolve_device(device)
    model = Transformer(cfg, dtype, device)
    model.embed.table.copy_(embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dtype, device))
    for period in model.stack:
        for j, _ in enumerate(cfg.sublayers()):
            sub = getattr(period, f"sub{j}")
            sub.mixer.reset_parameters(generator)
            sub.mlp.reset_parameters(generator)
    if not cfg.tie_embeddings:
        model.lm_head.w.copy_(dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype,
                                         device=device))
    return model


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------
def _apply_sublayer(cfg, p, mixer_kind, h, positions, train=False):
    """Prefill (``train=False``, through K5) or training (``train=True``,
    the differentiable attention).  Returns (h, cache); the training cache
    is ``{"mixer": None}``."""
    kind, width = attn.mask_spec_for(cfg, mixer_kind)
    y, c = attn.attention_fwd(cfg, p.mixer, p.ln1(h), positions, kind, width,
                              train=train)
    h = h + y
    h = h + p.mlp(p.ln2(h))
    return h, {"mixer": c}


def _apply_sublayer_decode(cfg, p, mixer_kind, h, cache, pos, slots):
    """One-token path; writes ``cache`` in place.  Returns h."""
    kind, width = attn.mask_spec_for(cfg, mixer_kind)
    y, _ = attn.attention_decode(cfg, p.mixer, p.ln1(h), cache["mixer"], pos,
                                 kind, width, slots)
    h = h + y
    return h + p.mlp(p.ln2(h))


def _embed_inputs(cfg, model, tokens, frontend_embeds):
    """Token embeddings, after a vision config's ``frontend_embeds``."""
    h = embed_lookup(model.embed.table, tokens)
    if cfg.frontend == "vision" and cfg.n_frontend_tokens:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} requires frontend_embeds (B, "
                             f"{cfg.n_frontend_tokens}, {cfg.d_model})")
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    return h


def _lm_head(cfg, model, h):
    if cfg.tie_embeddings:
        return h @ model.embed.table.t()
    return h @ model.lm_head.w


# ---------------------------------------------------------------------------
# forward (train)
# ---------------------------------------------------------------------------
def _period_call(cfg, block, params, h, positions):
    return torch.func.functional_call(block, params, (cfg, h, positions))


def _run_stack(cfg, model, h, positions):
    """The period blocks in order, each under one checkpoint unless
    ``cfg.no_remat`` (``repro``'s ``_make_period_fn``)."""
    if cfg.remat_sublayer:
        raise NotImplementedError(f"remat_sublayer is {UNPORTED}")
    if not cfg.no_remat and cfg.remat_policy in ("dots", "dots_nb"):
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} (an XLA checkpoint policy) "
            f"is {UNPORTED}")
    if cfg.shard_activations:
        raise NotImplementedError("shard_activations is not ported yet "
                                  "(ROADMAP queue 1, item 13)")
    for block in model.stack:
        if cfg.no_remat:
            h = block(cfg, h, positions)
        else:
            # the period's current parameters go in as an argument: the
            # recomputation in the backward runs outside any functional_call
            h = checkpoint(_period_call, cfg, block,
                           dict(block.named_parameters()), h, positions,
                           use_reentrant=False, preserve_rng_state=False)
    return h


def forward_hidden(cfg: ArchConfig, model: Transformer, tokens,
                   frontend_embeds=None):
    """Like ``forward`` but returns the final-norm hidden states instead of
    logits: the vocab-chunked loss applies the LM head itself."""
    h = _embed_inputs(cfg, model, tokens, frontend_embeds)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = _run_stack(cfg, model, h, positions)
    return model.final_norm(h), aux


def forward(cfg: ArchConfig, model: Transformer, tokens,
            frontend_embeds=None):
    """tokens: [B, S] int, after a vision config's ``frontend_embeds``.
    Returns (logits [B, P + S, V], aux), P the frontend tokens; ``aux`` is
    a 0-d f32 zero (dense MLPs have no auxiliary loss)."""
    h, aux = forward_hidden(cfg, model, tokens, frontend_embeds)
    return _lm_head(cfg, model, h), aux


def param_dict(model: Transformer) -> dict:
    """``{name: tensor}`` of the model's parameters (the tensors
    themselves, not copies)."""
    return dict(model.named_parameters())


def head_weight(cfg: ArchConfig, params: dict):
    """[d, V] LM-head weight of a ``param_dict`` (the transposed embedding
    when tied)."""
    if cfg.tie_embeddings:
        return params["embed.table"].t()
    return params["lm_head.w"]


def apply_params(cfg: ArchConfig, model: Transformer, params: dict, tokens,
                 hidden=False, frontend_embeds=None):
    """``forward`` (``forward_hidden`` when ``hidden``) of ``model`` with its
    parameters replaced by ``params``, a dict named as ``param_dict``
    names them; the module's buffers (RoPE frequencies) stay its own."""
    return torch.func.functional_call(
        model, params, (cfg, tokens),
        {"hidden": hidden, "frontend_embeds": frontend_embeds})


def value_and_grad(loss_fn):
    """``loss_fn(params, *args)`` -> ``vg(params, *args) = (loss,
    grads)``, ``grads`` a dict like ``params``: ``jax.value_and_grad`` over
    a param dict, by plain autograd (``torch.func``'s transforms refuse the
    checkpointed periods' saved-tensor hooks).  ``loss`` comes back
    detached, on the device: reading it is the caller's choice."""
    def vg(params, *args):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, *args)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))
    return vg


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
def prefill(cfg: ArchConfig, model: Transformer, tokens,
            frontend_embeds=None):
    """tokens: [B, S] int, after a vision config's ``frontend_embeds``.
    Returns (logits [B, P + S, V], cache), P the frontend tokens."""
    h = _embed_inputs(cfg, model, tokens, frontend_embeds)
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    subs = cfg.sublayers()
    per_layer = {f"sub{j}": [] for j in range(len(subs))}
    for period in model.stack:
        for j, sub in enumerate(subs):
            h, c = _apply_sublayer(cfg, getattr(period, f"sub{j}"),
                                   sub.mixer, h, positions)
            per_layer[f"sub{j}"].append(c["mixer"])
    stack = {name: {"mixer": {leaf: torch.stack([c[leaf] for c in cs])
                              for leaf in ("k", "v")}}
             for name, cs in per_layer.items()}
    h = model.final_norm(h)
    return _lm_head(cfg, model, h), {"stack": stack}


def decode_step(cfg: ArchConfig, model: Transformer, token, cache, pos):
    """token: [B, 1] int; ``pos``: an int, a 0-d tensor or a per-sequence
    ``[B]`` tensor of absolute positions.  Writes the new K/V into
    ``cache`` in place.  Returns (logits [B, 1, V], cache)."""
    h = embed_lookup(model.embed.table, token)
    pos = attn.as_positions(pos, h.device)
    subs = cfg.sublayers()
    # each sublayer's slot and pos', once a step rather than once a layer
    slots = [attn.ring_slots(pos, attn.mask_spec_for(cfg, sub.mixer)[0],
                             cache["stack"][f"sub{j}"]["mixer"]["k"].shape[2])
             for j, sub in enumerate(subs)]
    for i, period in enumerate(model.stack):
        for j, sub in enumerate(subs):
            leaves = cache["stack"][f"sub{j}"]["mixer"]
            layer = {"mixer": {"k": leaves["k"][i], "v": leaves["v"][i]}}
            h = _apply_sublayer_decode(cfg, getattr(period, f"sub{j}"),
                                       sub.mixer, h, layer, pos, slots[j])
    h = model.final_norm(h)
    return _lm_head(cfg, model, h), cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch, max_seq, dtype=torch.float32,
               device=None):
    """Zero caches, each leaf ``[n_periods, batch, S, Kv, hd]`` on
    ``device`` (``None``: the card), S = ``max_seq`` for full attention and
    ``min(width, max_seq)`` for a ring."""
    _check_supported(cfg)
    device = resolve_device(device)
    stack = {}
    for j, sub in enumerate(cfg.sublayers()):
        kind, width = attn.mask_spec_for(cfg, sub.mixer)
        c = attn.init_attn_cache(cfg, batch, max_seq, kind, width, dtype,
                                 device)
        stack[f"sub{j}"] = {"mixer": {
            k: v.new_zeros((cfg.n_periods, *v.shape)) for k, v in c.items()}}
    return {"stack": stack}


def grow_cache(cfg: ArchConfig, cache, batch, max_seq, dtype=torch.float32):
    """Pad a prefill-produced cache out to ``max_seq`` decode capacity:
    full-attention caches grow along the sequence axis, zero-padded at the
    tail (future slots), into new tensors; ring caches are already in
    decode layout and pass through (as ``dtype``).  Raises ``ValueError``
    where a leaf does not fit, as a ring of ``width`` slots does not fit a
    ``max_seq`` below it (``repro``'s pad fails there too)."""
    out = {}
    for j, sub in enumerate(cfg.sublayers()):
        kind, width = attn.mask_spec_for(cfg, sub.mixer)
        seq = max_seq if kind == "full" else min(width, max_seq)
        leaves = {}
        for k, c in cache["stack"][f"sub{j}"]["mixer"].items():
            target = (cfg.n_periods, batch, seq, *c.shape[3:])
            if tuple(c.shape[:2]) != target[:2] or c.shape[2] > seq or (
                    kind != "full" and c.shape[2] != seq):
                raise ValueError(f"grow_cache: sub{j} {k} {tuple(c.shape)} "
                                 f"does not fit {target}")
            if kind != "full":
                leaves[k] = c.to(dtype)
                continue
            g = torch.zeros(target, dtype=dtype, device=c.device)
            g[:, :, :c.shape[2]] = c
            leaves[k] = g
        out[f"sub{j}"] = {"mixer": leaves}
    return {"stack": out}


def param_count(cfg: ArchConfig) -> int:
    """Parameter count, from the shapes alone (built on the meta device)."""
    return sum(p.numel() for p in
               Transformer(cfg, torch.bfloat16, "meta").parameters())
