"""Decoder LM for every ported architecture, the counterpart of
``repro.models.transformer``.

``Transformer`` holds ``embed``, ``final_norm``, ``stack``, an
``nn.ModuleList`` of the ``n_periods`` period blocks, and with
``first_k_dense`` a ``prefix`` ``ModuleList`` of dense sublayers run before
the stack on every path; block i holds ``sub{j}`` with ``ln1``, ``ln2``,
``mixer`` (GQA ``Attention`` or ``MLA``) and ``mlp`` (``SwiGLU`` or
``MoE``), as ``repro``'s pytree does with a leading period axis on
``stack``.  ``prefill`` builds the cache and ``decode_step`` takes one
token against it.

Training differentiates with respect to a ``{name: tensor}`` dict of the
parameters (``param_dict``): ``apply_params`` runs ``forward`` or
``forward_hidden`` with the module's parameters replaced by the dict
(``torch.func.functional_call``), and ``value_and_grad`` takes gradients by
plain autograd.  The module's own parameters never require grad, so
serving builds no graph.  ``forward`` returns the MoE layers' summed
load-balance loss beside the logits.  The checkpoint policies are
``repro``'s ``_make_period_fn``'s (``_run_stack``): each period under one
``torch.utils.checkpoint`` (``remat_policy="full"``), under a selective
checkpoint that saves every matrix product (``"dots"``) or only the
weight-activation ones (``"dots_nb"``), each sublayer under a checkpoint
of its own inside the period's (``remat_sublayer``), or none
(``no_remat``); the period's parameters are handed to the checkpointed
function, so the recomputation in the backward sees the same tensors.

The cache is ``{"stack": {"sub0": {"mixer": {...}}}, "prefix": [...]}`` as
in ``repro``: each stack leaf ``[n_periods, B, S, ...]``, each prefix leaf
``[B, S, ...]``; GQA leaves ``k``/``v`` ``[.., S, Kv, hd]``, S each
sublayer's own (the maximum context for full attention, the ring's width
for a sliding-window or chunked one: ``attention.init_attn_cache``), MLA
leaves ``c_kv [.., S, lora]`` and ``k_rope [.., S, rope]``.
``decode_step`` writes the cache in place and returns the same dict.

A vision config (``frontend="vision"``) prepends ``frontend_embeds``
``[B, n_frontend_tokens, d]`` to the token embeddings, as ``repro``'s
``_embed_inputs`` does, and raises ``ValueError`` without them; an audio
config's codes are ordinary token ids.

Mamba and RWKV sublayers and LayerNorm stacks raise
``NotImplementedError``: ROADMAP queue 1, item 12.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import (ArchConfig, MIXER_ATTN,
                                      MIXER_ATTN_GLOBAL, MIXER_MLA, MLP_DENSE,
                                      MLP_MOE, SubLayer)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.modules import (RMSNorm, SwiGLU, dense_init,
                                        embed_init, embed_lookup)

UNPORTED = attn.UNPORTED


def _check_supported(cfg: ArchConfig) -> None:
    for sub in cfg.sublayers():
        if sub.mixer not in (MIXER_ATTN, MIXER_ATTN_GLOBAL, MIXER_MLA):
            raise NotImplementedError(
                f"{cfg.name}: {sub.mixer!r} mixers are {UNPORTED}")
        if sub.mlp not in (MLP_DENSE, MLP_MOE):
            raise NotImplementedError(
                f"{cfg.name}: {sub.mlp!r} MLPs are {UNPORTED}")
    if cfg.family == "ssm":
        raise NotImplementedError(f"{cfg.name}: LayerNorm stacks are "
                                  f"{UNPORTED}")


class SubLayerBlock(nn.Module):
    """One (mixer, MLP) pair with its two RMSNorms: the mixer GQA
    ``Attention`` or ``MLA``, the MLP ``SwiGLU`` or ``MoE``, as ``sub``
    says."""

    def __init__(self, cfg, sub: SubLayer, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.mixer = (attn.MLA if sub.mixer == MIXER_MLA
                      else attn.Attention)(cfg, dtype, device)
        self.mlp = (moe.MoE(cfg, dtype, device) if sub.mlp == MLP_MOE
                    else SwiGLU(cfg.d_model, cfg.d_ff, dtype, device))

    def reset_parameters(self, generator):
        self.mixer.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, cfg, sub, h, positions):
        """The training path of this sublayer: (h, aux)."""
        h, aux, _ = _apply_sublayer(cfg, self, sub, h, positions, train=True)
        return h, aux


class PeriodBlock(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        for j, sub in enumerate(cfg.sublayers()):
            self.add_module(f"sub{j}", SubLayerBlock(cfg, sub, dtype, device))

    def forward(self, cfg: ArchConfig, h, aux, positions):
        """The period's sublayers on the training path, each under a
        checkpoint of its own with ``remat_sublayer``.  Returns (h, aux),
        ``aux`` plus the period's MoE losses."""
        for j, sub in enumerate(cfg.sublayers()):
            block = getattr(self, f"sub{j}")
            if cfg.remat_sublayer:
                h, a = checkpoint(_functional, block,
                                  dict(block.named_parameters()), cfg, sub,
                                  h, positions, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, a = block(cfg, sub, h, positions)
            if a is not None:
                aux = aux + a
        return h, aux


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
        if cfg.first_k_dense:
            self.prefix = nn.ModuleList(
                SubLayerBlock(cfg, cfg.prefix_sublayer(), dtype, device)
                for _ in range(cfg.first_k_dense))
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
    for block in _prefix(model):
        block.reset_parameters(generator)
    for period in model.stack:
        for j, _ in enumerate(cfg.sublayers()):
            getattr(period, f"sub{j}").reset_parameters(generator)
    if not cfg.tie_embeddings:
        model.lm_head.w.copy_(dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype,
                                         device=device))
    return model


# ---------------------------------------------------------------------------
# sublayer application
# ---------------------------------------------------------------------------
def _prefix(model):
    """The ``first_k_dense`` prefix blocks (none without)."""
    return getattr(model, "prefix", ())


def _apply_sublayer(cfg, p, sub: SubLayer, h, positions, train=False):
    """Prefill (``train=False``: GQA through K5) or training
    (``train=True``: the differentiable attention).  Returns (h, aux,
    cache): ``aux`` the MoE loss (None for a dense MLP), the training
    cache ``{"mixer": None}``."""
    x = p.ln1(h)
    if sub.mixer == MIXER_MLA:
        y, c = attn.mla_fwd(cfg, p.mixer, x, positions)
    else:
        kind, width = attn.mask_spec_for(cfg, sub.mixer)
        y, c = attn.attention_fwd(cfg, p.mixer, x, positions, kind, width,
                                  train=train)
    h = h + y
    x = p.ln2(h)
    if sub.mlp == MLP_MOE:
        y, aux = moe.moe_fwd(cfg, p.mlp, x)
    else:
        y, aux = p.mlp(x), None
    return h + y, aux, {"mixer": None if train else c}


def _functional(block, params, *args):
    """``block(*args)`` with ``params`` in place of its parameters: what a
    checkpoint runs, so that its recomputation in the backward reads the
    parameters it was given, outside any ``functional_call``."""
    return torch.func.functional_call(block, params, args)


def _apply_sublayer_decode(cfg, p, sub: SubLayer, h, cache, pos, slots):
    """One-token path; writes ``cache`` in place.  Returns h."""
    x = p.ln1(h)
    if sub.mixer == MIXER_MLA:
        y, _ = attn.mla_decode(cfg, p.mixer, x, cache["mixer"], pos)
    else:
        kind, width = attn.mask_spec_for(cfg, sub.mixer)
        y, _ = attn.attention_decode(cfg, p.mixer, x, cache["mixer"], pos,
                                     kind, width, slots)
    h = h + y
    x = p.ln2(h)
    y = moe.moe_decode(cfg, p.mlp, x)[0] if sub.mlp == MLP_MOE else p.mlp(x)
    return h + y


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
# the products a selective checkpoint saves, by policy: "dots" every matrix
# product (jax's dots_saveable), "dots_nb" only the weight-activation ones,
# recomputing the batch-dim products of the attention scores and the MoE
# experts (dots_with_no_batch_dims_saveable)
_aten = torch.ops.aten
SAVED_PRODUCTS = {
    "dots": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default],
    "dots_nb": [_aten.mm.default, _aten.addmm.default],
}


def _context_fn(cfg):
    """The period checkpoint's ``context_fn`` for ``cfg.remat_policy``
    (any other policy than "dots"/"dots_nb" recomputes everything, as
    ``repro``'s ``_make_period_fn`` does)."""
    saved = SAVED_PRODUCTS.get(cfg.remat_policy)
    if saved is None:
        return noop_context_fn
    return partial(create_selective_checkpoint_contexts, saved)


def _run_stack(cfg: ArchConfig, model: Transformer, h, aux, positions):
    """The period blocks in order, each under one checkpoint with
    ``cfg.remat_policy``'s context unless ``cfg.no_remat`` (``repro``'s
    ``_make_period_fn``).  Returns (h, aux)."""
    if cfg.shard_activations:
        raise NotImplementedError("shard_activations is not ported yet "
                                  "(ROADMAP queue 1, item 13)")
    for block in model.stack:
        if cfg.no_remat:
            h, aux = block(cfg, h, aux, positions)
        else:
            # the period's current parameters go in as an argument: the
            # recomputation in the backward runs outside any functional_call
            h, aux = checkpoint(_functional, block,
                                dict(block.named_parameters()), cfg, h, aux,
                                positions, use_reentrant=False,
                                preserve_rng_state=False,
                                context_fn=_context_fn(cfg))
    return h, aux


def forward_hidden(cfg: ArchConfig, model: Transformer, tokens,
                   frontend_embeds=None):
    """Like ``forward`` but returns the final-norm hidden states instead of
    logits: the vocab-chunked loss applies the LM head itself."""
    h = _embed_inputs(cfg, model, tokens, frontend_embeds)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for block in _prefix(model):
        h, a = block(cfg, cfg.prefix_sublayer(), h, positions)
        if a is not None:
            aux = aux + a
    h, aux = _run_stack(cfg, model, h, aux, positions)
    return model.final_norm(h), aux


def forward(cfg: ArchConfig, model: Transformer, tokens,
            frontend_embeds=None):
    """tokens: [B, S] int, after a vision config's ``frontend_embeds``.
    Returns (logits [B, P + S, V], aux), P the frontend tokens; ``aux`` is
    the 0-d f32 sum of the MoE layers' load-balance losses (zero without
    MoE layers)."""
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
    prefix = []
    for block in _prefix(model):
        h, _, c = _apply_sublayer(cfg, block, cfg.prefix_sublayer(), h,
                                  positions)
        prefix.append(c)
    subs = cfg.sublayers()
    per_layer = {f"sub{j}": [] for j in range(len(subs))}
    for period in model.stack:
        for j, sub in enumerate(subs):
            h, _, c = _apply_sublayer(cfg, getattr(period, f"sub{j}"), sub,
                                      h, positions)
            per_layer[f"sub{j}"].append(c["mixer"])
    stack = {name: {"mixer": {leaf: torch.stack([c[leaf] for c in cs])
                              for leaf in cs[0]}}
             for name, cs in per_layer.items()}
    cache = {"stack": stack}
    if prefix:
        cache["prefix"] = prefix
    h = model.final_norm(h)
    return _lm_head(cfg, model, h), cache


def _slots(cfg, mixer_kind, leaves, pos):
    """A GQA sublayer's ``attention.ring_slots`` for this step (None for
    MLA, which has no ring); ``leaves`` its cache, the sequence axis
    second to last but two (``k [.., S, Kv, hd]``)."""
    if mixer_kind == MIXER_MLA:
        return None
    return attn.ring_slots(pos, attn.mask_spec_for(cfg, mixer_kind)[0],
                           leaves["k"].shape[-3])


def decode_step(cfg: ArchConfig, model: Transformer, token, cache, pos):
    """token: [B, 1] int; ``pos``: an int, a 0-d tensor or a per-sequence
    ``[B]`` tensor of absolute positions.  Writes the new K/V (or MLA
    latents) into ``cache`` in place.  Returns (logits [B, 1, V], cache)."""
    h = embed_lookup(model.embed.table, token)
    pos = attn.as_positions(pos, h.device)
    pre = cfg.prefix_sublayer()
    for block, c in zip(_prefix(model), cache.get("prefix", ())):
        h = _apply_sublayer_decode(cfg, block, pre, h, c, pos,
                                   _slots(cfg, pre.mixer, c["mixer"], pos))
    subs = cfg.sublayers()
    # each sublayer's slot and pos', once a step rather than once a layer
    slots = [_slots(cfg, sub.mixer, cache["stack"][f"sub{j}"]["mixer"], pos)
             for j, sub in enumerate(subs)]
    for i, period in enumerate(model.stack):
        for j, sub in enumerate(subs):
            leaves = cache["stack"][f"sub{j}"]["mixer"]
            layer = {"mixer": {k: v[i] for k, v in leaves.items()}}
            h = _apply_sublayer_decode(cfg, getattr(period, f"sub{j}"),
                                       sub, h, layer, pos, slots[j])
    h = model.final_norm(h)
    return _lm_head(cfg, model, h), cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------
def _seq_len(cfg, mixer_kind, max_seq):
    """(the cache's sequence length, whether it grows with the context) of
    a sublayer: ``max_seq`` for full attention and MLA, ``min(width,
    max_seq)`` for a ring."""
    if mixer_kind == MIXER_MLA:
        return max_seq, True
    kind, width = attn.mask_spec_for(cfg, mixer_kind)
    if kind == "full":
        return max_seq, True
    return min(width, max_seq), False


def _mixer_cache(cfg, mixer_kind, batch, max_seq, dtype, device):
    if mixer_kind == MIXER_MLA:
        return attn.init_mla_cache(cfg, batch, max_seq, dtype, device)
    kind, width = attn.mask_spec_for(cfg, mixer_kind)
    return attn.init_attn_cache(cfg, batch, max_seq, kind, width, dtype,
                                device)


def init_cache(cfg: ArchConfig, batch, max_seq, dtype=torch.float32,
               device=None):
    """Zero caches on ``device`` (``None``: the card): each stack leaf
    ``[n_periods, batch, S, ...]``, each prefix leaf ``[batch, S, ...]``,
    S = ``max_seq`` for full attention and MLA, ``min(width, max_seq)``
    for a ring."""
    _check_supported(cfg)
    device = resolve_device(device)
    stack = {}
    for j, sub in enumerate(cfg.sublayers()):
        c = _mixer_cache(cfg, sub.mixer, batch, max_seq, dtype, device)
        stack[f"sub{j}"] = {"mixer": {
            k: v.new_zeros((cfg.n_periods, *v.shape)) for k, v in c.items()}}
    cache = {"stack": stack}
    if cfg.first_k_dense:
        cache["prefix"] = [
            {"mixer": _mixer_cache(cfg, cfg.prefix_sublayer().mixer, batch,
                                   max_seq, dtype, device)}
            for _ in range(cfg.first_k_dense)]
    return cache


def _grow(leaves, lead, batch, seq, grows, dtype, where):
    """One sublayer's cache leaves at ``seq`` positions: a growing leaf
    zero-padded at the tail into a new tensor, a ring passed through."""
    out = {}
    for k, c in leaves.items():
        n = len(lead)
        target = (*lead, batch, seq, *c.shape[n + 2:])
        if tuple(c.shape[:n + 1]) != target[:n + 1] or c.shape[n + 1] > seq \
                or (not grows and c.shape[n + 1] != seq):
            raise ValueError(f"grow_cache: {where} {k} {tuple(c.shape)} "
                             f"does not fit {target}")
        if not grows:
            out[k] = c.to(dtype)
            continue
        g = torch.zeros(target, dtype=dtype, device=c.device)
        g[(slice(None),) * (n + 1) + (slice(0, c.shape[n + 1]),)] = c
        out[k] = g
    return out


def grow_cache(cfg: ArchConfig, cache, batch, max_seq, dtype=torch.float32):
    """Pad a prefill-produced cache out to ``max_seq`` decode capacity:
    full-attention and MLA caches grow along the sequence axis,
    zero-padded at the tail (future slots), into new tensors; ring caches
    are already in decode layout and pass through (as ``dtype``).  Raises
    ``ValueError`` where a leaf does not fit, as a ring of ``width`` slots
    does not fit a ``max_seq`` below it (``repro``'s pad fails there
    too)."""
    out = {"stack": {}}
    for j, sub in enumerate(cfg.sublayers()):
        seq, grows = _seq_len(cfg, sub.mixer, max_seq)
        out["stack"][f"sub{j}"] = {"mixer": _grow(
            cache["stack"][f"sub{j}"]["mixer"], (cfg.n_periods,), batch, seq,
            grows, dtype, f"sub{j}")}
    if "prefix" in cache:
        seq, grows = _seq_len(cfg, cfg.prefix_sublayer().mixer, max_seq)
        out["prefix"] = [{"mixer": _grow(c["mixer"], (), batch, seq, grows,
                                         dtype, f"prefix {i}")}
                         for i, c in enumerate(cache["prefix"])]
    return out


def param_count(cfg: ArchConfig, active_only=False) -> int:
    """Parameter count, from the shapes alone (built on the meta device);
    ``active_only`` counts only the top-k routed experts of each MoE
    layer, as ``repro``'s does."""
    total = sum(p.numel() for p in
                Transformer(cfg, torch.bfloat16, "meta").parameters())
    if active_only and cfg.n_routed_experts:
        E, k = cfg.n_routed_experts, cfg.moe_top_k
        n_moe = sum(s.mlp == MLP_MOE for s in cfg.sublayers()) * cfg.n_periods
        total -= n_moe * (E - k) * 3 * cfg.d_model * cfg.moe_d_ff
    return total
