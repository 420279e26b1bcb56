"""Decoder LM for every ported architecture, the counterpart of
``repro.models.transformer``.

``Transformer`` holds ``embed``, ``final_norm``, ``stack``, an
``nn.ModuleList`` of the ``n_periods`` period blocks, and with
``first_k_dense`` a ``prefix`` ``ModuleList`` of dense sublayers run before
the stack on every path; block i holds ``sub{j}`` with ``ln1``, ``ln2``
(``LayerNorm`` for an SSM family, ``RMSNorm`` otherwise, as is
``final_norm``), ``mixer`` (GQA ``Attention``, ``MLA``, ``mamba.Mamba`` or
``rwkv.TimeMix``) and ``mlp`` (``SwiGLU``, ``MoE`` or ``rwkv.ChannelMix``),
as ``repro``'s pytree does with a leading period axis on ``stack``.
``prefill`` builds the cache and ``decode_step`` takes one token against
it.

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
in ``repro``: each stack leaf ``[n_periods, B, ...]``, each prefix leaf
``[B, ...]``; GQA leaves ``k``/``v`` ``[.., S, Kv, hd]``, S each
sublayer's own (the maximum context for full attention, the ring's width
for a sliding-window or chunked one: ``attention.init_attn_cache``), MLA
leaves ``c_kv [.., S, lora]`` and ``k_rope [.., S, rope]``.  Mamba and
RWKV sublayers hold state with no sequence axis: Mamba ``conv [.., dc - 1,
di]`` and ``ssm [.., di, ds]``, the time-mix ``wkv [.., H, N, N]`` and
``shift [.., d]``, and beside ``mixer`` an ``mlp`` group with the
channel-mix's ``shift [.., d]``.  ``decode_step`` writes the cache in
place (a state leaf's new value copied into its period's slice) and
returns the same dict.

A vision config (``frontend="vision"``) prepends ``frontend_embeds``
``[B, n_frontend_tokens, d]`` to the token embeddings, as ``repro``'s
``_embed_inputs`` does, and raises ``ValueError`` without them; an audio
config's codes are ordinary token ids.

"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import (ArchConfig, MIXER_ATTN,
                                      MIXER_ATTN_GLOBAL, MIXER_MAMBA,
                                      MIXER_MLA, MIXER_RWKV, MLP_MOE,
                                      MLP_RWKV, SubLayer)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba, moe, rwkv
from repro_torch.models.modules import (LayerNorm, RMSNorm, SwiGLU,
                                        dense_init, embed_init, embed_lookup)
from repro_torch.sharding import dtensor as dt

# mixers whose cache is a state with no sequence axis
SSM_MIXERS = (MIXER_MAMBA, MIXER_RWKV)
_MIXERS = {MIXER_ATTN: attn.Attention, MIXER_ATTN_GLOBAL: attn.Attention,
           MIXER_MLA: attn.MLA, MIXER_MAMBA: mamba.Mamba,
           MIXER_RWKV: rwkv.TimeMix}


def _norm(cfg, dtype, device):
    """``repro``'s ``_norm_init``: LayerNorm for an SSM family, RMSNorm
    otherwise."""
    return (LayerNorm if cfg.family == "ssm" else RMSNorm)(
        cfg.d_model, cfg.norm_eps, dtype, device)


def is_state(sub: SubLayer, group: str) -> bool:
    """Whether a sublayer's cache group (``"mixer"`` or ``"mlp"``) is a
    state with no sequence axis: a Mamba or RWKV mixer's, or the
    channel-mix's shift."""
    return group == "mlp" or sub.mixer in SSM_MIXERS


class SubLayerBlock(nn.Module):
    """One (mixer, MLP) pair with its two norms: the mixer GQA
    ``Attention``, ``MLA``, ``Mamba`` or ``TimeMix``, the MLP ``SwiGLU``,
    ``MoE`` or ``ChannelMix``, as ``sub`` says."""

    def __init__(self, cfg, sub: SubLayer, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        self.mixer = _MIXERS[sub.mixer](cfg, dtype, device)
        if sub.mlp == MLP_MOE:
            self.mlp = moe.MoE(cfg, dtype, device)
        elif sub.mlp == MLP_RWKV:
            self.mlp = rwkv.ChannelMix(cfg, dtype, device)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)

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
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        self.final_norm = _norm(cfg, dtype, device)
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
    variance-scaled dense weights, unit norm scales, zero LayerNorm biases,
    the SSM layers' own), drawn from
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
    cache): ``aux`` the MoE loss (None for another MLP), the cache
    ``{"mixer": ...}`` and, after a channel-mix, ``{"mlp": ...}`` (the
    training cache ``{"mixer": None}``)."""
    with dt.gathered(p, h):
        x = p.ln1(h)
        if sub.mixer == MIXER_MLA:
            y, c = attn.mla_fwd(cfg, p.mixer, x, positions)
        elif sub.mixer == MIXER_MAMBA:
            y, c = _rows(mamba.mamba_fwd, cfg, p.mixer, x)
        elif sub.mixer == MIXER_RWKV:
            y, c = _rows(rwkv.time_mix_fwd, cfg, p.mixer, x)
        else:
            kind, width = attn.mask_spec_for(cfg, sub.mixer)
            y, c = attn.attention_fwd(cfg, p.mixer, x, positions, kind, width,
                                      train=train)
        cache = {"mixer": None if train else c}
        h = dt.settle(h + y)
        x = p.ln2(h)
        aux = None
        if sub.mlp == MLP_MOE:
            y, aux = _moe(moe.moe_fwd, cfg, p.mlp, x)
        elif sub.mlp == MLP_RWKV:
            y, cm = _rows(rwkv.channel_mix_fwd, cfg, p.mlp, x)
            if not train:
                cache["mlp"] = cm
        else:
            y = p.mlp(x)
        return dt.settle(h + y), aux, cache


def _moe(fn, cfg, p, x):
    """``fn(cfg, p, x)``; on DTensors, on full copies on every rank: the
    stable sort, the capacity dispatch and ``index_add`` have no DTensor
    rule (``sharding/dtensor.py``)."""
    if dt.is_dtensor(x):
        return dt.on_rows(lambda m, xl: fn(cfg, m, xl), p, x, split=False)
    return fn(cfg, p, x)


def _rows(fn, cfg, p, *args):
    """``fn(cfg, p, *args)``; on DTensors, on each rank's batch rows (the
    SSM layers: their scans' per-step ops have no DTensor rule, and rows
    never meet in them)."""
    if dt.is_dtensor(args[0]):
        return dt.on_rows(lambda m, *a: fn(cfg, m, *a), p, *args)
    return fn(cfg, p, *args)


def _functional(block, params, *args):
    """``block(*args)`` with ``params`` in place of its parameters: what a
    checkpoint runs, so that its recomputation in the backward reads the
    parameters it was given, outside any ``functional_call``."""
    return torch.func.functional_call(block, params, args)


def _set_state(leaves, new):
    """Copy a state's new value into its leaves (views into the stacked
    cache) in place."""
    for k, v in new.items():
        leaves[k].copy_(v)


def _apply_sublayer_decode(cfg, p, sub: SubLayer, h, cache, pos, slots):
    """One-token path; writes ``cache`` in place.  Returns h."""
    with dt.gathered(p, h):
        x = p.ln1(h)
        if sub.mixer == MIXER_MLA:
            y, _ = attn.mla_decode(cfg, p.mixer, x, cache["mixer"], pos)
        elif sub.mixer in SSM_MIXERS:
            fn = (mamba.mamba_decode if sub.mixer == MIXER_MAMBA
                  else rwkv.time_mix_decode)
            y, new = _rows(fn, cfg, p.mixer, x, cache["mixer"])
            _set_state(cache["mixer"], new)
        else:
            kind, width = attn.mask_spec_for(cfg, sub.mixer)
            y, _ = attn.attention_decode(cfg, p.mixer, x, cache["mixer"], pos,
                                         kind, width, slots)
        h = dt.settle(h + y)
        x = p.ln2(h)
        if sub.mlp == MLP_MOE:
            y = _moe(moe.moe_decode, cfg, p.mlp, x)[0]
        elif sub.mlp == MLP_RWKV:
            y, new = _rows(rwkv.channel_mix_decode, cfg, p.mlp, x,
                           cache["mlp"])
            _set_state(cache["mlp"], new)
        else:
            y = p.mlp(x)
        return dt.settle(h + y)


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
        return h @ dt.fsdp_gather(model.embed.table).t()
    return h @ dt.fsdp_gather(model.lm_head.w)


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


def _shard_h(cfg: ArchConfig, h):
    """``repro``'s ``_maybe_shard_h``: with ``shard_activations``, ``h``
    redistributed to batch over ``"data"`` and d_model over ``"model"``
    (the sequence-parallel analog; anchoring the batch keeps the products
    from contracting over ``"data"``).  Without a mesh it raises, as
    ``repro``'s ``with_sharding_constraint`` does outside one."""
    if not cfg.shard_activations:
        return h
    if not dt.is_dtensor(h):
        raise RuntimeError(
            "shard_activations needs a mesh: the activations are plain "
            "tensors (give the model DTensor parameters, "
            "sharding.spec_tree_to_shardings)")
    from torch.distributed.tensor import Replicate, Shard
    names = h.device_mesh.mesh_dim_names
    want = [Shard(0) if n == "data" else Shard(2) if n == "model"
            else Replicate() for n in names]
    return h.redistribute(placements=want)


def _run_stack(cfg: ArchConfig, model: Transformer, h, aux, positions):
    """The period blocks in order, each under one checkpoint with
    ``cfg.remat_policy``'s context unless ``cfg.no_remat`` (``repro``'s
    ``_make_period_fn``), ``h`` resharded after the prefix and after every
    period under ``shard_activations``.  Returns (h, aux)."""
    h = _shard_h(cfg, h)
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
        h = _shard_h(cfg, h)
    return h, aux


def forward_hidden(cfg: ArchConfig, model: Transformer, tokens,
                   frontend_embeds=None):
    """Like ``forward`` but returns the final-norm hidden states instead of
    logits: the vocab-chunked loss applies the LM head itself."""
    h = _embed_inputs(cfg, model, tokens, frontend_embeds)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    aux = dt.like(h, torch.zeros((), dtype=torch.float32, device=h.device))
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
            per_layer[f"sub{j}"].append(c)
    stack = {name: {group: {leaf: torch.stack([c[group][leaf] for c in cs])
                            for leaf in cs[0][group]}
                    for group in cs[0]}
             for name, cs in per_layer.items()}
    cache = {"stack": stack}
    if prefix:
        cache["prefix"] = prefix
    h = model.final_norm(h)
    return _lm_head(cfg, model, h), cache


def _slots(cfg, mixer_kind, leaves, pos):
    """A GQA sublayer's ``attention.ring_slots`` for this step (None for
    MLA, Mamba and RWKV, which have no ring); ``leaves`` its cache, the
    sequence axis second to last but two (``k [.., S, Kv, hd]``)."""
    if mixer_kind == MIXER_MLA or mixer_kind in SSM_MIXERS:
        return None
    return attn.ring_slots(pos, attn.mask_spec_for(cfg, mixer_kind)[0],
                           leaves["k"].shape[-3])


def decode_step(cfg: ArchConfig, model: Transformer, token, cache, pos):
    """token: [B, 1] int; ``pos``: an int, a 0-d tensor or a per-sequence
    ``[B]`` tensor of absolute positions.  Writes the new K/V (MLA
    latents, SSM states) into ``cache`` in place.  Returns (logits [B, 1,
    V], cache)."""
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
            layer = {group: {k: v[i] for k, v in leaves.items()}
                     for group, leaves in cache["stack"][f"sub{j}"].items()}
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


def _sublayer_cache(cfg, sub, batch, max_seq, dtype, device):
    """``repro``'s ``_sublayer_cache``: the mixer's zero cache and, after a
    channel-mix, its zero ``shift``."""
    if sub.mixer == MIXER_MLA:
        c = attn.init_mla_cache(cfg, batch, max_seq, dtype, device)
    elif sub.mixer == MIXER_MAMBA:
        c = mamba.init_mamba_cache(cfg, batch, dtype, device)
    elif sub.mixer == MIXER_RWKV:
        r = rwkv.init_rwkv_cache(cfg, batch, dtype, device)
        c = {"wkv": r["wkv"], "shift": r["shift_tm"]}
    else:
        kind, width = attn.mask_spec_for(cfg, sub.mixer)
        c = attn.init_attn_cache(cfg, batch, max_seq, kind, width, dtype,
                                 device)
    cache = {"mixer": c}
    if sub.mlp == MLP_RWKV:
        cache["mlp"] = {"shift": torch.zeros((batch, cfg.d_model),
                                             dtype=dtype, device=device)}
    return cache


def init_cache(cfg: ArchConfig, batch, max_seq, dtype=torch.float32,
               device=None):
    """Zero caches on ``device`` (``None``: the card): each stack leaf
    ``[n_periods, batch, ...]``, each prefix leaf ``[batch, ...]``; a
    sequence axis of ``max_seq`` for full attention and MLA, ``min(width,
    max_seq)`` for a ring, none for an SSM state (float32 ``wkv`` and
    ``ssm``, the rest in ``dtype``).  ``device="meta"`` gives the shapes
    alone (the sharding specs and the dry run read them)."""
    if str(device) != "meta":
        device = resolve_device(device)
    stack = {}
    for j, sub in enumerate(cfg.sublayers()):
        c = _sublayer_cache(cfg, sub, batch, max_seq, dtype, device)
        stack[f"sub{j}"] = {group: {
            k: v.new_zeros((cfg.n_periods, *v.shape)) for k, v in g.items()}
            for group, g in c.items()}
    cache = {"stack": stack}
    if cfg.first_k_dense:
        cache["prefix"] = [
            _sublayer_cache(cfg, cfg.prefix_sublayer(), batch, max_seq,
                            dtype, device)
            for _ in range(cfg.first_k_dense)]
    return cache


def _grow(leaves, lead, batch, seq, grows, dtype, where):
    """One sublayer's cache leaves at ``seq`` positions: a growing leaf
    zero-padded at the tail into a new tensor, a ring passed through, a
    state (``seq`` None) passed through as it is (float32 ``wkv`` and
    ``ssm`` stay float32, as ``repro``'s pad leaves them)."""
    out = {}
    for k, c in leaves.items():
        n = len(lead)
        if seq is None:
            if tuple(c.shape[:n + 1]) != (*lead, batch):
                raise ValueError(f"grow_cache: {where} {k} {tuple(c.shape)} "
                                 f"does not fit {(*lead, batch)}")
            out[k] = c
            continue
        target = (*lead, batch, seq, *c.shape[n + 2:])
        if tuple(c.shape[:n + 1]) != target[:n + 1] or c.shape[n + 1] > seq \
                or (not grows and c.shape[n + 1] != seq):
            raise ValueError(f"grow_cache: {where} {k} {tuple(c.shape)} "
                             f"does not fit {target}")
        if not grows:
            out[k] = c.to(dtype)
            continue
        # zeros at the tail of the sequence axis (a pad, which DTensor
        # caches take too)
        tail = (0, 0) * (c.dim() - n - 2) + (0, seq - c.shape[n + 1])
        out[k] = torch.nn.functional.pad(c.to(dtype), tail)
    return out


def grow_cache(cfg: ArchConfig, cache, batch, max_seq, dtype=torch.float32):
    """Pad a prefill-produced cache out to ``max_seq`` decode capacity:
    full-attention and MLA caches grow along the sequence axis,
    zero-padded at the tail (future slots), into new tensors; ring caches
    are already in decode layout and pass through (as ``dtype``), SSM
    states pass through unchanged.  Raises
    ``ValueError`` where a leaf does not fit, as a ring of ``width`` slots
    does not fit a ``max_seq`` below it (``repro``'s pad fails there
    too)."""
    def grow(sub, c, lead, where):
        out = {}
        for group, leaves in c.items():
            seq, grows = ((None, False) if is_state(sub, group)
                          else _seq_len(cfg, sub.mixer, max_seq))
            out[group] = _grow(leaves, lead, batch, seq, grows, dtype,
                               f"{where} {group}")
        return out
    out = {"stack": {f"sub{j}": grow(sub, cache["stack"][f"sub{j}"],
                                     (cfg.n_periods,), f"sub{j}")
                     for j, sub in enumerate(cfg.sublayers())}}
    if "prefix" in cache:
        out["prefix"] = [grow(cfg.prefix_sublayer(), c, (), f"prefix {i}")
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
