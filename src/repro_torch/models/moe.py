"""Mixture-of-Experts with capacity-based sort dispatch, the counterpart of
``repro.models.moe`` (GShard/MaxText-style token dropping).

Two paths, as in ``repro``:

* ``moe_fwd`` (train and prefill): per batch row, a stable sort of the
  (token, choice) assignments by expert, each assignment's place in its
  expert from the exclusive counts, assignments past the capacity ``C``
  dropped; the kept tokens are added into a ``[B, E*C, d]`` buffer, the
  experts' SwiGLU runs on it as batched products over E, and each token
  gathers its outputs back, weighted by its gate.
* ``moe_decode`` (S == 1): every expert on every token, combined through
  the dense gate mask; nothing is dropped.

Both return ``(y, aux)``, ``aux`` the switch-style load-balance loss, a
0-d float32 tensor.  The router is float32 whatever the model's dtype; the
expert weights are ``w_gate``/``w_up [E, d, f]`` and ``w_down [E, f, d]``.
``repro`` computes the expert products outside any Pallas kernel, so here
they are torch products too (``bmm``).  No step reads a device value on
the host: ``C`` comes from the shapes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import SwiGLU, dense_init


class MoE(nn.Module):
    """``router [d, E]`` (float32), ``w_gate``/``w_up [E, d, f]``,
    ``w_down [E, f, d]`` and, with shared experts, ``shared`` (a
    ``SwiGLU`` of width ``moe_d_ff * n_shared_experts``)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        E, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff

        def empty(shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.router = empty((d, E), torch.float32)
        self.w_gate = empty((E, d, f))
        self.w_up = empty((E, d, f))
        self.w_down = empty((E, f, d))
        if cfg.n_shared_experts:
            self.shared = SwiGLU(d, f * cfg.n_shared_experts, dtype, device)

    def reset_parameters(self, generator):
        """``repro``'s ``init_moe`` distributions (each expert weight drawn
        as ``[in, E, out]`` and moved to ``[E, in, out]``)."""
        d, E = self.router.shape
        f = self.w_gate.shape[2]
        dev, dt = self.w_gate.device, self.w_gate.dtype
        self.router.copy_(dense_init(generator, d, E, torch.float32,
                                     device=dev))
        for name, (i, o) in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d))):
            getattr(self, name).copy_(dense_init(
                generator, i, (E, o), dt, device=dev).permute(1, 0, 2))
        if hasattr(self, "shared"):
            self.shared.reset_parameters(generator)


def _router(cfg: ArchConfig, p, x):
    """x: [..., d] -> (top-k gates renormalised [..., k] in x's dtype,
    expert ids [..., k], aux).  Softmax in float32."""
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # switch-style aux loss: E * sum(fraction routed * mean prob), top-1
    E = cfg.n_routed_experts
    frac = F.one_hot(idx[..., 0], E).float().reshape(-1, E).mean(0)
    mean_prob = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(frac * mean_prob) * cfg.router_aux_coef
    return gates.to(x.dtype), idx, aux


def _experts(p, buf):
    """The experts' SwiGLU on ``buf [E, N, d]`` -> ``[E, N, d]``."""
    g = torch.bmm(buf, p.w_gate)
    u = torch.bmm(buf, p.w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, p.w_down)


def capacity(cfg: ArchConfig, S: int) -> int:
    """Slots per expert and batch row: ``ceil(S * k * capacity_factor /
    E)``."""
    return int(math.ceil(S * cfg.moe_top_k * cfg.capacity_factor
                         / cfg.n_routed_experts))


def moe_fwd(cfg: ArchConfig, p, x):
    """x: [B, S, d].  Sort-based capacity dispatch per batch row; returns
    (y [B, S, d], aux)."""
    B, S, d = x.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    C = capacity(cfg, S)
    gates, idx, aux = _router(cfg, p, x)                  # [B, S, k]
    flat_e = idx.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)    # [B, S*k]
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_g = torch.gather(gates.reshape(B, S * k), 1, order)
    sorted_tok = order // k                               # source token
    # place within the expert = rank - the expert's exclusive start
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(S * k, device=x.device)
    pos_in_e = rank[None, :] - torch.gather(starts, 1, sorted_e)
    keep = pos_in_e < C
    slot = sorted_e * C + torch.where(keep, pos_in_e, 0)  # [B, S*k]

    rows = torch.arange(B, device=x.device)[:, None]
    xs = torch.gather(x, 1, sorted_tok[..., None].expand(-1, -1, d))
    xs = xs * keep[..., None].to(x.dtype)
    # dropped assignments add zeros into their expert's first slot
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (rows * (E * C) + slot).reshape(-1),
                        xs.reshape(-1, d))
    buf = buf.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    out = _experts(p, buf).reshape(E, B, C, d).transpose(0, 1)
    out = out.reshape(B, E * C, d)

    gathered = torch.gather(out, 1, slot[..., None].expand(-1, -1, d))
    gathered = gathered * (sorted_g * keep)[..., None]
    y = torch.zeros((B * S, d), dtype=x.dtype, device=x.device)
    y = y.index_add(0, (rows * S + sorted_tok).reshape(-1),
                    gathered.reshape(-1, d)).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + p.shared(x)
    return y, aux


def moe_decode(cfg: ArchConfig, p, x):
    """x: [B, 1, d]: every expert on every token, combined through the
    dense gate mask.  Returns (y, aux)."""
    B, S, d = x.shape
    E = cfg.n_routed_experts
    gates, idx, aux = _router(cfg, p, x)                  # [B, 1, k]
    mask = torch.sum(F.one_hot(idx, E).to(x.dtype) * gates[..., None],
                     dim=-2)                              # [B, 1, E]
    xs = x.reshape(1, B * S, d).expand(E, -1, -1)
    per_e = _experts(p, xs)                               # [E, B*S, d]
    y = torch.einsum("end,ne->nd", per_e, mask.reshape(B * S, E))
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + p.shared(x)
    return y, aux
