"""Building blocks of the transformer, the counterpart of
``repro.models.modules``.

Parameters keep ``repro``'s shapes (a weight is ``[in_dim, *out_shape]``),
so weights convert between the packages by a checked copy
(:mod:`repro_torch.convert`).  Norm statistics and RoPE angles are computed
in float32 whatever the parameter dtype.  ``layernorm`` normalises the SSM
stacks (``family == "ssm"``); ``chunked_scan`` runs the Mamba and RWKV
recurrences.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.dtensor import (BATCH_AXES, is_dtensor, layout,
                                          like, on_shards)


def dense_init(generator, in_dim, out_shape, dtype, scale=None,
               device=None):
    """Variance-scaled normal init of a weight ``[in_dim, *out_shape]``,
    drawn from ``generator`` on its own device and moved to ``device``."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    shape = (in_dim, *out_shape)
    if scale is None:
        scale = 1.0 / np.sqrt(in_dim)
    w = torch.randn(shape, generator=generator,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)


def embed_init(generator, vocab, dim, dtype, device=None):
    w = torch.randn((vocab, dim), generator=generator,
                    device=generator.device) * 0.02
    return w.to(device=device, dtype=dtype)


def rmsnorm(scale, x, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


def layernorm(scale, bias, x, eps):
    """Population variance (``jnp.var``), statistics in float32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """``scale`` (ones) and ``bias`` (zeros), ``repro``'s
    ``layernorm_init`` leaves."""

    def __init__(self, dim, eps, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device),
                                 requires_grad=False)

    def forward(self, x):
        return layernorm(self.scale, self.bias, x, self.eps)


def embed_lookup(table, tokens):
    """``table[tokens]``.  A DTensor table is gathered and each rank looks
    up its own batch rows (FSDP's gather on use; DTensor's rules for an
    indexed table differ between torch releases)."""
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate
        tokens = like(table, tokens)
        mesh = table.device_mesh
        rows = layout(mesh, tokens.shape, {0: BATCH_AXES})
        return on_shards(lambda t, tok: t[tok], (table, tokens),
                         ([Replicate()] * mesh.ndim, rows), rows)
    return table[tokens]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, freqs):
    """x: [..., S, H, hd] (hd even); positions: broadcastable to [..., S];
    ``freqs``: ``rope_freqs(hd, theta)`` as an f32 tensor on x's device
    (the caller keeps it there: a copy from the host would wait for the
    card).  Split-halves layout: the first hd/2 lanes rotate with the
    second."""
    angles = positions[..., None].float() * freqs      # [..., S, hd/2]
    cos = like(x, torch.cos(angles)[..., None, :])     # [..., S, 1, hd/2]
    sin = like(x, torch.sin(angles)[..., None, :])
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------
def _scan(body, carry, xs):
    """``lax.scan``: ``body(carry, x_t) -> (carry, y_t)`` over the leading
    axis of every tensor of the tuple ``xs``; returns (carry, the y_t
    stacked).  On ``meta`` tensors (the dry run: shapes, no values) two
    steps give every shape and reach every input (a decay acts on the
    outputs from the second step): the scans' steps are elementwise, with
    no product for the dry run to count, and stepping a long sequence
    through ``meta`` kernels would take hours."""
    length = xs[0].shape[0]
    if xs[0].device.type == "meta" and length > 2:
        carry, y0 = body(carry, tuple(a[0] for a in xs))
        carry, y1 = body(carry, tuple(a[1] for a in xs))
        rest = y1.unsqueeze(0).expand(length - 2, *y1.shape)
        return carry, torch.cat([y0[None], y1[None], rest])
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = body(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(body, carry, xs, chunk: int):
    """``repro``'s ``chunked_scan``: the scan in chunks of ``chunk`` steps,
    each chunk under a checkpoint that saves nothing but its inputs, so the
    backward keeps one carry per chunk and recomputes the chunk's steps
    (O(S / chunk + chunk) live states).  A length that ``chunk`` does not
    divide, or that is at most ``chunk``, runs as one plain scan.

    ``body`` must read no module attribute: a chunk's recomputation in the
    backward runs outside the ``functional_call`` that substituted the
    parameters, so every tensor it needs is bound into it (or in ``xs``)
    beforehand."""
    length = xs[0].shape[0]
    if length % chunk != 0 or length <= chunk or xs[0].device.type == "meta":
        return _scan(body, carry, xs)
    ys = []
    for start in range(0, length, chunk):
        carry, y = checkpoint(_scan, body, carry,
                              tuple(a[start:start + chunk] for a in xs),
                              use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def swiglu_mlp(w_gate, w_up, w_down, x):
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


class SwiGLU(nn.Module):
    """``w_gate``/``w_up`` ``[d, f]`` and ``w_down`` ``[f, d]``, as
    ``repro``'s ``swiglu_mlp_init`` shapes them."""

    def __init__(self, d_model, d_ff, dtype=torch.float32, device=None):
        super().__init__()

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.w_gate = empty(d_model, d_ff)
        self.w_up = empty(d_model, d_ff)
        self.w_down = empty(d_ff, d_model)

    def reset_parameters(self, generator):
        d, f = self.w_gate.shape
        for name, (i, o) in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d))):
            w = getattr(self, name)
            w.copy_(dense_init(generator, i, o, w.dtype, device=w.device))

    def forward(self, x):
        return swiglu_mlp(self.w_gate, self.w_up, self.w_down, x)
