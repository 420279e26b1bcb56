"""Plain PyTorch versions of the fused aggregations (Eqs. 10-11).

The CPU paths of :mod:`repro_torch.kernels.weighted_agg.ops`, and what the
tests and ``chip_smoke.py`` hold the CUDA kernels against.  They repeat the
kernels' arithmetic step for step; they are no yardstick of speed.
"""
from __future__ import annotations

import numpy as np
import torch


def agg_scalars(beta, weight):
    """``(beta, (1 - beta) * weight)`` rounded to f32 in the order the JAX
    kernel rounds them: ``f32(beta)``, then ``1 - beta`` in f32, then the
    product with ``f32(weight)`` in f32.  From Python floats: Python floats
    (each exactly an f32 value).  Where either is an f32 tensor of one
    element (the device form's scalars): 0-d f32 tensors on its device,
    the same values for equal inputs, computed without a host read."""
    if isinstance(beta, torch.Tensor) or isinstance(weight, torch.Tensor):
        b, w = (x.reshape(()) if isinstance(x, torch.Tensor)
                else float(np.float32(x)) for x in (beta, weight))
        if not isinstance(b, torch.Tensor):
            b = torch.full((), b, dtype=torch.float32, device=w.device)
        return b, (1.0 - b) * w
    b = np.float32(beta)
    coef = (np.float32(1.0) - b) * np.float32(weight)
    return float(b), float(coef)


def weighted_agg(g, l, beta, weight):
    """out = beta*g + ((1-beta)*weight)*l, computed in f32, cast back to
    ``g``'s dtype.  Eager: two multiplies and an add, each rounded.
    ``beta`` and ``weight`` are Python floats or one-element f32 tensors
    (:func:`agg_scalars`)."""
    b, coef = agg_scalars(beta, weight)
    return (g.float() * b + l.float() * coef).to(g.dtype)


def ring_agg(g, locs, coeffs):
    """The fused multi-upload chain: ``g`` ``[P]``, ``locs`` ``[U, P]``
    (f32 or bf16), ``coeffs`` ``f32[U, 2]`` of per-upload ``(c, d)``
    pairs, or the same with a leading world axis (``[W, P]``, ``[W, U,
    P]``, ``[W, U, 2]``).  Applies the U mixes in order,

        acc <- c_u * acc + d_u * locs[u]        (f32)

    from ``acc = g``, and returns ``acc`` as a new f32 tensor.  Eager: each
    multiply and the add round on their own (no FMA), so on the card this
    is bitwise the CUDA kernel.  Over a world axis every element sees the
    same three roundings as in its own world's chain, so world ``w`` is
    bitwise ``ring_agg(g[w], locs[w], coeffs[w])``."""
    acc = g.to(torch.float32, copy=True)
    for u in range(locs.shape[-2]):
        acc = (coeffs[..., u, 0, None] * acc
               + coeffs[..., u, 1, None] * locs[..., u, :].float())
    return acc
