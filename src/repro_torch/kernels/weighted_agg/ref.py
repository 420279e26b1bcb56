"""Plain PyTorch version of the fused aggregation (Eqs. 10-11).

The CPU path of :func:`repro_torch.kernels.weighted_agg.ops.weighted_agg`,
and what the tests and ``chip_smoke.py`` hold the CUDA kernel against.  It
repeats the kernel's arithmetic step for step; it is no yardstick of speed.
"""
from __future__ import annotations

import numpy as np


def agg_scalars(beta: float, weight: float) -> tuple[float, float]:
    """``(beta, (1 - beta) * weight)`` rounded to f32 in the order the JAX
    kernel rounds them: ``f32(beta)``, then ``1 - beta`` in f32, then the
    product with ``f32(weight)`` in f32.  Returned as Python floats (each
    exactly an f32 value)."""
    b = np.float32(beta)
    coef = (np.float32(1.0) - b) * np.float32(weight)
    return float(b), float(coef)


def weighted_agg(g, l, beta: float, weight: float):
    """out = beta*g + ((1-beta)*weight)*l, computed in f32, cast back to
    ``g``'s dtype.  Eager: two multiplies and an add, each rounded."""
    b, coef = agg_scalars(beta, weight)
    return (g.float() * b + l.float() * coef).to(g.dtype)
