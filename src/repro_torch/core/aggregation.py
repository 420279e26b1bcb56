"""Global-model aggregation rules on param dicts.

``mafl_update`` is the paper's Eq. (10)+(11) fused:
    w_r = beta * w_{r-1} + (1 - beta) * (beta_u * beta_l) * w_local
``afl_update`` is the conventional-AFL baseline the paper compares against
(Eq. (11) with unweighted local model).  FedAvg / FedAsync / FedBuff are
standard baselines included beyond the paper.

Every rule returns new tensors and never writes its inputs: pending upload
events hold the global model they downloaded (DESIGN.md §2), so the global
tensors must stay as they were until those events fire.  Scalars are
rounded to f32 exactly where ``repro.core.aggregation`` rounds them, and
the tensor arithmetic runs in f32 in the same order.  ``use_kernel=True``
routes the mafl merge through the hand-written CUDA kernel
(``repro_torch.kernels.weighted_agg``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _ema(global_params, contrib, beta: float):
    """beta*g + (1-beta)*c in f32."""
    b = np.float32(beta)
    bf, cf = float(b), float(np.float32(1.0) - b)
    return {k: (g.float() * bf + contrib[k].float() * cf).to(g.dtype)
            for k, g in global_params.items()}


def mix_update(global_params, local_params, alpha: float):
    """w_r = (1-alpha) w_g + alpha w_l, alpha rounded to f32 first."""
    a = np.float32(alpha)
    af, gf = float(a), float(np.float32(1.0) - a)
    return {k: (g.float() * gf + local_params[k].float() * af).to(g.dtype)
            for k, g in global_params.items()}


def literal_update(global_params, local_params, beta: float, weight: float):
    """Eq. (10)+(11) exactly as printed: beta*g + ((1-beta)*weight)*l."""
    b = np.float32(beta)
    coef = float((np.float32(1.0) - b) * np.float32(weight))
    bf = float(b)
    return {k: (g.float() * bf + local_params[k].float() * coef).to(g.dtype)
            for k, g in global_params.items()}


def mafl_update(global_params, local_params, beta: float, weight: float,
                use_kernel: bool = False, interpretation: str = "mixing"):
    """The paper's Eq. (10)+(11).

    ``interpretation="literal"`` applies the equations exactly as printed:
        w_r = beta*w_g + (1-beta) * (beta_u*beta_l) * w_local
    ``interpretation="mixing"`` (default) reads the weight as the local
    model's aggregation proportion:
        alpha = clip((1-beta) * beta_u * beta_l, 0, 1)   (Python f64)
        w_r   = (1-alpha)*w_g + alpha*w_local
    The kernel takes ``(beta, weight)`` under "literal" and
    ``(1 - alpha, 1.0)`` under "mixing" (DESIGN.md §1)."""
    if interpretation == "literal":
        if use_kernel:
            from repro_torch.kernels.weighted_agg import ops as agg_ops
            return agg_ops.weighted_agg_tree(global_params, local_params,
                                             beta, weight)
        return literal_update(global_params, local_params, beta, weight)
    alpha = float(np.clip((1.0 - beta) * weight, 0.0, 1.0))
    if use_kernel:
        from repro_torch.kernels.weighted_agg import ops as agg_ops
        return agg_ops.weighted_agg_tree(global_params, local_params,
                                         1.0 - alpha, 1.0)
    return _ema(global_params, local_params, 1.0 - alpha)


def chain_coeffs(scheme: str, interpretation: str, beta, weight,
                 t=None, dl_t=None, fedasync_mix=None):
    """Per-upload ``(c, d)`` f32 mix pairs for a chain of aggregations:
    ``g <- c*g + d*l`` (the form ``ring_agg`` streams, DESIGN.md §12).

    ``weight`` (and, for fedasync, ``t`` / ``dl_t``) are f32 tensors of a
    segment's trace columns on the device; the pairs come back as two
    tensors beside them.  The f32 expressions and their order are those of
    ``repro.core.aggregation.chain_coeffs``, with ``beta`` rounded to f32
    first: ``1 - f32(beta)`` etc.  The sweep tier passes a ``beta`` that
    varies across its worlds as an f32 ``[W, 1]`` column beside ``[W, n]``
    columns: the same f32 values and roundings, world by world."""
    if isinstance(beta, torch.Tensor):
        b, one_minus_b = beta, 1.0 - beta
    else:
        b = np.float32(beta)
        one_minus_b = float(np.float32(1.0) - b)
    weight = weight.float()
    if scheme == "mafl" and interpretation == "literal":
        c = (b.expand_as(weight) if isinstance(b, torch.Tensor)
             else torch.full_like(weight, float(b)))
        return c, weight * one_minus_b
    if scheme == "mafl":
        alpha = torch.clamp(weight * one_minus_b, 0.0, 1.0)
    elif scheme == "afl":
        alpha = (one_minus_b.expand_as(weight)
                 if isinstance(one_minus_b, torch.Tensor)
                 else torch.full_like(weight, one_minus_b))
    elif scheme == "fedasync":
        stale = torch.clamp_min(t.float() - dl_t.float(), 0.0)
        alpha = torch.pow(stale + 1.0, -0.5) * float(np.float32(fedasync_mix))
    else:
        raise ValueError(f"no chain coefficients for scheme {scheme!r}")
    return 1.0 - alpha, alpha


def arrival_mix(g, loc, weight, *, scheme: str, interpretation: str, beta,
                t=None, dl_t=None, fedasync_mix=None,
                use_kernel: bool = False, keep=None):
    """One arrival's merge on device values: the device engines' pytree
    programs (``engine="jit"`` and the corridor with ``flat=False``), the
    counterpart of ``repro``'s per-arrival ``aggregate`` closures, one
    definition for both engines.

    ``g`` and ``loc`` are param dicts of equal shapes on one device;
    ``weight`` (the delay weight of Eqs. 7, 9 as the slot queue's pop
    computes it, 1 outside mafl) and, for fedasync, the pop time ``t`` and
    download time ``dl_t`` are one-element f32 device tensors.  The mix is
    :func:`chain_coeffs`'s ``(c, d)`` pair (mafl mixing: ``alpha =
    clip((1-beta) w, 0, 1)``; literal: ``(beta, (1-beta) w)``; afl:
    ``alpha = 1-beta``; fedasync: ``alpha = mix (stale+1)^-0.5``) applied
    per leaf as ``c*g + d*l`` in f32, each product and the sum rounded
    alone: bitwise the flat program's ``ring_agg`` step.  Under
    ``use_kernel`` the merge is K2's device form, ``(beta, w)`` (literal)
    or ``(1-alpha, 1)``, as ``repro`` calls its kernel.  ``keep`` (a 0-d
    bool device tensor, the staleness cap's verdict) keeps ``g`` exactly
    where it is False.  Returns a new param dict; nothing is read on the
    host and no input is written."""
    cc, dd = chain_coeffs(scheme, interpretation, beta, weight, t=t,
                          dl_t=dl_t, fedasync_mix=fedasync_mix)
    if use_kernel:
        from repro_torch.kernels.weighted_agg import ops as agg_ops
        if scheme == "mafl" and interpretation == "literal":
            new = agg_ops.weighted_agg_tree(g, loc, beta, weight)
        else:
            new = agg_ops.weighted_agg_tree(g, loc, cc, 1.0)
    else:
        new = {k: (x.float() * cc + loc[k].float() * dd).to(x.dtype)
               for k, x in g.items()}
    if keep is not None:
        new = {k: torch.where(keep, v, g[k]) for k, v in new.items()}
    return new


def afl_update(global_params, local_params, beta: float):
    """Conventional AFL (the paper's baseline): Eq. (11), unweighted."""
    return _ema(global_params, local_params, beta)


def fedavg_update(global_params, local_list: Sequence, sizes: Sequence[int]):
    """Synchronous FedAvg: data-size-weighted mean of all K locals."""
    total = float(sum(sizes))
    ws = [float(np.float32(s / total)) for s in sizes]
    out = {}
    for k in global_params:
        acc = torch.zeros_like(local_list[0][k], dtype=torch.float32)
        for w, local in zip(ws, local_list):
            acc = acc + local[k].float() * w
        out[k] = acc.to(local_list[0][k].dtype)
    return out


def fedasync_update(global_params, local_params, base_mix: float,
                    staleness: float, a: float = 0.5):
    """FedAsync (Xie et al. 2019): polynomial staleness discount
    alpha = base_mix * (staleness + 1)^-a, w_r = (1-alpha) w_g + alpha w_l."""
    alpha = base_mix * (staleness + 1.0) ** (-a)
    return _ema(global_params, local_params, 1.0 - alpha)


class FedBuffAggregator:
    """FedBuff (Nguyen et al. 2022): buffer deltas, aggregate every Kb."""

    def __init__(self, buffer_size: int = 3, lr: float = 1.0):
        self.buffer_size = buffer_size
        self.lr = lr
        self._buf = []

    def add(self, global_params, local_params):
        self._buf.append({k: local_params[k].float() - g.float()
                          for k, g in global_params.items()})
        if len(self._buf) < self.buffer_size:
            return global_params, False
        n = len(self._buf)
        md = {k: sum(d[k] for d in self._buf) / n for k in global_params}
        self._buf = []
        new = {k: (g.float() + self.lr * md[k]).to(g.dtype)
               for k, g in global_params.items()}
        return new, True
