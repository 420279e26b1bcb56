"""The cloud tier of the multi-RSU corridor: the host-level cohort
reconcile of ``repro.core.hierarchical``.

``reconcile_models`` is the plain mean of N cohort param dicts and
``ema_toward`` one EMA step of a cohort toward a target; the serial
handover loop (``repro_torch.corridor.reference``) applies them every
``reconcile_every`` arrivals.  ``repro``'s ``shard_map`` versions
(``pod_local_mafl``, ``cross_pod_reconcile``, ``make_hierarchical_round``)
arrive with the port's distribution slice (ROADMAP queue 1, item 13).
"""
from __future__ import annotations


def ema_toward(params, target, tau: float, use_kernel: bool = False):
    """One EMA step of every leaf toward ``target``:
    ``(1 - tau) * params + tau * target`` in f32, cast back to each leaf's
    dtype.  ``tau = 1`` adopts the target (FedAvg consensus); ``tau < 1``
    keeps each cohort's identity between reconciles.  ``use_kernel``
    routes the mix through ``weighted_agg_tree`` (beta = 1 - tau,
    weight = 1): one kernel launch per merge on the card.  New tensors;
    the inputs are never written."""
    if use_kernel:
        from repro_torch.kernels.weighted_agg import ops as agg_ops
        return agg_ops.weighted_agg_tree(params, target, 1.0 - tau, 1.0)
    # Python scalars, as repro's weak-typed f64 ones: rounded to f32 once
    keep, take = 1.0 - tau, tau
    return {k: (g.float() * keep + target[k].float() * take).to(g.dtype)
            for k, g in params.items()}


def reconcile_models(models):
    """Plain mean of N cohort param dicts: per leaf, a sequential f32 sum
    over the cohorts in order, then ``/ n``, cast back to the leaf dtype
    (``repro``'s order).  EMA callers apply :func:`ema_toward` on top."""
    n = len(models)
    return {k: (sum(m[k].float() for m in models) / n).to(v.dtype)
            for k, v in models[0].items()}
