"""The cloud tier of the multi-RSU corridor and the hierarchical multi-pod
MAFL of ``repro.core.hierarchical``.

``reconcile_models`` is the plain mean of N cohort param dicts and
``ema_toward`` one EMA step of a cohort toward a target; the serial
handover loop (``repro_torch.corridor.reference``) applies them every
``reconcile_every`` arrivals.

The mesh half maps the vehicular hierarchy onto ranks of a mesh
(``launch/mesh.py``): each pod is one RSU cohort that runs the paper's
asynchronous merge on its own (:func:`pod_local_mafl`, no traffic), and
:func:`cross_pod_reconcile` averages the cohorts over the ``"pod"`` axis,
the only traffic between pods.  Each rank holds its shard of every leaf;
where ``repro`` runs ``shard_map`` over the mesh, every rank here calls the
same function on its shard.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Sequence, Union

import numpy as np

from repro_torch.core.aggregation import mix_update
from repro_torch.launch.mesh import mesh_axis, pmean_tree

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


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


def pod_local_mafl(global_params, local_params, beta: float,
                   weight: float):
    """Eq. 10+11 on one pod's cohort, the mixing reading of
    ``aggregation.mafl_update``: ``alpha = clip((1 - beta) * weight, 0,
    1)`` in Python f64, then ``(1 - alpha) g + alpha l`` in f32 per leaf.
    ``weight`` is a number (a 0-d tensor is read to the host).  New
    tensors."""
    alpha = float(np.clip((1.0 - beta) * float(weight), 0.0, 1.0))
    return mix_update(global_params, local_params, alpha)


def cross_pod_reconcile(params: dict, mesh: DeviceMesh,
                        pod_axis: str = "pod",
                        shard_spec: Union[str, Sequence[str], None] = None,
                        tau: float = 1.0, use_kernel: bool = False):
    """Reconcile the per-pod cohort models over the pod axis: one pmean
    of every leaf over ``pod_axis`` (an f32 sum of all leaves in one
    ``all_reduce``, ``/ pods``), then

    - ``tau = 1`` (FedAvg): every pod adopts the mean;
    - ``tau < 1`` (EMA): each pod moves ``tau`` toward it
      (:func:`ema_toward`; K2 on the card under ``use_kernel``).

    ``params`` is this rank's shard of each leaf.  ``shard_spec`` names the
    mesh axes the leaves' leading dim is split over, major first (default
    ``(pod_axis, "data")``, the FSDP layout ``repro``'s launcher uses; a
    single name for one axis); the ranks that share every coordinate but
    the pod's hold corresponding shards, and those are averaged.  Returns
    new tensors."""
    spec = ((pod_axis, "data") if shard_spec is None
            else (shard_spec,) if isinstance(shard_spec, str)
            else tuple(shard_spec))
    names = tuple(mesh.mesh_dim_names or ())
    unknown = [a for a in spec if a not in names]
    if unknown:
        raise ValueError(f"shard_spec {spec} names axes {unknown} the mesh "
                         f"{names} does not have")
    pod = mesh_axis(mesh, pod_axis)
    if pod is None:
        raise ValueError(f"the mesh {names} has no {pod_axis!r} axis")
    mean = pmean_tree(params, pod)
    if tau == 1.0:
        return mean
    return ema_toward(params, mean, tau, use_kernel=use_kernel)


def make_hierarchical_round(mesh, beta: float, pod_axis: str = "pod",
                            reconcile_every: int = 4):
    """Returns ``round_fn(step, cohort_models, upload, weight)``: the
    pod-local MAFL update every call, then the cross-pod reconcile (FedAvg,
    the default ``shard_spec``) on every ``reconcile_every``-th step.
    ``step`` is a host integer: ``repro``'s ``lax.cond`` on a traced step
    is a branch here, taken alike on every rank."""

    def round_fn(step, cohort_models, upload, weight):
        updated = pod_local_mafl(cohort_models, upload, beta, weight)
        if int(step) % reconcile_every == reconcile_every - 1:
            return cross_pod_reconcile(updated, mesh, pod_axis)
        return updated

    return round_fn
