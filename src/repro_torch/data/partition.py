"""Per-vehicle data partitioning (Section V-A): vehicle i carries
D_i = 2250 + 3750*i images "randomly selected" from the training pool.
Optionally a Dirichlet non-IID split (beyond paper) for heterogeneity studies.
"""
from __future__ import annotations

import numpy as np

from repro_torch.channel.params import ChannelParams
from repro_torch.core.client import VehicleData


def partition_vehicles(images: np.ndarray, labels: np.ndarray,
                       params: ChannelParams, seed: int = 0,
                       scale: float = 1.0,
                       dirichlet_alpha: float | None = None,
                       max_per_vehicle: int | None = None
                       ) -> list[VehicleData]:
    """``scale`` shrinks every D_i proportionally (CPU-budget knob; relative
    data imbalance between vehicles — the thing the paper's Eq. 8 feeds on —
    is preserved exactly).  ``max_per_vehicle`` caps each shard's *storage*
    for K=100+ fleets (delays still use the uncapped Table-I D_i)."""
    rng = np.random.default_rng(seed)
    out = []
    for i1 in range(1, params.K + 1):
        d_i = max(int(params.data_count(i1) * scale), 8)
        if max_per_vehicle is not None:
            d_i = min(d_i, max_per_vehicle)
        if dirichlet_alpha is None:
            sel = rng.choice(len(labels), size=min(d_i, len(labels)),
                             replace=False)
        else:
            # class-skewed shard: sample class mix ~ Dirichlet(alpha)
            probs = rng.dirichlet([dirichlet_alpha] * 10)
            weights = probs[labels]
            weights = weights / weights.sum()
            sel = rng.choice(len(labels), size=min(d_i, len(labels)),
                             replace=False, p=weights)
        out.append(VehicleData(index=i1, images=images[sel],
                               labels=labels[sel]))
    return out
