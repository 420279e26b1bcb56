"""Move CNN weights between the JAX package's layout and the port's.

Both packages keep the same leaf names and element order (HWIO kernels,
(h, w, c)-ordered ``fc1_w`` rows), so conversion is a checked copy.  This is
how the tests and ``chip_smoke.py`` give both packages the same weights:
``run_simulation(init_params=params_from_jax(tree, device))``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN_SHAPES


def params_from_jax(tree: dict, device) -> dict[str, torch.Tensor]:
    """numpy (or array-like) leaves in ``repro``'s layout -> f32 tensors
    on ``device``.  Raises on a missing or extra leaf, a wrong shape or a
    dtype other than float32."""
    if set(tree) != set(CNN_SHAPES):
        raise ValueError(
            f"CNN params must have leaves {sorted(CNN_SHAPES)}, "
            f"got {sorted(tree)}")
    device = resolve_device(device)
    out = {}
    for name, shape in CNN_SHAPES.items():
        leaf = np.asarray(tree[name])
        if leaf.shape != shape or leaf.dtype != np.float32:
            raise ValueError(
                f"{name}: expected float32{list(shape)}, got "
                f"{leaf.dtype}{list(leaf.shape)}")
        out[name] = torch.from_numpy(leaf.copy()).to(device)
    return out


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """Param tensors (any device) -> numpy leaves in ``repro``'s layout."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
