"""Move weights between the JAX package's layout and the port's.

CNN: both packages keep the same leaf names and element order (HWIO
kernels, (h, w, c)-ordered ``fc1_w`` rows), so conversion is a checked
copy.  This is how the tests and ``chip_smoke.py`` give both packages the
same weights: ``run_simulation(init_params=params_from_jax(tree, device))``.

Transformer: ``repro``'s pytree carries a leading period axis on every
``stack`` leaf; the port's ``Transformer`` holds one block per period.  A
leaf ``stack.sub0.mixer.wq [n_periods, d, H, hd]`` is the port's
``stack.<i>.sub0.mixer.wq`` for i < n_periods (the QKV biases
``mixer.bq``/``bk``/``bv`` too, where the config has them); every other
leaf (the untied ``lm_head.w`` among them) keeps its name and shape;
``repro``'s ``prefix`` list of ``first_k_dense`` sublayers is the port's
``prefix`` ``ModuleList`` (``prefix.<i>.mlp.w_gate``).  MoE leaves
(``mlp.router``, float32 in every model, ``mlp.w_gate [E, d, f]``,
``mlp.shared.*``) and MLA leaves (``mixer.w_dkv``, ``mixer.kv_norm.scale``,
...) keep ``repro``'s names and shapes.  A
checkpoint of a transformer (either package's) holds
that nested tree: ``checkpointing.load_checkpoint(path,
transformer_params_to_numpy(model))`` then ``transformer_params_from_jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN_SHAPES
from repro_torch.models.transformer import Transformer


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


def _flatten(tree, prefix="") -> dict:
    """Dotted leaf names of a tree of dicts and lists (a list's items by
    index, as ``repro``'s ``prefix`` list of sublayers)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_shapes(model: Transformer, n_periods: int) -> dict:
    """``repro``'s flat leaf names -> shapes, from the port's model."""
    shapes = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "stack":
            if parts[1] == "0":
                shapes[".".join(["stack", *parts[2:]])] = (n_periods,
                                                           *p.shape)
        else:
            shapes[name] = tuple(p.shape)
    return shapes


def transformer_params_from_jax(tree: dict, cfg, device) -> Transformer:
    """The numpy (or array-like) leaves of ``repro``'s ``T.init_params``
    pytree -> a ``Transformer`` on ``device`` holding copies of them.
    Raises on a missing or extra leaf, a wrong shape or a dtype other than
    float32."""
    device = resolve_device(device)
    model = Transformer(cfg, torch.float32, device)
    want = _jax_shapes(model, cfg.n_periods)
    leaves = _flatten(tree)
    if set(leaves) != set(want):
        raise ValueError(
            f"transformer params: missing {sorted(set(want) - set(leaves))}, "
            f"extra {sorted(set(leaves) - set(want))}")
    arrays = {}
    for name, shape in want.items():
        leaf = np.asarray(leaves[name])
        if leaf.shape != shape or leaf.dtype != np.float32:
            raise ValueError(
                f"{name}: expected float32{list(shape)}, got "
                f"{leaf.dtype}{list(leaf.shape)}")
        arrays[name] = leaf
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "stack":
            src = arrays[".".join(["stack", *parts[2:]])][int(parts[1])]
        else:
            src = arrays[name]
        p.copy_(torch.from_numpy(np.array(src)))
    return model


def transformer_params_to_numpy(params) -> dict:
    """A ``Transformer``, or its ``{name: tensor}`` param dict (training's
    form, any device) -> numpy leaves nested as ``repro``'s pytree, with the
    period axis leading on ``stack``."""
    if isinstance(params, Transformer):
        params = dict(params.named_parameters())
    flat, stacked = {}, {}
    for name, p in params.items():
        parts = name.split(".")
        value = p.detach().cpu().numpy()
        if parts[0] == "stack":
            stacked.setdefault(".".join(["stack", *parts[2:]]), {})[
                int(parts[1])] = value
        else:
            flat[name] = value
    flat.update({k: np.stack([v[i] for i in sorted(v)])
                 for k, v in stacked.items()})
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    if "prefix" in tree:         # repro's first_k_dense layers: a list
        tree["prefix"] = [tree["prefix"][i]
                          for i in sorted(tree["prefix"], key=int)]
    return tree
