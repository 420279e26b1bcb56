"""Per-arch sharding rules, the counterpart of ``repro.sharding.specs``.

Strategy (``repro``'s DESIGN.md §5):
  * TP   - contraction/head/expert dims sharded on the ``model`` axis;
  * FSDP - additionally shard the d_model-ish dim over (``pod``,) ``data``
           when the unsharded per-device parameter bytes would pass
           ``_FSDP_THRESHOLD_BYTES`` (``needs_fsdp``): the model gathers
           those shards on use and reduce-scatters the gradients into them;
  * every rule checks divisibility against the mesh's axis sizes and
    degrades to replication for that dim, so the same rules drive every
    arch on every mesh.

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (``PartitionSpec``'s
meaning).  Rules are keyed on the port's dotted parameter names
(``stack.<i>.sub0.mixer.wq``, ``prefix.<i>.mlp.w_gate``): a
``stack.<i>.`` leaf takes the rule of ``repro``'s ``stack`` leaf without
its leading period axis (``convert._jax_shapes`` maps the two namings).
Shapes come from a model or cache built on the ``meta`` device: nothing is
allocated.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` or, where no process
group is wanted, a ``{axis name: size}`` dict in mesh order (the
counterpart of ``jax.sharding.AbstractMesh``).  ``spec_tree_to_shardings``
turns specs into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

# param-bytes-per-device (bf16, model-axis TP only) above which FSDP turns on
_FSDP_THRESHOLD_BYTES = 2 << 30

_NORMS = ("scale", "bias", "mu", "w0", "u", "ln_scale", "dt_bias", "D",
          "conv_b")


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of such a
    dict itself."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@functools.lru_cache(maxsize=32)
def _param_shapes(cfg: ArchConfig) -> tuple:
    """(dotted name, shape) of every parameter of ``Transformer(cfg)``,
    from a model on ``meta``."""
    return tuple((name, tuple(p.shape)) for name, p in
                 T.Transformer(cfg, torch.bfloat16, "meta").named_parameters())


def needs_fsdp(cfg: ArchConfig, model_par: int = 16) -> bool:
    total = sum(math.prod(s) for _, s in _param_shapes(cfg))
    return total * 2 / model_par > _FSDP_THRESHOLD_BYTES


def data_axes(mesh) -> tuple[str, ...]:
    """The batch axes of a mesh: ``pod`` then ``data``, those it has."""
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalises it: a one-axis tuple is
    the axis name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(sizes[a] for a in axes)


def _ok(dim: int, sizes: dict, axes) -> bool:
    return axes is not None and dim % _size(sizes, axes) == 0


def _leaf_spec(sizes, fsdp_axes, names, shape) -> tuple:
    """The rule table (``repro``'s ``_leaf_spec``).  ``shape`` excludes any
    leading period axis."""
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    model = "model"
    dp = fsdp_axes if fsdp_axes else None

    def pick(*dims):
        """One proposed axis assignment per tensor dim, each degraded to
        None unless divisible."""
        return tuple(_entry(a) if _ok(shape[i], sizes, a) else None
                     for i, a in enumerate(dims))

    # ---- embeddings / head ------------------------------------------------
    if name == "table":
        return pick(model, dp)
    if parent == "lm_head":
        return pick(dp, model)
    # ---- norms / scalars --------------------------------------------------
    if name in _NORMS:
        return (None,) * len(shape)
    # ---- MoE ---------------------------------------------------------------
    if name == "router":
        return pick(dp, None)
    if parent != "mixer" and name in ("w_gate", "w_up") and len(shape) == 3:
        return pick(model, dp, None)            # [E, d, f] expert-parallel
    if name == "w_down" and len(shape) == 3:
        return pick(model, None, dp)            # [E, f, d]
    # ---- dense MLP ----------------------------------------------------------
    if name in ("w_gate", "w_up"):
        return pick(dp, model)                  # [d, f]
    if name == "w_down":
        return pick(model, dp)                  # [f, d]
    # ---- attention ----------------------------------------------------------
    if name == "wq" and len(shape) == 3:
        return pick(dp, model, None)            # [d, H, hd]
    if name in ("wk", "wv") and len(shape) == 3:
        return pick(dp, model, None)            # [d, Kv, hd]
    if name == "wo" and len(shape) == 3:
        return pick(model, None, dp)            # [H, hd, d]
    if name in ("bq", "bk", "bv"):
        return pick(model, None)
    # ---- MLA ----------------------------------------------------------------
    if name == "w_dkv":
        return pick(dp, model)                  # [d, lora]
    if name == "w_krope":
        return pick(dp, None)
    if name in ("w_uk", "w_uv"):
        return pick(None, model, None)          # [lora, H, *]
    # ---- mamba --------------------------------------------------------------
    if name == "in_proj":
        return pick(dp, model)                  # [d, 2di]
    if name == "conv_w":
        return pick(None, model)                # [dc, di]
    if name == "x_proj":
        return pick(model, None)                # [di, r]
    if name == "dt_proj":
        return pick(None, model)                # [r, di]
    if name == "A_log":
        return pick(model, None)                # [di, ds]
    if name == "out_proj":
        return pick(model, dp)                  # [di, d]
    # ---- rwkv ---------------------------------------------------------------
    if name in ("wr", "wk", "wv", "wg", "wo"):
        return pick(dp, model)                  # [d, d] / [d, ff]
    if name == "wA":
        return pick(dp, None)
    if name == "wB":
        return pick(None, model)
    return (None,) * len(shape)                 # default: replicate


def param_specs(cfg: ArchConfig, mesh, fsdp: bool | None = None) -> dict:
    """``{dotted parameter name: spec}`` for ``Transformer(cfg)``."""
    sizes = mesh_sizes(mesh)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, sizes.get("model", 1))
    fsdp_axes = data_axes(sizes) if fsdp else ()
    out = {}
    for name, shape in _param_shapes(cfg):
        names = name.split(".")
        if names[0] == "stack":                 # repro's leading period axis
            names = names[:1] + names[2:]
        out[name] = _leaf_spec(sizes, fsdp_axes, names, shape)
    return out


def _cache_leaf_spec(sizes, dp, name, shape) -> tuple:
    """``repro``'s ``cache_specs`` rule for one leaf (without the period
    axis): batch over the data axes, the long sequence axis of attention
    and MLA caches over ``model``, an SSM state's channel dim over
    ``model``."""
    def on_model(dim):
        return "model" if _ok(shape[dim], sizes, "model") else None
    if name in ("k", "v"):                      # [B, S|W|C, Kv, hd]
        return (dp, on_model(1), None, None)
    if name in ("c_kv", "k_rope"):              # [B, S, lora|rope]
        return (dp, on_model(1), None)
    if name == "conv":                          # [B, dc-1, di]
        return (dp, None, on_model(2))
    if name == "ssm":                           # [B, di, ds]
        return (dp, on_model(1), None)
    if name == "wkv":                           # [B, H, N, N]
        return (dp, on_model(1), None, None)
    if name == "shift":                         # [B, d]
        return (dp, on_model(1))
    return (None,) * len(shape)


def cache_specs(cfg: ArchConfig, mesh, batch: int, max_seq: int) -> dict:
    """Specs shaped like ``T.init_cache(cfg, batch, max_seq)``."""
    sizes = mesh_sizes(mesh)
    axes = data_axes(sizes)
    dp = _entry(axes) if _ok(batch, sizes, axes) else None
    shapes = T.init_cache(cfg, batch, max_seq, torch.bfloat16, "meta")

    def tree(node, lead):
        if isinstance(node, list):
            return [tree(x, lead) for x in node]
        return {k: (tree(v, lead) if isinstance(v, (dict, list)) else
                    (None,) * lead + _cache_leaf_spec(
                        sizes, dp, k, tuple(v.shape[lead:])))
                for k, v in node.items()}
    out = {"stack": tree(shapes["stack"], 1)}
    if "prefix" in shapes:
        out["prefix"] = tree(shapes["prefix"], 0)
    return out


def batch_spec(mesh, global_batch: int) -> tuple:
    """Token batches shard over (pod, data) when divisible."""
    sizes = mesh_sizes(mesh)
    axes = data_axes(sizes)
    if axes and global_batch % _size(sizes, axes) == 0:
        return (_entry(axes),)
    # degrade: drop 'pod' first, then replicate
    if "data" in sizes and global_batch % sizes["data"] == 0:
        return ("data",)
    return (None,)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of one spec on ``mesh``: ``Shard(d)`` on each mesh
    dim whose axis names tensor dim d, ``Replicate()`` elsewhere.  A dim
    over several axes is split in mesh-dim order, which is JAX's
    major-to-minor order only when the spec lists them in mesh order:
    anything else raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {d} is split over {axes}, not in the "
                f"mesh's order {tuple(names)}; DTensor would tile it in "
                "another order than JAX")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def spec_tree_to_shardings(mesh, spec_tree):
    """The placements of every spec of a tree of dicts and lists
    (:func:`placements`)."""
    if isinstance(spec_tree, tuple):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, list):
        return [spec_tree_to_shardings(mesh, s) for s in spec_tree]
    return {k: spec_tree_to_shardings(mesh, s) for k, s in spec_tree.items()}
