"""The model on DTensor parameters: the few places where the transformer
meets a sharded tensor and must say what it wants.

Most of the model runs on DTensors as it is: DTensor's own rules shard the
products, norms, softmaxes and the embedding lookup, and insert the
collectives.  What needs help:

- a plain tensor meeting a DTensor (RoPE's angles, an attention mask, a
  zero accumulator) is replicated onto the DTensor's mesh
  (:func:`like`), never by ``implicit_replication``, whose flag is
  thread-local and not seen by the backward's recomputation on the card;
- ops with no DTensor rule run on local copies (:func:`on_rows`): the
  MoE's stable sort, capacity dispatch and ``index_add`` on the whole
  batch on every rank, the SSM scans on each rank's rows;
- the kernel wrappers read ``data_ptr()``, so they take local tensors: K3,
  K4 and K5 run on each rank's shard through :func:`on_shards`;
- a weight with FSDP shards is gathered over the batch axes when its
  sublayer runs (:class:`gathered`), as FSDP does: left to DTensor, a
  product may contract over a batch axis (an all-reduce of activations),
  and some such layouts fail in its view rules.

Nothing here runs when the module is imported.
"""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(x):
    """A DTensor redistributed to ``Replicate()`` on every mesh dim."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def like(ref, t):
    """``t`` (a plain tensor holding the same values on every rank) as a
    DTensor replicated over ``ref``'s mesh when ``ref`` is a DTensor; else
    ``t`` itself."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def settle(x):
    """A DTensor's pending sums (``Partial``) reduced, its shards kept: the
    residual stream between sublayers, so that the next products never
    choose to reduce-scatter it onto a dim the mesh does not divide (an
    uneven shard that DTensor's view rules refuse).  A plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(placements=pl)


def unshard_uneven(x, dim: int, n: int):
    """``x`` with ``dim`` gathered on every mesh dim that shards it but
    does not divide ``n`` (the count of the blocks the dim is about to be
    split into)."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard(dim) and n % x.device_mesh.size(i)
          else p for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(placements=pl)


def fsdp_gather(w):
    """A parameter with its FSDP shards (over the batch axes) gathered and
    its ``model`` shards kept: FSDP's gather on use, whose backward
    reduce-scatters the gradient back into the shards.  A plain tensor, or
    one with no FSDP shard, as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if n in BATCH_AXES and p.is_shard() else p
          for n, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(placements=pl)


class gathered:
    """``with gathered(module, x):`` the module's parameters FSDP-gathered
    (:func:`fsdp_gather`) for the body when its input ``x`` is a DTensor,
    so that every product inside takes a weight sharded over ``model``
    alone: a sublayer's weights are gathered when it runs, as FSDP does,
    and DTensor's rules never contract over a batch axis.  On plain
    tensors it does nothing."""

    def __init__(self, module, x):
        self.swap = None
        if is_dtensor(x):
            params = dict(module.named_parameters())
            new = {k: fsdp_gather(v) for k, v in params.items()}
            self.swap = _swapped(module, {k: v for k, v in new.items()
                                          if v is not params[k]})

    def __enter__(self):
        if self.swap is not None:
            self.swap.__enter__()

    def __exit__(self, *exc):
        if self.swap is not None:
            self.swap.__exit__(*exc)


class _swapped:
    """``module``'s parameters replaced by ``params`` (a dict by dotted
    name) for the ``with`` body, as ``functional_call`` does."""

    def __init__(self, module, params):
        self.module, self.params, self.saved = module, params, {}

    def __enter__(self):
        for name, value in self.params.items():
            owner, leaf = self._owner(name)
            self.saved[name] = owner._parameters[leaf]
            owner._parameters[leaf] = value

    def __exit__(self, *exc):
        for name, value in self.saved.items():
            owner, leaf = self._owner(name)
            owner._parameters[leaf] = value

    def _owner(self, name):
        *path, leaf = name.split(".")
        owner = self.module
        for p in path:
            owner = getattr(owner, p)
        return owner, leaf


BATCH_AXES = ("pod", "data")


def axis_size(mesh, axes) -> int:
    """The product of the sizes of those of ``axes`` the mesh has."""
    names = list(mesh.mesh_dim_names)
    size = 1
    for a in axes:
        if a in names:
            size *= mesh.size(names.index(a))
    return size


def layout(mesh, shape, dims: dict) -> list:
    """Placements that shard tensor dim d over the mesh axes ``dims[d]``
    (a tuple of names; those the mesh lacks are dropped) where their sizes
    divide ``shape[d]``; every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in dims.items():
        axes = [a for a in axes if a in names]
        if axes and shape[d] % axis_size(mesh, axes) == 0:
            for a in axes:
                out[names.index(a)] = Shard(d)
    return out


def on_shards(fn, args, layouts, out_layout):
    """``fn`` on each rank's local shards: each DTensor of ``args``
    redistributed to its placements in ``layouts`` (None: passed as it is,
    a plain tensor stays plain), ``fn(*local)`` run, its tensor result
    wrapped as a DTensor with ``out_layout`` on the same mesh.

    An input replicated over a mesh dim that shards the result is read
    differently by the ranks along it (each its own heads or rows), so
    its gradient is their sum: ``Partial`` there, not the ``Replicate``
    that ``to_local`` would assume."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    split = [p.is_shard() for p in out_layout]
    local = []
    for a, pl in zip(args, layouts):
        if is_dtensor(a):
            a = a.redistribute(mesh, pl) if pl is not None else a
            grads = [Partial() if s and isinstance(p, Replicate) else p
                     for p, s in zip(a.placements, split)]
            a = a.to_local(grad_placements=grads)
        local.append(a)
    out = fn(*local)
    return DTensor.from_local(out, mesh, out_layout, run_check=False)


def attention_layouts(mesh, B: int, H: int, Kv: int):
    """How K4 and K5 take a sharded attention: ``(q_layout, kv_layout,
    kv_heads)``.  q ``[B, S, H, hd]`` has its batch over the batch axes and
    its heads over ``model`` where they divide; k/v ``[B, S, Kv, hd]``
    their batch alike and their heads over ``model`` only where ``Kv``
    divides too (the spec's degrade), else replicated over it, and then
    ``kv_heads(t)`` cuts from the full local k/v the kv heads this rank's
    query heads read (``h // G``): ``H / m`` query heads and ``G = H /
    Kv`` must be multiples one of the other, or q is replicated over
    ``model`` as well."""
    from torch.distributed.tensor import Replicate
    names = list(mesh.mesh_dim_names)
    q = layout(mesh, (B, 0, H), {0: BATCH_AXES, 2: ("model",)})
    kv = layout(mesh, (B, 0, Kv), {0: BATCH_AXES, 2: ("model",)})
    if "model" not in names:
        return q, kv, None
    i = names.index("model")
    m, G = mesh.size(i), H // Kv
    if q[i] == kv[i]:
        return q, kv, None
    h_local = H // m
    if h_local % G and G % h_local:
        q[i] = Replicate()
        return q, kv, None
    first = mesh.get_local_rank("model") * h_local // G
    n = max(h_local // G, 1)
    return q, kv, lambda t: t[:, :, first:first + n].contiguous()


def shard_module(model, mesh, specs: dict):
    """Replace each parameter of ``model`` by a DTensor parameter laid out
    by its spec (``specs``: ``{dotted name: spec}``, ``param_specs``'s),
    in place: each rank keeps its shard of the tensor it holds.  On
    ``meta`` tensors nothing is allocated.  Returns ``model``."""
    from torch import nn

    from repro_torch.sharding.specs import placements
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model
        for q in path:
            owner = getattr(owner, q)
        owner.register_parameter(leaf, nn.Parameter(
            shard(mesh, p.detach(), placements(mesh, specs[name])),
            requires_grad=p.requires_grad))
    return model


def shard(mesh, t, pl):
    """``t`` (the same full tensor on every rank) as a DTensor with
    placements ``pl``: each rank keeps its own shard, no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def shard_tree(mesh, tree, spec_tree):
    """The tensors of a tree of dicts and lists (a cache) as DTensors laid
    out by the matching tree of specs (``cache_specs``'s)."""
    from repro_torch.sharding.specs import placements
    if isinstance(tree, list):
        return [shard_tree(mesh, t, s) for t, s in zip(tree, spec_tree)]
    if isinstance(tree, dict):
        return {k: shard_tree(mesh, t, spec_tree[k]) for k, t in tree.items()}
    return shard(mesh, tree, placements(mesh, spec_tree))


def on_rows(fn, module, *args, split=True):
    """``fn(module, *args)`` with full local copies of the module's
    parameters, on each rank's batch rows: every DTensor of ``args``
    (tensors, or dicts of them, batch leading) laid out with its rows over
    the batch axes, and every tensor ``fn`` returns (batch leading too)
    wrapped in that row layout.  For the SSM scans, whose rows never meet
    and whose per-step ops have no DTensor rule.  ``split=False`` gives
    every rank the whole batch, replicated out: for the MoE, whose stable
    sort, capacity dispatch and ``index_add`` have no DTensor rule and
    whose load-balance loss reads every row.  Ranks with other rows use
    the same parameters, so a parameter's gradient is their sum:
    ``Partial`` over the axes the rows are split on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils._pytree import tree_leaves, tree_map
    first = next(a for a in tree_leaves(args) if is_dtensor(a))
    mesh = first.device_mesh
    rows = layout(mesh, first.shape, {0: BATCH_AXES if split else ()})
    sums = [Partial() if p.is_shard() else Replicate() for p in rows]
    params = {k: (replicate(v).to_local(grad_placements=sums)
                  if is_dtensor(v) else v)
              for k, v in module.named_parameters()}

    def local(a):
        if not is_dtensor(a):
            return a
        pl = layout(mesh, a.shape, {0: BATCH_AXES if split else ()})
        return a.redistribute(placements=pl).to_local()
    with _swapped(module, params):
        out = fn(module, *tree_map(local, args))

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, rows, run_check=False)
    return tree_map(wrap, out)
