"""Packed flat-parameter representation (repro's DESIGN.md §12).

Every model state of the device fleet engine is one lane-aligned
contiguous ``f32[P]`` buffer: the snapshot ring holds ``[P]`` rows, the
upload buffer is one ``[M, P]`` tensor, and a whole chain of
staleness-weighted mixes streams through one kernel
(:func:`repro_torch.kernels.weighted_agg.ops.ring_agg`).

:class:`ParamLayout` is static host data derived once from a template
param dict: per-leaf offsets (each aligned to 128 elements, so every row
of a ``[M, P]`` buffer starts 16-byte aligned), shapes, template dtypes and
the padded total ``P``.  Leaves are ordered by sorted key, as jax flattens
a dict, so names, offsets, ``P`` and :meth:`ParamLayout.to_json` equal
``repro.core.flat.ParamLayout``'s and a layout written by either package
loads in the other.

Both directions preserve bits (``unpack(pack(t)) == t``).  Leading batch
axes broadcast through both: packing leaves of shape ``[n, ...]`` gives
``[n, P]``; unpacking ``[n, P]`` gives the batched dict.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import torch

LANE = 128      # pack granularity


def _align(n: int) -> int:
    return ((n + LANE - 1) // LANE) * LANE


def _part(p) -> str:
    """One path component as text: the '/'-joined key convention of
    ``repro.checkpointing.checkpoint._part`` (dict keys and sequence
    indices both print as ``str``)."""
    return str(p)


def _flatten(tree, prefix=()) -> list:
    """``(path, leaf)`` pairs in jax's flatten order: dict keys sorted,
    sequences in index order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: numpy's spelling, which repro's
    layout json records."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class ParamLayout:
    """Static offsets/shapes of a param dict packed into one ``[P]``
    buffer.

    ``names`` are '/'-joined path keys in sorted-key order; ``dtypes`` are
    the template dtypes (numpy spelling) restored by :meth:`unpack`."""
    names: tuple            # str per leaf
    shapes: tuple           # tuple[int, ...] per leaf
    dtypes: tuple           # str per leaf
    offsets: tuple          # int per leaf, lane-aligned
    sizes: tuple            # int per leaf
    P: int                  # padded total length (multiple of LANE)

    def signature(self) -> tuple:
        return (self.names, self.shapes, self.dtypes, self.offsets,
                self.sizes, self.P)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_tree(cls, tree) -> "ParamLayout":
        names, shapes, dtypes, offsets, sizes = [], [], [], [], []
        off = 0
        for path, leaf in _flatten(tree):
            names.append("/".join(_part(p) for p in path))
            shape = tuple(int(s) for s in leaf.shape)
            size = leaf.numel()
            shapes.append(shape)
            dtypes.append(_dtype_name(leaf.dtype))
            offsets.append(off)
            sizes.append(size)
            off = _align(off + size)
        return cls(names=tuple(names), shapes=tuple(shapes),
                   dtypes=tuple(dtypes), offsets=tuple(offsets),
                   sizes=tuple(sizes), P=off)

    @property
    def nbytes_f32(self) -> int:
        return 4 * self.P

    # -- pack / unpack ------------------------------------------------------
    def pack(self, tree, dtype=torch.float32) -> torch.Tensor:
        """Param dict -> contiguous ``[*batch, P]`` buffer of ``dtype``
        (gaps and padding zero), on the leaves' device."""
        leaves = [leaf for _, leaf in _flatten(tree)]
        if len(leaves) != len(self.names):
            raise ValueError(f"{len(leaves)} leaves for a layout of "
                             f"{len(self.names)}")
        nd = len(self.shapes[0])
        batch = tuple(leaves[0].shape[:leaves[0].dim() - nd])
        out = torch.zeros(batch + (self.P,), dtype=dtype,
                          device=leaves[0].device)
        for leaf, off, size, shape in zip(leaves, self.offsets, self.sizes,
                                          self.shapes):
            if tuple(leaf.shape) != batch + shape:
                raise ValueError(f"leaf of shape {tuple(leaf.shape)} for "
                                 f"batch {batch} and layout shape {shape}")
            out[..., off:off + size] = leaf.reshape(batch + (size,))
        return out

    def unpack(self, flat: torch.Tensor) -> dict:
        """``[*batch, P]`` buffer -> param dict of template-dtype leaves.

        Each leaf is a view of ``flat`` (a slice, reshaped); a buffer of
        another dtype than the template's (the bf16 ring) is cast back,
        which copies.  Names with '/' rebuild nested dicts."""
        batch = tuple(flat.shape[:-1])
        if flat.shape[-1] != self.P:
            raise ValueError(f"buffer of length {flat.shape[-1]} for a "
                             f"layout of P={self.P}")
        out: dict = {}
        for name, off, size, shape, dt in zip(self.names, self.offsets,
                                              self.sizes, self.shapes,
                                              self.dtypes):
            leaf = flat[..., off:off + size].view(batch + shape)
            node = out
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf.to(getattr(torch, dt))
        return out

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "names": list(self.names),
            "shapes": [list(s) for s in self.shapes],
            "dtypes": list(self.dtypes),
            "offsets": list(self.offsets),
            "sizes": list(self.sizes),
            "P": self.P,
        })

    @classmethod
    def from_json(cls, text: str) -> "ParamLayout":
        """Rebuild a layout from :meth:`to_json` text (either package's).

        The leaves are put in the order a nested dict of the '/'-split
        names flattens to (sorted keys, as in ``repro``): that can differ
        from the stored order (e.g. '10' < '2'), so the per-leaf columns
        are permuted to it and every name keeps its offset, shape and
        dtype."""
        d = json.loads(text)
        nested: dict = {}
        for name in d["names"]:
            node = nested
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = 0
        canonical = ["/".join(_part(p) for p in path)
                     for path, _ in _flatten(nested)]
        if sorted(canonical) != sorted(d["names"]):
            raise ValueError(f"layout names {d['names']} do not rebuild "
                             "a tree")
        by_name = {n: i for i, n in enumerate(d["names"])}
        order = [by_name[n] for n in canonical]
        return cls(names=tuple(canonical),
                   shapes=tuple(tuple(d["shapes"][i]) for i in order),
                   dtypes=tuple(d["dtypes"][i] for i in order),
                   offsets=tuple(d["offsets"][i] for i in order),
                   sizes=tuple(d["sizes"][i] for i in order),
                   P=int(d["P"]))
