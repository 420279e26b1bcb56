"""Flat-npz pytree checkpointing with retention, the counterpart of
``repro.checkpointing.checkpoint``: the same file names, npz keys, json
sidecar and byte stream, so a checkpoint written by either package loads
in the other.

A tree is nested dicts, lists and tuples whose leaves are torch tensors
(any device), numpy arrays or Python scalars; paths are the '/'-joined
keys in jax's flatten order (dict keys sorted, sequences by index).  bf16
leaves are stored as their uint16 bits under ``<path>::bf16`` (npz has no
bf16) and come back bit for bit through torch's bfloat16, with no
``ml_dtypes``.  A transformer is checkpointed in ``repro``'s nested,
period-stacked layout (``convert.transformer_params_to_numpy``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.core.flat import ParamLayout, _flatten, _part

_SEP = "/"
_BF16 = "::bf16"


def _key(path) -> str:
    return _SEP.join(_part(p) for p in path)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _raw(leaf) -> np.ndarray:
    """The leaf's elements as a contiguous numpy array of the same bytes
    (bf16 tensors as uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf, order="C")


def tree_digest(tree: Any) -> str:
    """sha256 over a tree's (path, dtype, shape, raw bytes) stream: a
    bitwise identity of model parameters, equal to ``repro``'s digest of
    the same values in the same structure."""
    h = hashlib.sha256()
    for path, leaf in _flatten(tree):
        raw = _raw(leaf)
        h.update(_key(path).encode())
        h.update(_dtype_name(leaf).encode())
        h.update(str(tuple(raw.shape)).encode())
        h.update(raw.tobytes())
    return h.hexdigest()


def _npz_entries(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in _flatten(tree):
        key = _key(path)
        if _dtype_name(leaf) == "bfloat16":      # npz can't round-trip bf16
            flat[key + _BF16] = _raw(leaf).view(np.uint16)
        else:
            flat[key] = _raw(leaf)
    return flat


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3,
                    meta: dict | None = None) -> str:
    """Write ``ckpt_NNNNNNNN.npz`` (+ optional sidecar json) atomically.

    Both files are written to ``.tmp`` siblings, fsynced, and published
    with ``os.replace``: a process killed mid-write never leaves a
    truncated checkpoint where ``latest_checkpoint`` would find it.  The
    sidecar is published first, so any visible npz already has it.  Keeps
    the newest ``keep`` checkpoints and sweeps stale ``.tmp`` files."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    entries = _npz_entries(tree)
    if meta is not None:
        _write_atomic(path + ".json",
                      lambda f: f.write(json.dumps(meta).encode()))
    _write_atomic(path, lambda f: np.savez(f, **entries))
    _retain(directory, keep)
    return path


def _retain(directory: str, keep: int):
    names = os.listdir(directory)
    ckpts = sorted(f for f in names if re.fullmatch(r"ckpt_\d+\.npz", f))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
        if os.path.exists(os.path.join(directory, old + ".json")):
            os.remove(os.path.join(directory, old + ".json"))
    # orphaned .tmp siblings of a killed writer are never visible to
    # latest_checkpoint: sweep them on the next save
    for stale in names:
        if re.fullmatch(r"ckpt_\d+\.npz(\.json)?\.tmp", stale):
            try:
                os.remove(os.path.join(directory, stale))
            except FileNotFoundError:
                pass


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if re.fullmatch(r"ckpt_\d+\.npz", f))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, order="C").view(np.int16)).view(
        torch.bfloat16)


def _restore(stored, bf16: bool, leaf):
    """A stored array in the kind, dtype and device of template ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        t = _bf16_tensor(stored) if bf16 else torch.from_numpy(stored)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    want = np.asarray(leaf).dtype
    if bf16 and want.name == "bfloat16":
        return stored.view(want)
    if bf16:
        return _bf16_tensor(stored).float().numpy().astype(want)
    return stored.astype(want)


def _rebuild(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, path + (i,))
                          for i, v in enumerate(tree))
    return leaves[path]


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a template tree): each leaf
    takes the template leaf's kind (tensor or array), dtype and device."""
    leaves = {}
    with np.load(path) as data:
        for p, leaf in _flatten(like):
            key = _key(p)
            bf16 = key + _BF16 in data
            stored = data[key + _BF16] if bf16 else data[key]
            shape = (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
                     else np.shape(leaf))
            if tuple(stored.shape) != shape:
                raise ValueError(f"{key}: stored {tuple(stored.shape)}, "
                                 f"template {shape}")
            leaves[p] = _restore(stored, bf16, leaf)
    return _rebuild(like, leaves)


def save_flat_checkpoint(directory: str, step: int, flat, layout: ParamLayout,
                         keep: int = 3, meta: dict | None = None) -> str:
    """Checkpoint a packed ``[P]`` (or ``[n, P]``) buffer with its
    :class:`ParamLayout` in the sidecar json under ``"layout"``; f32 and
    bf16 buffers round-trip bit for bit."""
    m = dict(meta or {})
    m["layout"] = layout.to_json()
    return save_checkpoint(directory, step, {"flat": flat}, keep=keep,
                           meta=m)


def load_flat_checkpoint(path: str):
    """Restore ``(flat, layout)``: ``flat`` a CPU tensor of the stored
    dtype; ``layout.unpack(flat)`` gives the param dict."""
    with open(path + ".json") as f:
        layout = ParamLayout.from_json(json.load(f)["layout"])
    with np.load(path) as data:
        if "flat" + _BF16 in data:
            flat = _bf16_tensor(data["flat" + _BF16])
        else:
            flat = torch.from_numpy(data["flat"])
    if flat.shape[-1] != layout.P:
        raise ValueError(f"flat buffer of length {flat.shape[-1]} for a "
                         f"layout of P={layout.P}")
    return flat, layout
