"""Device meshes over ``torch.distributed`` ranks: the counterpart of
``repro.launch.mesh`` and of the ``shard_map`` collectives the simulator
runs on them.

A JAX mesh device is a rank here, one process.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
``repro``'s axis names (``"data"``, ``"model"``, ``"pod"``, ``"rsu"``).
Every rank runs the same f64 host plan and the same program; the sharded
parts split the work and meet in collectives, each one an ``all_reduce``
(or a ``broadcast``): psum is ``all_reduce(SUM)``, pmean that over the
axis size, and a tiled gather each rank writing its rows into a buffer
of ``-0.0`` before the sum, which is exact (``x + -0 = x``).  Those two are the
collectives gloo runs on CUDA tensors, so two ranks can share one card;
NCCL serves several cards.

Building a mesh is a collective: every rank of the group calls the same
builders in the same order.  Nothing here runs when the module is
imported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _start_group(world: int, device: torch.device) -> None:
    """The default process group for a mesh of ``world`` ranks: the one
    the caller started, or, for a one-rank mesh when there is none, a
    one-rank group on an in-process store (NCCL on ``cuda``, gloo on
    ``cpu``)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(
                f"a mesh of {world} devices needs a process group of {world} "
                f"ranks; this one has {dist.get_world_size()}")
        return
    if world != 1:
        raise RuntimeError(
            f"a mesh of {world} devices needs a process group of {world} "
            "ranks: call torch.distributed.init_process_group on every rank "
            "first")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape, axes, device=None):
    """The counterpart of ``jax.make_mesh(shape, axes)``: a mesh of
    ``prod(shape)`` ranks, row-major over ``axes``, on ``device``'s type
    (``None`` -> the card)."""
    device = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    _start_group(math.prod(shape), device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """The degenerate one-device ``("data", "model")`` mesh of smoke runs,
    shape (1, 1)."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (16, 16) ``("data", "model")``, 256 ranks; multi-pod:
    (2, 16, 16) ``("pod", "data", "model")``, 512 ranks.  Needs a process
    group of exactly that many ranks, started by the caller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} needs a process group of "
            f"{math.prod(shape)} ranks; "
            + ("none is started" if world is None
               else f"this one has {world}"))
    return make_mesh(shape, axes, device)


def check_mesh_device(mesh, device: torch.device) -> None:
    """A mesh is a ``DeviceMesh`` (:func:`make_mesh`) on the run's device
    type; anything else raises."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh (launch/mesh.py: "
            f"make_mesh), not {type(mesh).__name__}")
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh's devices are {mesh.device_type!r} but the run's "
            f"device is {device}: build the mesh on the run's device type")


@dataclass(frozen=True)
class Axis:
    """One named axis of a mesh as this rank sees it: its size, this
    rank's coordinate on it and the process group along it."""
    name: str
    size: int
    index: int
    group: object


def mesh_axis(mesh, name: str):
    """Axis ``name`` of ``mesh``, or None when there is no mesh or the mesh
    has no such axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return Axis(name, mesh.size(mesh.mesh_dim_names.index(name)),
                mesh.get_local_rank(name), mesh.get_group(name))


def psum_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over ``axis`` in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


def _flat(tree: dict, n: int) -> torch.Tensor:
    """The leaves of ``tree`` (each ``[n, ...]``) as one new f32 ``[n, F]``
    buffer, leaf after leaf, so one collective serves the whole dict.  f32
    holds every f32 and bf16 value exactly."""
    return torch.cat([x.reshape(n, -1).float() for x in tree.values()], 1)


def _split(buf: torch.Tensor, like: dict, lead: tuple) -> dict:
    """``buf``'s columns as ``like``'s leaves, each shaped ``lead + its
    shape``, cast to its dtype and contiguous (the kernels take contiguous
    leaves only)."""
    out, off = {}, 0
    for k, x in like.items():
        out[k] = buf[..., off:off + x.numel()].reshape(
            lead + tuple(x.shape)).to(x.dtype).contiguous()
        off += x.numel()
    return out


def pmean_tree(tree: dict, axis: Axis) -> dict:
    """The mean over ``axis`` of each leaf of ``tree``: one f32 sum over
    the axis, ``/ size``, cast back to each leaf's dtype.  New tensors."""
    buf = psum_(_flat({k: x[None] for k, x in tree.items()}, 1), axis)
    return _split(buf[0] / axis.size, tree, ())


def share_rows(blocks: dict, total: int, like: dict, axis: Axis) -> dict:
    """Rows of a dict of leaves, tiled over ``axis``.  ``blocks`` maps a
    start row to the rows this rank holds there, a dict of ``[n, ...]``
    leaves (``like``'s leaves with a leading axis); each block lands in an
    ``[total, F]`` f32 buffer, the buffer is summed over the axis,
    and each leaf comes back ``[total, ...]`` in ``like``'s dtype.  The
    ranks' blocks must not overlap.  Exact, signed zeros included: the
    buffer starts at ``-0.0``, the additive identity of IEEE floats (``x +
    -0 = x`` for every x, ``+0`` too).  New tensors."""
    x0 = next(iter(like.values()))
    buf = torch.full((total, sum(x.numel() for x in like.values())), -0.0,
                     dtype=torch.float32, device=x0.device)
    for start, rows in blocks.items():
        n = next(iter(rows.values())).shape[0]
        buf[start:start + n] = _flat(rows, n)
    return _split(psum_(buf, axis), like, (total,))
