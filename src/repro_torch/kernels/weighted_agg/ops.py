"""Wrappers of the fused aggregation kernels (``csrc/weighted_agg.cu`` and
``csrc/ring_agg.cu``).

``weighted_agg_tree`` mixes every leaf of two param dicts with the same
keys into one flat output buffer per dtype and returns views of it;
``weighted_agg`` is a table of one leaf.  Its scalars are Python floats
(the host form) or one-element f32 tensors on the leaves' device (the
device form, which the kernel reads on the card: the device engines' pytree
programs compute each arrival's weight there).  ``ring_agg`` streams a chain of U
mixes over packed ``[P]`` buffers (the fleet engine's aggregation), or over
``[W, P]`` buffers, one chain per world in one launch (the sweep tier's).
On a CPU tensor each wrapper runs its plain version (``ref``); on a CUDA
tensor it launches its kernel — one launch per ``MAX_LEAVES`` leaves of a
dtype, or per chain of all worlds — or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from bisect import bisect_right
from itertools import accumulate

import numpy as np
import torch

from repro_torch.kernels.build import CudaKernel, current_stream
from repro_torch.kernels.geometry import GRIDS_ARG, LaunchGeometry, Output
from repro_torch.kernels.weighted_agg import ref

LANE = 128      # ring_agg's buffers are ParamLayout buffers: P % LANE == 0
# launch constants of csrc/weighted_agg.cu and csrc/ring_agg.cu
THREADS = 256
UNROLL = 4                      # weighted_agg: 16-byte packs per thread
MAX_LEAVES = 112                # weighted_agg: leaves per launch (kMaxLeaves)
SMS = 132                       # ring_agg: the grid is a multiple (kSMs)
RING_PACKS = 2                  # ring_agg: 16-byte packs per thread (kPacks)

_INT64S = ctypes.POINTER(ctypes.c_int64)
# (device, ptrs, sizes, count, beta, coef, stream)
_ARGS = [ctypes.c_int, _INT64S, _INT64S, ctypes.c_int, ctypes.c_float,
         ctypes.c_float, ctypes.c_void_p]
_EXPORTS = {torch.float32: "weighted_agg_f32",
            torch.bfloat16: "weighted_agg_bf16"}
# the device form: (device, ptrs, sizes, count, [beta, weight] on the card,
# stream)
_DEV_ARGS = [ctypes.c_int, _INT64S, _INT64S, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
_DEV_EXPORTS = {torch.float32: "weighted_agg_f32_dev",
                torch.bfloat16: "weighted_agg_bf16_dev"}

KERNEL = CudaKernel("weighted_agg", "weighted_agg.cu",
                    {**{fn: _ARGS for fn in _EXPORTS.values()},
                     **{fn: _DEV_ARGS for fn in _DEV_EXPORTS.values()},
                     "weighted_agg_geometry": [_INT64S, ctypes.c_int,
                                               ctypes.c_int, GRIDS_ARG]})

# (device, out, g, locs, coeffs, P, U, W, ldw, stream)
_RING_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_void_p]
_RING_EXPORTS = {torch.float32: "ring_agg_f32",
                 torch.bfloat16: "ring_agg_bf16"}

RING_KERNEL = CudaKernel("ring_agg", "ring_agg.cu",
                         {**{fn: _RING_ARGS for fn in _RING_EXPORTS.values()},
                          "ring_agg_geometry": [ctypes.c_int64, ctypes.c_int,
                                                ctypes.c_int64, GRIDS_ARG]})


def flat_layout(sizes, dtype) -> tuple[list[int], int]:
    """Offsets of leaves of ``sizes`` elements in one flat ``dtype`` buffer,
    each start rounded up to 16 bytes, and the buffer's length."""
    pack = 16 // dtype.itemsize
    padded = [-(-n // pack) * pack for n in sizes]
    offsets = list(accumulate(padded, initial=0))
    return offsets[:-1], offsets[-1]


def launches(n_leaves: int) -> int:
    """Kernel launches of a merge of ``n_leaves`` non-empty leaves of one
    dtype: one per ``MAX_LEAVES``."""
    return -(-n_leaves // MAX_LEAVES)


def geometry(sizes, dtype) -> list[LaunchGeometry]:
    """The launches of ``weighted_agg_tree`` over leaves of ``sizes``
    elements of one ``dtype`` (``csrc/weighted_agg.cu:launch``): one per
    ``MAX_LEAVES`` non-empty leaves in order; leaf ``i`` of a launch owns
    ``ceil(n_i / E)`` blocks, ``E = THREADS * UNROLL`` 16-byte packs, and
    block ``j`` of it stores elements ``[j E, min((j + 1) E, n_i))`` of the
    leaf, the last block through the leaf's padding to 16 bytes.  Whether
    a block loads its range in packs or element by element (its leaf's
    pointers aligned or not) does not change the range."""
    offsets, total = flat_layout(sizes, dtype)
    pack = 16 // dtype.itemsize
    per = THREADS * UNROLL * pack
    live = [(n, off) for n, off in zip(sizes, offsets) if n]
    out = []
    for c in range(0, len(live), MAX_LEAVES):
        chunk = live[c:c + MAX_LEAVES]
        first = list(accumulate((-(-n // per) for n, _ in chunk),
                                initial=0))

        def ranges(block, chunk=chunk, first=first):
            i = bisect_right(first, block[0]) - 1
            n, off = chunk[i]
            start = (block[0] - first[i]) * per
            stop = start + per
            if stop >= n:
                stop = -(-n // pack) * pack
            return [(off + start, off + stop)]
        out.append(LaunchGeometry("weighted_agg_kernel", (first[-1],),
                                  THREADS, {"out": Output(total, ranges)}))
    return out


def cu_grids(sizes, dtype) -> list[tuple]:
    """The grids ``csrc/weighted_agg.cu`` computes for the same arguments
    (its ``weighted_agg_geometry`` export; needs the built library)."""
    live = [n for n in sizes if n]
    return KERNEL.grids("weighted_agg_geometry", max(len(live), 1),
                        (ctypes.c_int64 * len(live))(*live), len(live),
                        dtype.itemsize)


def ring_geometry(P: int, U: int, dtype, W: int = 1) -> list[LaunchGeometry]:
    """The launch of ``ring_agg`` over W worlds of a ``[P]`` buffer and U
    upload rows of ``dtype`` (``csrc/ring_agg.cu:launch``): on x, the
    fewest multiples of ``SMS`` blocks that hold the ``P / elems`` 16-byte
    upload packs (``elems = 16 / itemsize``) at ``THREADS * RING_PACKS`` a
    block (``grid_blocks``), on y the W worlds; block ``(i, w)`` owns one
    contiguous run of world w's packs, the runs in block order and
    differing by at most one pack (``run_of``), for the whole chain, and
    stores exactly those elements of world w's row of the ``[W, P]``
    ``out``.  ``U == 0`` launches nothing; ``W == 1`` is a one-axis grid
    (the y extent 1)."""
    if U == 0:
        return []
    elems = 16 // dtype.itemsize
    packs = P // elems
    blocks = SMS * max(1, -(-packs // (SMS * THREADS * RING_PACKS)))
    per, extra = divmod(packs, blocks)

    def ranges(block):
        lo = block[0] * per + min(block[0], extra)
        hi = lo + per + (block[0] < extra)
        base = (block[1] if len(block) > 1 else 0) * P
        return [(base + lo * elems, base + hi * elems)]
    grid = (blocks,) if W == 1 else (blocks, W)
    return [LaunchGeometry("ring_agg_kernel", grid, THREADS,
                           {"out": Output(W * P, ranges)})]


def ring_cu_grids(P: int, U: int, dtype, W: int = 1) -> list[tuple]:
    """The grids ``csrc/ring_agg.cu`` computes for the same arguments."""
    if U == 0:
        return []
    return RING_KERNEL.grids("ring_agg_geometry", 1, P, dtype.itemsize, W)


def weighted_agg(g, l, beta, weight):
    """out = beta*g + ((1-beta)*weight)*l in f32, cast to ``g.dtype``: a
    merge of one leaf."""
    return weighted_agg_tree({"": g}, {"": l}, beta, weight)[""]


def _device_form(beta, weight, device) -> bool:
    """Whether a merge takes the device form (either scalar a tensor);
    raises on a tensor that is not one f32 element on ``device``."""
    tensors = [x for x in (beta, weight) if isinstance(x, torch.Tensor)]
    for x in tensors:
        if x.dtype != torch.float32 or x.numel() != 1:
            raise TypeError(f"weighted_agg: a tensor scalar must be one f32 "
                            f"element; got {tuple(x.shape)} {x.dtype}")
        if x.device != device:
            raise ValueError(f"weighted_agg: a tensor scalar on {x.device} "
                             f"for leaves on {device}")
    return bool(tensors)


def _scalar_pair(beta, weight, device):
    """The device form's ``[beta, weight]``: one contiguous f32 ``[2]``
    tensor on ``device``, built by torch ops on the card (a Python float
    is filled in, rounded to f32), with no host read."""
    return torch.cat([x.reshape(1) if isinstance(x, torch.Tensor)
                      else torch.full((1,), float(np.float32(x)),
                                      dtype=torch.float32, device=device)
                      for x in (beta, weight)])


def _check_tree(global_params, local_params) -> tuple:
    """The merge's signature, ``(shape, dtype)`` per leaf in key order, and
    its device; raises on anything the kernel does not take."""
    if global_params.keys() != local_params.keys():
        raise ValueError(
            f"weighted_agg: the two param dicts differ in keys: "
            f"{sorted(global_params.keys() ^ local_params.keys())}")
    gs, ls = global_params.values(), local_params.values()
    sig = tuple((g.shape, g.dtype) for g in gs)
    devices = {t.device for t in gs} | {t.device for t in ls}
    if tuple((l.shape, l.dtype) for l in ls) != sig or len(devices) > 1:
        for k, g in global_params.items():
            l = local_params[k]
            if (g.shape, g.dtype, g.device) != (l.shape, l.dtype, l.device):
                raise ValueError(
                    f"weighted_agg: g and l must match in shape, dtype and "
                    f"device; leaf {k!r}: {tuple(g.shape)} {g.dtype} "
                    f"{g.device} and {tuple(l.shape)} {l.dtype} {l.device}")
        raise ValueError(f"weighted_agg: leaves on several devices "
                         f"{sorted(map(str, devices))}")
    for k, (_, dtype) in zip(global_params, sig):
        if dtype not in _EXPORTS:
            raise TypeError(f"weighted_agg: unsupported dtype {dtype} "
                            f"(leaf {k!r}); expected one of {list(_EXPORTS)}")
    device = devices.pop() if devices else torch.device("cpu")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"weighted_agg: unsupported device {device}")
    if device.type == "cuda" and not all(
            t.is_contiguous() for vs in (gs, ls) for t in vs):
        raise ValueError("weighted_agg: g and l must be contiguous")
    return sig, device


@functools.lru_cache(maxsize=64)
def _plan(sig: tuple) -> list:
    """Per dtype of a merge's ``(shape, dtype)`` signature: ``(dtype,
    leaves, sizes, offsets, total, templates, at)``: the leaf indices in key
    order, their elements, each leaf's offset in the flat buffer and the
    buffer's length; meta tensors that cut the buffer into the non-empty
    leaves' shapes and the paddings between them, and the position of each
    leaf's view among those pieces (None for an empty leaf)."""
    plans = []
    for dtype in dict.fromkeys(dt for _, dt in sig):
        leaves = [i for i, (_, dt) in enumerate(sig) if dt == dtype]
        sizes = [math.prod(sig[i][0]) for i in leaves]
        offsets, total = flat_layout(sizes, dtype)
        templates, at = [], []
        for i, n, off, end in zip(leaves, sizes, offsets,
                                  offsets[1:] + [total]):
            at.append(len(templates) if n else None)
            if n:
                templates.append(torch.empty(sig[i][0], device="meta"))
            if end - off - n:
                templates.append(torch.empty(end - off - n, device="meta"))
        plans.append((dtype, leaves, sizes, offsets, total, templates,
                      at))
    return plans


def weighted_agg_tree(global_params, local_params, beta, weight):
    """Drop-in for ``aggregation.mafl_update(..., use_kernel=True)``: every
    leaf mixed as ``weighted_agg`` mixes one.  The result holds, under the
    same keys, contiguous views of one new flat buffer per dtype (each
    leaf 16-byte aligned in it) of the inputs' shapes and dtypes; the
    inputs are never written.  On the card that is one launch per
    ``MAX_LEAVES`` non-empty leaves of a dtype, the leaves' pointers and
    sizes passed by value: no copy to the card, no host sync.

    ``beta`` and ``weight`` are Python floats (the host form: rounded to
    f32 on the host, :func:`ref.agg_scalars`) or one-element f32 tensors
    on the leaves' device, either or both (the device form: the kernel
    reads ``[beta, weight]`` on the card and forms ``(1 - beta) * weight``
    in the same f32 order, so equal values give equal bits)."""
    sig, device = _check_tree(global_params, local_params)
    scal = None
    if _device_form(beta, weight, device):
        if device.type == "cuda":
            scal = _scalar_pair(beta, weight, device)
    else:
        b, coef = ref.agg_scalars(beta, weight)
    gs = list(global_params.values())
    ls = list(local_params.values())
    outs = [None] * len(gs)
    for dtype, leaves, sizes, offsets, total, templates, at in _plan(sig):
        flat = torch.empty(total, dtype=dtype, device=device)
        # every leaf's view in one call (the paddings are pieces too)
        parts = torch._C._nn.unflatten_dense_tensors(flat, templates)
        for i, off, j in zip(leaves, offsets, at):
            outs[i] = (parts[j] if j is not None
                       else flat.narrow(0, off, 0).view(sig[i][0]))
        if device.type == "cpu":
            for i in leaves:
                outs[i].copy_(ref.weighted_agg(gs[i], ls[i], beta, weight))
            continue
        base, size = flat.data_ptr(), dtype.itemsize
        live = [(i, n, off) for i, n, off in zip(leaves, sizes, offsets)
                if n]
        stream = current_stream(device)
        for c in range(0, len(live), MAX_LEAVES):
            chunk = live[c:c + MAX_LEAVES]
            ptrs = (ctypes.c_int64 * (3 * len(chunk)))(*(
                p for i, _, off in chunk for p in (
                    gs[i].data_ptr(), ls[i].data_ptr(), base + off * size)))
            ns = (ctypes.c_int64 * len(chunk))(*(n for _, n, _ in chunk))
            if scal is None:
                KERNEL.launch(_EXPORTS[dtype], device, ptrs, ns, len(chunk),
                              b, coef, stream)
            else:
                KERNEL.launch(_DEV_EXPORTS[dtype], device, ptrs, ns,
                              len(chunk), scal.data_ptr(), stream)
    return dict(zip(global_params, outs))


def _check_ring_inputs(g, locs, coeffs) -> tuple:
    """``(device, upload dtype, W, U, P, ldw)`` of a chain (``W = 1`` for
    the one-world form, ``ldw`` the world stride of ``locs`` in elements);
    raises on anything the kernel does not take.  Each tensor attribute is
    read once: this runs on every chain of the device engines."""
    g_shape, g_dtype = g.shape, g.dtype
    g_contiguous = g.is_contiguous()
    nd = len(g_shape)
    if g_dtype != torch.float32 or nd not in (1, 2) or not g_contiguous:
        raise ValueError(
            f"ring_agg: g must be a contiguous f32 [P] or [W, P] buffer; "
            f"got {tuple(g_shape)} {g_dtype} contiguous={g_contiguous}")
    P = g_shape[-1]
    W = g_shape[0] if nd == 2 else 1
    if P % LANE:
        raise ValueError(f"ring_agg: P={P} is not a multiple of {LANE} "
                         "(a ParamLayout buffer)")
    l_shape, l_dtype = locs.shape, locs.dtype
    want = f"[U, {P}]" if nd == 1 else f"[{W}, U, {P}]"
    if (len(l_shape) != nd + 1 or l_shape[-1] != P
            or (nd == 2 and l_shape[0] != W)):
        raise ValueError(f"ring_agg: locs must be {want}; got "
                         f"{tuple(l_shape)}")
    if l_dtype not in _RING_EXPORTS:
        raise TypeError(f"ring_agg: locs dtype {l_dtype}; expected one "
                        f"of {list(_RING_EXPORTS)}")
    U = l_shape[-2]
    l_stride = locs.stride()
    if U and (l_stride[-1] != 1 or (U > 1 and l_stride[-2] != P)):
        raise ValueError("ring_agg: locs must be contiguous rows")
    ldw = U * P
    if W > 1 and U:
        ldw = l_stride[0]
        if ldw % P or ldw < U * P:
            raise ValueError(
                f"ring_agg: the world stride of locs ({ldw}) must be a "
                f"multiple of P={P} of at least U*P={U * P}")
    c_shape, c_dtype = coeffs.shape, coeffs.dtype
    c_contiguous = coeffs.is_contiguous()
    c_want = (U, 2) if nd == 1 else (W, U, 2)
    if c_dtype != torch.float32 or c_shape != c_want or not c_contiguous:
        raise ValueError(
            f"ring_agg: coeffs must be a contiguous f32 {list(c_want)} "
            f"tensor; got {tuple(c_shape)} {c_dtype} "
            f"contiguous={c_contiguous}")
    device, l_device, c_device = g.device, locs.device, coeffs.device
    if not device == l_device == c_device:
        raise ValueError(f"ring_agg: g, locs and coeffs on {device}, "
                         f"{l_device}, {c_device}")
    return device, l_dtype, W, U, P, ldw


def ring_agg(g, locs, coeffs):
    """Fused multi-upload chain over packed flat buffers (DESIGN.md §12):
    ``acc <- c_u*acc + d_u*locs[u]`` for u = 0..U-1 from ``acc = g``, in
    f32; returns a new f32 tensor of ``g``'s shape and never writes its
    inputs.

    One world: ``g`` contiguous f32 ``[P]``, ``P % 128 == 0``; ``locs``
    ``[U, P]`` f32 or bf16 with contiguous rows; ``coeffs`` contiguous f32
    ``[U, 2]`` of ``(c, d)`` pairs.  A world axis (the sweep tier): ``g``
    ``[W, P]``, ``locs`` ``[W, U, P]`` whose world stride may be any
    multiple of ``P`` of at least ``U * P`` (a ``[:, a:b]`` view of a
    ``[W, M, P]`` upload buffer, never copied), ``coeffs`` ``[W, U, 2]``:
    world ``w``'s chain is the one-world chain on its slices, bit for bit,
    and all W run in one launch.  All on one device (the host never reads
    a coefficient).  ``U == 0`` returns a copy of ``g`` and launches
    nothing."""
    device, dtype, W, U, P, ldw = _check_ring_inputs(g, locs, coeffs)
    if U == 0:
        return g.to(torch.float32, copy=True)
    if device.type == "cpu":
        return ref.ring_agg(g, locs, coeffs)
    if device.type != "cuda":
        raise ValueError(f"ring_agg: unsupported device {device}")
    out = torch.empty_like(g)
    # 16-byte packs of g, locs rows and out; 8-byte (c, d) pairs.  Rows and
    # worlds are multiples of P apart with P % 128 == 0, so an aligned base
    # aligns every row.
    pg, pl, po, pc = (g.data_ptr(), locs.data_ptr(), out.data_ptr(),
                      coeffs.data_ptr())
    if (pg | pl | po) & 15 or pc & 7:
        raise ValueError("ring_agg: g and locs must start 16-byte aligned "
                         "and coeffs 8-byte aligned")
    RING_KERNEL.launch(_RING_EXPORTS[dtype], device, po, pg, pl, pc, P,
                       U, W, ldw, current_stream(device))
    return out


def prefix_weights(coeffs) -> np.ndarray:
    """The chain's closed form: weights ``w[U+1]`` (f64) such that

        ring_agg(g, locs, coeffs) ~= w[0]*g + sum_u w[1+u]*locs[u]

    with ``w[0] = prod_u c_u`` and ``w[1+u] = d_u * prod_{v>u} c_v``.
    Equality is algebraic, not bitwise: evaluating this form reassociates
    the f32 arithmetic, which is why the kernel evaluates the chain in
    order."""
    c = np.asarray(coeffs, np.float64)
    U = c.shape[0]
    w = np.empty(U + 1)
    suffix = 1.0
    for u in range(U - 1, -1, -1):
        w[1 + u] = c[u, 1] * suffix
        suffix *= c[u, 0]
    w[0] = suffix
    return w
