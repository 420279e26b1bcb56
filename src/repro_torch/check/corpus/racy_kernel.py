"""A deliberately racy CUDA kernel (F1): the counterpart of
``repro/check/fixtures/racy_kernel.py``.  Block ``(i, u)`` of the grid
``(R // br, U)`` adds the sum of its ``br x 1`` tile into ``out[u]`` with a
plain read-modify-write, so the row-tile axis collides on every output
element: classification ``racy``, revisit axis 0 (PAL001).

The kernel is ``racy_sum.cu`` beside this file, built like the production
kernels into ``kernels/_build/``.  ``racy_sum`` follows its tensor's device:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.  The wrapper zeroes the output, so the defined value is the column
sums; a launch with more than one row tile loses updates at random.  It is
not in ``repro_torch.kernels.KERNELS``: no main path launches it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, current_stream
from repro_torch.kernels.geometry import GRIDS_ARG, LaunchGeometry, Output

SOURCE = Path(__file__).resolve().with_name("racy_sum.cu")
THREADS = 256
MAX_COLUMNS = 65535                 # the grid's y axis

# (device, out, x, R, U, br, stream)
KERNEL = CudaKernel("racy_sum", str(SOURCE), {
    "racy_sum_f32": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                     ctypes.c_void_p],
    "racy_sum_geometry": [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                          GRIDS_ARG]})


def plain_sum(x, block_rows: int = 2):
    """The defined value: the sum of every ``block_rows`` tile of each
    column, summed over the tiles."""
    R, U = x.shape
    return x.view(R // block_rows, block_rows, U).sum(1).sum(0)


def geometry(R: int, U: int, block_rows: int = 2) -> list[LaunchGeometry]:
    """The launch of ``racy_sum`` (``racy_sum.cu:racy_sum_f32``): block
    ``(i, u)`` stores to ``out[u]``."""
    def column(block):
        return [(block[1], block[1] + 1)]
    return [LaunchGeometry("racy_sum_kernel", (R // block_rows, U), THREADS,
                           {"out": Output(U, column)})]


def cu_grids(R: int, U: int, block_rows: int = 2) -> list[tuple]:
    """The grids ``racy_sum.cu`` computes for the same arguments."""
    return KERNEL.grids("racy_sum_geometry", 1, R, U, block_rows)


def racy_sum(x, *, block_rows: int = 2):
    """x: f32 ``[R, U]`` -> ``[U]`` tile sums through the racy kernel."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"racy_sum: x must be f32 [R, U]; got "
                         f"{tuple(x.shape)} {x.dtype}")
    R, U = x.shape
    if block_rows < 1 or R % block_rows:
        raise ValueError(f"racy_sum: R={R} is not a multiple of "
                         f"block_rows={block_rows}")
    if x.device.type == "cpu":
        return plain_sum(x, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"racy_sum: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("racy_sum: x must be contiguous")
    if not 1 <= U <= MAX_COLUMNS or R == 0:
        raise ValueError(f"racy_sum: U={U} must be in 1..{MAX_COLUMNS} and "
                         f"R={R} at least 1")
    out = torch.zeros(U, dtype=torch.float32, device=x.device)
    KERNEL.launch("racy_sum_f32", x.device, out.data_ptr(), x.data_ptr(), R,
                  U, block_rows,
                  current_stream(x.device))
    return out


def invoke() -> list[LaunchGeometry]:
    """Analyzer case: grid (4, 2); output element u is stored by the blocks
    (0, u) .. (3, u), which differ on axis 0."""
    return geometry(8, 2, block_rows=2)
