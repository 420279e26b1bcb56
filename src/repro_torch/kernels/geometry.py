"""Launch geometry of the port's CUDA kernels: what the grid-race classifier
(``repro_torch.check.grid_race``) reads.

A :class:`LaunchGeometry` is one kernel launch: its grid (the ``blockIdx``
extents, x first), its threads per block, and for each output the flat
element ranges ``[start, stop)`` that one block may store to.  Each
``kernels/*/ops.py`` builds it with ``geometry(...)`` from the shape
arguments its wrapper passes, transcribing the host launch code of its
``.cu``; each ``.cu`` exports ``<name>_geometry``, the grid its launch
path computes through the same helper the launch uses, so that the card
can hold the two together (``chip_smoke.py``, ``cu_grids``).  Nothing here
needs a card or ``nvcc``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import numpy as np

Ranges = list[tuple[int, int]]

# the trailing argument of every ``<name>_geometry`` export: int64_t* grids
GRIDS_ARG = ctypes.POINTER(ctypes.c_int64)


@dataclass(frozen=True)
class Output:
    """One output of a launch: its length in elements, and the ranges
    ``[start, stop)`` that the block ``(x, y, ...)`` may store to."""
    size: int
    ranges: Callable[[tuple], Ranges]


@dataclass(frozen=True)
class LaunchGeometry:
    kernel: str                 # the __global__ function launched
    grid: tuple                 # blockIdx extents, x first (1-3 axes)
    threads: int                # threads per block
    outputs: dict               # name -> Output

    @property
    def dim3(self) -> tuple:
        """The grid as the launch's ``dim3`` ``(x, y, z)``."""
        return tuple(self.grid) + (1,) * (3 - len(self.grid))

    def blocks(self):
        """Every block index of the grid (CUDA runs them in no order)."""
        return np.ndindex(*self.grid)

    def written(self, name: str) -> np.ndarray:
        """bool[size]: the elements of output ``name`` that some block may
        store to (the union of every block's ranges)."""
        out = self.outputs[name]
        mask = np.zeros(out.size, bool)
        for blk in self.blocks():
            for a, b in out.ranges(blk):
                mask[a:b] = True
        return mask
