"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` exports plain C functions.  A source is named by its file
name under ``csrc/`` (the default directory) or by an absolute path, as the
race analyzer's fixture kernel is (``check/corpus/racy_sum.cu``).  On
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``kernels/_build/`` (git-ignored), named by a hash of
the source and the flags, and loaded with ``ctypes``.  Nothing is built or
imported at module import: CPU-only installs import this module and never
reach ``nvcc``.

A failed build raises with nvcc's stderr; a launch that returns a CUDA
error raises with the error's name.  There is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# the one compute capability the sm_90a binaries run on
CAPABILITY = (9, 0)
# where the CUDA toolkit installs nvcc when neither $CUDA_HOME nor $PATH
# names it
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build the "
        "port's kernels")


def source_path(source) -> Path:
    """``source`` itself when absolute, else ``csrc/<source>``."""
    p = Path(source)
    return p if p.is_absolute() else CSRC / p


def library_path(source) -> Path:
    """Where ``source`` builds to: keyed by its bytes and flags."""
    src = source_path(source)
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build(sources) -> dict[str, Path]:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together; returns ``{source: library path}``."""
    out = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in out.items() if not p.is_file()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(s))]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    errors = []
    for s, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {source_path(s)} "
                          f"(exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, todo[s])      # atomic: no half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_all() -> dict[str, Path]:
    """Build every kernel source of the port."""
    return build(sorted(p.name for p in CSRC.glob("*.cu")))


class CudaKernel:
    """One kernel library: lazy build and load, checked launches, and a
    count of launches (one per call that launched a kernel)."""

    def __init__(self, name: str, source: str, functions: dict):
        self.name = name
        self.source = source
        # exported symbol -> ctypes argtypes; every export returns an int
        self.functions = functions
        self.launches = 0
        self._lib = None
        self._checked = set()          # device indices found to be Hopper

    def _load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call export ``fn(device_index, *args)`` on ``device``; raises on
        a card other than Hopper and on any CUDA error of the launch."""
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        if index not in self._checked:
            cap = torch.cuda.get_device_capability(index)
            if cap != CAPABILITY:
                raise RuntimeError(
                    f"{self.name}: the kernel is built for sm_90a and needs "
                    f"a compute capability {CAPABILITY} card, not {cap} "
                    f"({torch.cuda.get_device_name(index)})")
            self._checked.add(index)
        lib = self._load()
        err = getattr(lib, fn)(index, *args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: launch of {fn} failed with CUDA error {err} "
                f"({lib.error_string(err).decode()})")
        self.launches += 1

    def grids(self, fn: str, max_launches: int, *args) -> list[tuple]:
        """The grids that host-only export ``fn(*args, int64_t* grids)``
        writes, ``(x, y, z)`` for each of up to ``max_launches`` launches of
        one call; an all-zero grid is a launch the call skips and is
        dropped.  Launches nothing and counts nothing, but needs the built
        library."""
        lib = self._load()
        buf = (ctypes.c_int64 * (3 * max_launches))()
        err = getattr(lib, fn)(*args, buf)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: {fn}{args} failed with CUDA error {err} "
                f"({lib.error_string(err).decode()})")
        grids = [tuple(buf[3 * i:3 * i + 3]) for i in range(max_launches)]
        return [g for g in grids if any(g)]
