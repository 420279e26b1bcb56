"""What the benchmark must not load or read.

The system under test is the PyTorch port.  The JAX package it was ported
from, and JAX itself, must not run in a benchmark process: a module is
refused when its top-level name (the part before the first dot), compared
whole, is one of :data:`FORBIDDEN`, so the port's own package passes.  The
JAX package's sources and its benchmark folder must not be opened either:
:func:`watch_opens` records every file a process opens under them.
"""
from __future__ import annotations

import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# folders of the repository that belong to the JAX package and its own
# benchmark, relative to the repository's root
FORBIDDEN_DIRS = ("benchmarks", os.path.join("src", "repro"))


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name
    is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if n.split(".")[0] in FORBIDDEN)


class OpenWatch:
    """Paths opened under the forbidden folders of ``root``, recorded by an
    audit hook from the moment it is installed (hooks cannot be removed:
    install one per process)."""

    def __init__(self, root):
        root = os.path.realpath(str(root))
        self.prefixes = tuple(os.path.join(root, d) + os.sep
                              for d in FORBIDDEN_DIRS)
        self.hits: list[str] = []
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if event != "open" or not args:
            return
        path = args[0]
        if isinstance(path, (str, bytes, os.PathLike)):
            try:
                full = os.path.realpath(os.fsdecode(path))
            except (TypeError, ValueError):
                return
            if full.startswith(self.prefixes):
                self.hits.append(full)
