"""Host-side phase timers and memory probes: ``repro.telemetry.timers``
for the port (DESIGN.md §14).

Pure host instrumentation around the device work: the timers never touch
the device loop, so they are always on.  The phases the engines record:

- ``plan``    the f64 dry-run planner (``plan_fleet`` / ``plan_corridor``,
              the batched engine's consumed-set replay)
- ``stage``   world staging: minibatch stacks, gain table, slot queue
- ``run``     the event loop; on the device engines it ends once the
              trace is on the host, which waits for the card
- ``eval``    accuracy evaluation

``repro`` also has ``build`` (Python tracing of a program); the port
stages no program, so it has none.  ``memory_stats(device)`` reports the
process peak RSS and, on a CUDA run, the card's allocator.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class PhaseTimers:
    """Accumulating wall-clock phase timers.

    >>> timers = PhaseTimers()
    >>> with timers.phase("plan"):
    ...     do_planning()
    >>> timers.snapshot()
    {'plan': 0.0123}

    Phases nest and repeat; repeated entries accumulate.  ``snapshot``
    returns plain floats (seconds) suitable for JSON."""

    def __init__(self):
        self._acc: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt

    def add(self, name: str, seconds: float) -> None:
        """Fold an externally measured duration into a phase."""
        self._acc[name] = self._acc.get(name, 0.0) + float(seconds)

    def snapshot(self) -> dict:
        return dict(self._acc)


def memory_stats(device=None) -> dict:
    """Process peak RSS, plus the card's allocator on a CUDA ``device``.

    Keys are ``repro``'s: ``peak_rss_bytes`` (``ru_maxrss`` is KiB on
    Linux) and, on a CUDA run, ``device_bytes_in_use``,
    ``device_peak_bytes_in_use`` and ``device_bytes_limit``
    (``torch.cuda.memory_allocated``, ``max_memory_allocated`` and the
    total of ``mem_get_info``).  A CPU run leaves the device keys out, as
    ``repro`` does on its CPU backend."""
    out: dict = {}
    try:
        import resource
    except ImportError:  # pragma: no cover - non-POSIX
        pass
    else:
        out["peak_rss_bytes"] = int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    if device is not None and torch.device(device).type == "cuda":
        out["device_bytes_in_use"] = int(torch.cuda.memory_allocated(device))
        out["device_peak_bytes_in_use"] = int(
            torch.cuda.max_memory_allocated(device))
        out["device_bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    return out
