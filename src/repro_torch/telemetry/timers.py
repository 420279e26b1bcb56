"""Host-side phase timers and memory probes: ``repro.telemetry.timers``
for the port (DESIGN.md §14).

Pure host instrumentation around the device work: the timers never touch
the device loop, so they are always on.  The phases the engines record:

- ``plan``    the f64 dry-run planner (``plan_fleet`` / ``plan_corridor``,
              the batched engine's consumed-set replay)
- ``stage``   world staging: minibatch stacks, gain table, slot queue;
              on the host engines the server, the vehicles, the test set
- ``run``     the event loop; on the device engines it ends once the
              trace is on the host, which waits for the card
- ``eval``    accuracy evaluation
- ``world``   ``run_scenario``'s and the sweep tier's ``build_world``
              calls (data, partition, channel)
- ``wave``    the batched engine's training waves (inside ``run``)

``repro`` also has ``build`` (Python tracing of a program); the port
stages no program, so it has none.  ``memory_stats(device)`` reports the
process peak RSS and, on a CUDA run, the card's allocator.

Each phase is also a ``torch.profiler.record_function`` range
``repro.<name>`` on the profiler's clock, so a trace can say which host
work the card waited on.  ``span(name)`` is such a range for host work no
engine's phase timers hold (K2's wrapper, the LM loop's data, update and
held-out loss); it adds its host time to :func:`span_totals`.  A range
opens only while a profiler records; otherwise it costs one check of the
profiler's state and dispatches no op.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch


# name -> [host seconds, count] of the spans of the newest profiling
# session; emptied by the first range that finds a profiler recording after
# one that found none (two sessions with no range run between them are
# summed together)
_TOTALS: dict[str, list] = {}
_recording = False
_OFF = nullcontext()


def _range(name: str):
    """``torch.profiler.record_function("repro." + name)`` while a profiler
    records; a context that does nothing otherwise."""
    global _recording
    if not torch.autograd._profiler_enabled():
        _recording = False
        return _OFF
    if not _recording:
        _TOTALS.clear()
        _recording = True
    return torch.profiler.record_function("repro." + name)


def span(name: str):
    """Range ``repro.<name>`` while a profiler records, its host time
    added to :func:`span_totals`; a context that does nothing otherwise."""
    rng = _range(name)
    return rng if rng is _OFF else _tallied(name, rng)


@contextmanager
def _tallied(name: str, rng):
    t0 = time.perf_counter()
    try:
        with rng:
            yield
    finally:
        tot = _TOTALS.setdefault(name, [0.0, 0])
        tot[0] += time.perf_counter() - t0
        tot[1] += 1


def span_totals() -> dict:
    """``{name: (host seconds, count)}`` of the spans that ran while a
    profiler recorded, in its newest session (nested spans each count
    their own time).  The time includes the profiler's own cost of every
    op inside a span."""
    return {k: (s, n) for k, (s, n) in _TOTALS.items()}


class PhaseTimers:
    """Accumulating wall-clock phase timers.

    >>> timers = PhaseTimers()
    >>> with timers.phase("plan"):
    ...     do_planning()
    >>> timers.snapshot()
    {'plan': 0.0123}

    Phases nest and repeat; repeated entries accumulate.  ``snapshot``
    returns plain floats (seconds) suitable for JSON.  Each phase is also
    a profiler range ``repro.<name>`` (not tallied by :func:`span`)."""

    def __init__(self):
        self._acc: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with _range(name):
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
