"""The program's tallied spans in a traced window.

``repro_torch.telemetry.timers.span`` opens a ``record_function`` range
``repro.<name>`` only while a profiler records, and adds its host time to
``span_totals()``: the spans of the profiler's newest session, which in a
``--trace 1`` run is the measured window.  Spans cover host work that no
episode's phases hold: K2's wrapper and the LM loop's data, update and
held-out loss (the phases, such as ``world``, ``wave`` and ``eval`` of the
simulator, are read through ``Run.phase``).  A program without spans (an
older checkout) has no ``span_totals``, and every reading here is then
nothing.  The host time includes the profiler's cost of every op inside a
span.
"""
from __future__ import annotations


def totals() -> dict:
    """``{name: (host seconds, count)}`` of the window's spans; empty
    where the program has none."""
    try:
        from repro_torch.telemetry.timers import span_totals
    except ImportError:
        return {}
    return span_totals()


def seconds(run, name: str) -> float | None:
    """Host seconds of span ``name`` in ``run``'s traced window; None when
    the window was not traced or the span never ran."""
    if run.trace is None:
        return None
    s, n = totals().get(name, (0.0, 0))
    return s if n else None


def share(run, name: str) -> float | None:
    """Span ``name``'s host time over the window, in percent."""
    s = seconds(run, name)
    if s is None or run.window_s <= 0:
        return None
    return 100.0 * s / run.window_s


def per(run, name: str, count: str, scale: float) -> float | None:
    """Span ``name``'s host time per unit of the episodes' ``count``,
    times ``scale`` (1e3: ms, 1e6: us)."""
    s, units = seconds(run, name), run.total(count)
    if s is None or not units:
        return None
    return scale * s / units
