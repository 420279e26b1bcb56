"""The host f64 planner side of telemetry: ``repro.telemetry.spec`` for the
port (DESIGN.md §14).

A :class:`MetricsSpec` is static plan data, like the selection layer's
admission tables: the host f64 dry run declares it and the device loops
read it as constants, so the device never makes a data-dependent shape
decision.  The one subtle piece is the staleness histogram: the device
computes staleness in f32 while the conformance oracle replays it in f64,
so a bin edge sitting close to a sample could bucket differently on the
two sides.  The planner prevents this by construction: it knows every
staleness value the run will produce (times never depend on training,
DESIGN.md §3), so it places each edge in a gap at least ``2 * margin``
wide, where ``margin`` bounds the f32 time error the engines' divergence
guards already enforce.  The f64 replay and the f32 device loop then
produce identical histograms.

Pure f64 numpy, a copy of ``repro``'s: the edges must be equal bit for bit
on both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# default staleness-histogram bin count (small and fixed: the histogram is
# device state of a static shape)
DEFAULT_BINS = 8


@dataclass(frozen=True)
class MetricsSpec:
    """Everything static the device loops need about metrics.

    ``edges`` are the *interior* staleness-bin boundaries (``n_bins =
    len(edges) + 1`` bins, open-ended on both sides), pre-rounded to f32 so
    the device and the f64 replay bucket against bit-identical constants.
    ``n_rsus`` sizes the per-RSU axes of the corridor channels;
    ``ring_guard`` arms the bf16 snapshot-ring finiteness / overflow
    counters; ``fault_counters`` the i32[4] fault counters (dropped,
    blackout, partial, discarded) when a fault model is on."""
    enabled: bool = True
    edges: tuple = ()
    n_rsus: int = 1
    ring_guard: bool = False
    fault_counters: bool = False

    @property
    def n_bins(self) -> int:
        return len(self.edges) + 1

    def to_json(self) -> dict:
        return {"enabled": self.enabled, "edges": list(self.edges),
                "n_bins": self.n_bins, "n_rsus": self.n_rsus,
                "ring_guard": self.ring_guard,
                "fault_counters": self.fault_counters}


def _f32(x: float) -> float:
    """Round to the nearest f32 value (kept as a Python float): the device
    compares staleness against exactly this constant."""
    # repro-check: waive[PLN002] edges are deliberately f32-rounded so the device and the f64 replay bucket against bit-identical constants
    return float(np.float32(x))


def stale_margin(times: np.ndarray) -> float:
    """Upper bound on |f32 staleness - f64 staleness| for this timeline.

    Staleness is ``t - dl_t`` with both carried in f32 on the device; the
    engines' divergence guards pin device times to the host dry run at
    ``rtol=1e-4, atol=1e-3``, so the staleness error is bounded by twice
    that envelope at the largest time in the run."""
    t_max = float(np.max(times)) if len(times) else 0.0
    return 2.0 * (1e-3 + 1e-4 * abs(t_max))


def plan_stale_edges(stale: np.ndarray, times: np.ndarray,
                     n_bins: int = DEFAULT_BINS) -> tuple:
    """Quantile-ish interior bin edges with every edge at least
    ``stale_margin`` away from every planned staleness sample.

    For each target quantile the candidate edge is the midpoint of the gap
    between the two neighbouring sorted samples; if that gap is too narrow
    the search walks outward to the nearest gap wide enough.  Degenerate
    timelines (all staleness equal) yield fewer bins."""
    s = np.sort(np.asarray(stale, np.float64))
    m = len(s)
    if m < 2 or n_bins < 2:
        return ()
    margin = stale_margin(times)
    edges: list[float] = []
    for j in range(1, n_bins):
        q = min(max(int(round(j * m / n_bins)), 1), m - 1)
        e = _safe_edge(s, q, margin)
        if e is not None and (not edges or e > edges[-1] + 2 * margin):
            edges.append(e)
    return tuple(_f32(e) for e in edges)


def _safe_edge(s: np.ndarray, q: int, margin: float) -> Optional[float]:
    """Midpoint of the nearest inter-sample gap wider than 2*margin,
    searching outward from the gap below ``s[q]``."""
    m = len(s)
    for d in range(m):
        for qq in (q + d, q - d):
            if 1 <= qq <= m - 1 and s[qq] - s[qq - 1] > 2.0 * margin:
                return (s[qq] + s[qq - 1]) / 2.0
    return None


def bucket_indices(edges, stale: np.ndarray) -> np.ndarray:
    """f64 reference bucketing: ``np.searchsorted`` against the same
    f32-rounded edges the device uses (``torch.searchsorted`` with
    ``right=False``, numpy's 'left' side)."""
    return np.searchsorted(np.asarray(edges, np.float64),
                           np.asarray(stale, np.float64))


def stale_histogram(edges, stale: np.ndarray,
                    rsu: Optional[np.ndarray] = None,
                    n_rsus: int = 1) -> np.ndarray:
    """f64 reference staleness histogram: ``[n_bins]``, or ``[n_rsus,
    n_bins]`` when per-upload serving RSUs are given."""
    n_bins = len(edges) + 1
    idx = bucket_indices(edges, stale)
    if rsu is None:
        return np.bincount(idx, minlength=n_bins).astype(np.int64)
    out = np.zeros((n_rsus, n_bins), np.int64)
    np.add.at(out, (np.asarray(rsu, np.int64), idx), 1)
    return out


# ---------------------------------------------------------------------------
# engine-facing normalization
# ---------------------------------------------------------------------------
def metrics_requested(metrics) -> bool:
    """True iff the engines' ``metrics`` argument asks for collection.
    None, False, "off" and a disabled spec are the path without telemetry;
    True, "on" and an enabled spec ask for it; anything else raises
    ``ValueError``."""
    if metrics is None or metrics is False or metrics == "off":
        return False
    if isinstance(metrics, MetricsSpec):
        return metrics.enabled
    if metrics is True or metrics == "on":
        return True
    raise ValueError(
        f"unknown metrics setting {metrics!r}: expected None/'off', "
        "'on'/True, or a MetricsSpec")


def resolve_metrics(metrics, *, stale, times, n_rsus: int = 1,
                    ring_guard: bool = False,
                    n_bins: int = DEFAULT_BINS,
                    fault_counters: bool = False) -> Optional[MetricsSpec]:
    """Normalize the engines' ``metrics`` argument into a MetricsSpec, or
    None for the path without telemetry.  ``stale``/``times`` are the host
    dry run's f64 per-round staleness and pop times, from which the
    planner derives safe histogram edges.  ``fault_counters`` arms the
    fault channels when the run carries a fault model."""
    if not metrics_requested(metrics):
        return None
    if isinstance(metrics, MetricsSpec):
        return metrics
    return MetricsSpec(enabled=True,
                       edges=plan_stale_edges(stale, times, n_bins),
                       n_rsus=n_rsus, ring_guard=ring_guard,
                       fault_counters=fault_counters)
