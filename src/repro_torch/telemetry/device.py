"""Device-side metrics accumulators: ``repro.telemetry.device`` for the port
(DESIGN.md §14).

Fixed-shape counter tensors on the device, updated in place by the engines'
event loops; nothing here reads a value back to the host.  The engines
build this state only when metrics are on, so the off path launches none
of these ops (rule TEL001).

State (:class:`MetricsState`):

- fleet (``engine="jit"``): ``hist i32[B]``, ``prev_t f32[1]``
- corridor: ``hist i32[R, B]``, ``prev_t f32[1]``, ``handover i32[R]``
- either, under a fault model: ``faults i32[4]`` (dropped, blackout,
  partial, discarded), fed per pop from the fault plan's counts table.

The per-pop channels (occupancy, argmin-pop wait, handover flag) are
one-element tensors the engines append to each pop's trace columns and
concatenate once per segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class MetricsState:
    """One run's metrics tensors on the device.  ``edges`` is the spec's
    f32 bin edges, copied to the device once; ``one`` the i32 increment
    every histogram fold adds."""
    edges: torch.Tensor
    hist: torch.Tensor
    prev_t: torch.Tensor
    one: torch.Tensor
    handover: Optional[torch.Tensor] = None
    faults: Optional[torch.Tensor] = None


def _state(spec, device, hist_shape, handover) -> MetricsState:
    i32 = torch.int32
    return MetricsState(
        edges=torch.tensor(spec.edges, dtype=torch.float32, device=device),
        hist=torch.zeros(hist_shape, dtype=i32, device=device),
        prev_t=torch.zeros(1, dtype=torch.float32, device=device),
        one=torch.ones(1, dtype=i32, device=device),
        handover=(torch.zeros(spec.n_rsus, dtype=i32, device=device)
                  if handover else None),
        faults=(torch.zeros(4, dtype=i32, device=device)
                if spec.fault_counters else None))


def fleet_state(spec, device) -> MetricsState:
    """Initial metrics state of the fleet engine.  When the spec arms
    ``fault_counters`` the state gains the ``i32[4]`` fault accumulator."""
    return _state(spec, device, spec.n_bins, handover=False)


def corridor_state(spec, device) -> MetricsState:
    """Initial metrics state of the corridor engine: a per-RSU histogram
    and handover counter."""
    return _state(spec, device, (spec.n_rsus, spec.n_bins), handover=True)


def stale_bin(edges, stale):
    """Bucket f32 staleness values against the edges: ``searchsorted`` on
    the left side, the f64 replay's ``np.searchsorted`` rule (the planner
    placed every edge a safe margin away from every sample, so both sides
    agree exactly)."""
    return torch.searchsorted(edges, stale, right=False)


def _fold(mst: MetricsState, t, fault_row):
    """The part of a pop's fold every engine shares: the fault row, and the
    pop's wait since the previous pop (``prev_t`` then becomes ``t``)."""
    if mst.faults is not None:
        mst.faults.add_(fault_row)
    gap = t - mst.prev_t
    mst.prev_t.copy_(t)
    return gap


def fleet_pop(mst: MetricsState, *, t, dl_t, fault_row=None):
    """Fold one pop (``t``, ``dl_t``: one-element f32 tensors) into the
    fleet state; returns the pop's wait ``f32[1]``.  ``fault_row`` is the
    pop's ``i32[4]`` fault-counter increment (required iff the state holds
    the fault accumulator)."""
    mst.hist.index_add_(0, stale_bin(mst.edges, t - dl_t), mst.one)
    return _fold(mst, t, fault_row)


def corridor_pop(mst: MetricsState, *, t, dl_t, j, handover,
                 fault_row=None):
    """Fold one pop into the corridor state: histogram row ``j`` (the RSU
    the upload landed on; ``j`` an index tensor of one element) and the
    handover flag (bool ``[1]``) counted at that source row.  Returns the
    pop's wait."""
    n_bins = mst.hist.shape[1]
    mst.hist.view(-1).index_add_(
        0, j * n_bins + stale_bin(mst.edges, t - dl_t), mst.one)
    mst.handover.index_add_(0, j, handover.to(torch.int32))
    return _fold(mst, t, fault_row)


class RingStats:
    """The bf16 snapshot-ring guard counters (DESIGN.md §12/§14).

    Wraps the engines' ``store``: every row stored to the ring is scanned
    for non-finite values (bf16 overflow saturates to inf) and folded into
    running device counters, in place."""

    def __init__(self, device):
        self.nonfinite = torch.zeros((), dtype=torch.int32, device=device)
        self.max_abs = torch.zeros((), dtype=torch.float32, device=device)

    def count(self, y):
        """Fold one stored row ``y`` into the counters."""
        f = y.float()
        finite = torch.isfinite(f)
        self.nonfinite.add_((~finite).sum())
        torch.maximum(self.max_abs,
                      torch.where(finite, f.abs(), 0.0).max(),
                      out=self.max_abs)

    def wrap(self, store):
        def wrapped(x):
            y = store(x)
            self.count(y)
            return y
        return wrapped

    def out(self) -> dict:
        return {"ring_nonfinite": self.nonfinite,
                "ring_max_abs": self.max_abs}
