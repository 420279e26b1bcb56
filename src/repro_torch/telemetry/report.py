"""Typed, versioned run reports: ``repro.telemetry.report`` for the port
(DESIGN.md §14), with ``repro``'s schema tag, so each package's reader
accepts the other's JSON lines.

Every engine attaches a :class:`RunReport` to ``SimResult.report``:

- identity: engine / scheme / rounds / seed (+ scenario name when run
  through ``run_scenario``),
- host instrumentation (always on): ``phases`` wall-clock seconds and
  ``memory`` peaks from :mod:`repro_torch.telemetry.timers`,
- plan statics: ``selection`` (the selection plan's summary), ``faults``
  (the fault spec and decision counts) and ``waves`` fill/utilization on
  the device engines,
- channels (``metrics="on"`` only): staleness histogram, occupancy and
  pop-wait traces, per-RSU handover counters, reward traces, bf16 ring
  guards, fault counters.

``channels`` values arrive as numpy arrays or tensors and become plain
lists at serialization time; ``from_json`` round-trips them as lists.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np
import torch

SCHEMA = "repro.telemetry/v1"


def _plain(x):
    """Recursively convert numpy scalars and arrays and torch tensors (on
    any device) to JSON-safe Python values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return _plain((x.float() if x.dtype == torch.bfloat16 else x)
                      .numpy().tolist())
    if hasattr(x, "tolist"):          # np.ndarray, np scalars
        return _plain(np.asarray(x).tolist())
    if isinstance(x, (np.floating, float)):
        return float(x)
    if isinstance(x, (np.integer, int)) and not isinstance(x, bool):
        return int(x)
    return x


@dataclass
class RunReport:
    """One run's structured telemetry record (schema
    ``repro.telemetry/v1``)."""
    engine: str = ""
    scheme: str = ""
    rounds: int = 0
    seed: int = 0
    scenario: Optional[str] = None
    metrics_on: bool = False
    spec: Optional[dict] = None          # MetricsSpec.to_json() when on
    phases: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)
    selection: Optional[dict] = None     # SelectionPlan.summary()
    faults: Optional[dict] = None        # fault spec + decision counts
    waves: Optional[dict] = None         # wave_stats() (device engines)
    channels: dict = field(default_factory=dict)
    schema: str = SCHEMA

    def to_json(self) -> dict:
        d = asdict(self)
        return {k: _plain(v) for k, v in d.items()}

    @classmethod
    def from_json(cls, d: dict) -> "RunReport":
        if d.get("schema") != SCHEMA:
            raise ValueError(
                f"unsupported run-report schema {d.get('schema')!r} "
                f"(this reader understands {SCHEMA})")
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


def wave_stats(waves, k: int) -> dict:
    """Fill/utilization statistics for a plan's wave partition.

    ``waves`` is the planner tuple ``((train_rounds, seg_start, seg_end),
    ...)``: each wave trains ``len(train_rounds)`` uploads together.  Fill
    is measured against the fleet size ``k`` (the widest batch a wave could
    ever form)."""
    sizes = [len(T) for T, _s, _e in waves]
    n = len(sizes)
    total = int(sum(sizes))
    return {
        "n_waves": n,
        "sizes": sizes,
        "total_trained": total,
        "mean_fill": (total / n) if n else 0.0,
        "max_fill": max(sizes) if sizes else 0,
        "utilization_vs_fleet": (total / (n * k)) if n and k else 0.0,
    }
