"""Telemetry for the port: ``repro.telemetry`` (DESIGN.md §14) on torch.

- :mod:`repro_torch.telemetry.spec`: the host f64 planner side, a static
  :class:`MetricsSpec` (staleness-histogram edges a safe margin away from
  every planned sample, so f32 device values bucket identically).
- :mod:`repro_torch.telemetry.device`: the device side, fixed-shape counter
  and histogram tensors updated in place by the engines' event loops, and
  the bf16 snapshot-ring finiteness guard.  No host read in the loop.
- :mod:`repro_torch.telemetry.replay`: the f64 conformance oracle.
- :mod:`repro_torch.telemetry.timers`: host phase timers and memory peaks.
- :mod:`repro_torch.telemetry.report`: the :class:`RunReport` every engine
  attaches to ``SimResult.report`` (schema ``repro.telemetry/v1``).
- :mod:`repro_torch.telemetry.runlog`: JSONL run logs; ``python -m
  repro_torch.telemetry report|diff|run``.

The contract: any falsy ``metrics`` runs the path without telemetry, op
for op (``repro_torch.check`` rule TEL001).
"""
from repro_torch.telemetry.report import RunReport
from repro_torch.telemetry.spec import (MetricsSpec, metrics_requested,
                                        resolve_metrics)
from repro_torch.telemetry.timers import PhaseTimers, memory_stats

__all__ = ["MetricsSpec", "RunReport", "PhaseTimers", "memory_stats",
           "metrics_requested", "resolve_metrics"]
