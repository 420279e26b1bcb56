"""repro_torch.check: static invariant analyzers of the port, the
counterpart of ``repro.check`` (DESIGN.md §13).

- ``grid_race``: classifies every registered CUDA kernel's declared launch
  geometry (``kernels/*/ops.py:geometry``) as ``parallel-safe`` or
  ``racy``: does more than one block of a launch store to one element?
- ``boundary``: AST taint pass over device-loop code for host syncs
  (``.item()``, ``.cpu()``, Python branches and ``np.*`` on tensors, f64)
  and the planner duals (no engine imports, no mid-plan precision drops).
- ``dtype_flow`` / ``plan_shapes``: run probes: bf16 storage-only
  verification over a recorded fleet-engine run, and cross-seed plan-layout
  stability.
- ``telemetry_off``: rule TEL001, every falsy ``metrics`` spelling
  resolves to None and a metrics-off run dispatches the op sequence of the
  run without metrics.

CLI: ``python -m repro_torch.check src/repro_torch [--strict]
[--format=json] [--list-rules] [--no-probes]``.  Findings can be waived in
place with ``# repro-check: waive[RULE] reason``.
"""
from repro_torch.check.findings import RULES, Finding  # noqa: F401
