"""TEL001 probe: ``metrics`` off must run the path without telemetry, op for
op.  The counterpart of ``repro.check.telemetry_off``.

Telemetry's contract (DESIGN.md §14) is that any falsy ``metrics`` setting
changes nothing: the engines resolve it to ``None`` and then build no
telemetry state and launch no extra op.  The probe holds both halves the
port has:

- the resolution half: ``resolve_metrics`` collapses every falsy spelling
  (None, False, "off", a disabled spec) to ``None``;
- the off-run half: on the CPU, under a ``TorchDispatchMode``, the fleet
  engine on quick-k5 and the corridor engine on corridor-quick-r2-k8 run a
  few rounds with no ``metrics``, with ``"off"`` and with ``"on"``.  The
  off run must dispatch exactly the aten op sequence of the run without
  ``metrics``; the on run must dispatch more ops (else the channels come
  from nowhere).

``repro``'s probe holds the program cache's executable object identical
instead of the op sequence; the port stages no program and keeps no
cache, so the op sequence of a real run stands in for it.  On a card the
``ring_agg`` chain is a ctypes launch the mode cannot see, which is why
the probe runs on the CPU, where every op passes through the dispatcher.
"""
from __future__ import annotations

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.check.findings import Finding

# (probe path, scenario, engine), each run for a few rounds of one local
# step with two evals
_RUNS = (
    ("<probe:telemetry-off-jit>", "quick-k5", "jit"),
    ("<probe:telemetry-off-corridor>", "corridor-quick-r2-k8", "corridor"),
)
_ROUNDS, _EVAL_EVERY = 6, 3


class OpSequence(TorchDispatchMode):
    """Records the name of every aten op dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _resolve_findings() -> list[Finding]:
    from repro_torch.telemetry.spec import MetricsSpec, resolve_metrics

    out = []
    stale = np.array([0.5, 1.0, 2.0])
    times = np.array([1.0, 2.0, 3.0])
    for falsy in (None, False, "off", MetricsSpec(enabled=False)):
        if resolve_metrics(falsy, stale=stale, times=times) is not None:
            out.append(Finding(
                "TEL001", "<probe:telemetry-off-resolve>", 0,
                f"resolve_metrics({falsy!r}) did not return None — the "
                "falsy path must carry zero telemetry state"))
    return out


def op_sequence(scenario: str, engine: str, metrics) -> list[str]:
    """The aten ops of one CPU run of ``scenario`` on ``engine``."""
    from repro_torch.core.scenarios import run_scenario

    with OpSequence() as rec:
        run_scenario(scenario, engine=engine, rounds=_ROUNDS, l_iters=1,
                     eval_every=_EVAL_EVERY, metrics=metrics, device="cpu")
    return rec.ops


def _run_findings() -> list[Finding]:
    out = []
    for path, scenario, engine in _RUNS:
        base = op_sequence(scenario, engine, None)
        off = op_sequence(scenario, engine, "off")
        on = op_sequence(scenario, engine, "on")
        if off != base:
            k = next((i for i, (a, b) in enumerate(zip(base, off))
                      if a != b), min(len(base), len(off)))
            out.append(Finding(
                "TEL001", path, 0,
                f"{engine} engine: metrics='off' dispatched {len(off)} ops "
                f"against {len(base)} without metrics, first difference at "
                f"op {k} ({base[k] if k < len(base) else 'end'} vs "
                f"{off[k] if k < len(off) else 'end'})"))
        if len(on) <= len(base):
            out.append(Finding(
                "TEL001", path, 0,
                f"{engine} engine: metrics='on' dispatched {len(on)} ops, "
                f"no more than the {len(base)} of the run without metrics"))
    return out


def probe_telemetry_off() -> list[Finding]:
    return _resolve_findings() + _run_findings()
