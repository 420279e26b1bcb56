"""PLN003 probe: plan tables must be shape- and dtype-stable across seeds.
The ``plan_fleet`` part of ``repro.check.plan_shapes``.

A multi-world engine stacks the plans of many seeds, so a planner that
emitted a seed-dependent shape (a ragged table, a pruned slot array) could
never batch them.  This probe runs the planner twice with different seeds
on a small fleet and diffs the ndarray fields' ``(shape, dtype)``
signatures.

Exempt by design, as in ``repro``: ``waves`` is a host-side tuple whose
length legitimately varies by seed (the engine walks it on the host), and
``n_slots`` is a Python int sizing the gain table.  The corridor, sweep,
selection and fault parts of ``repro``'s probe wait for the port's items 7,
11, 8 and 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.check.findings import Finding

_EXEMPT = ("waves", "n_slots", "sel", "sel_bandit", "q0", "flt")
_PROBE_SEEDS = (0, 1)


def _signature(plan) -> dict:
    sig = {}
    for f in dataclasses.fields(plan):
        if f.name in _EXEMPT:
            continue
        v = getattr(plan, f.name)
        if isinstance(v, np.ndarray):
            sig[f.name] = (v.shape, str(v.dtype))
        else:
            sig[f.name] = (type(v).__name__,)
    # q0 is a dict of per-vehicle arrays; check its members individually
    for k, v in plan.q0.items():
        sig[f"q0[{k}]"] = (v.shape, str(v.dtype))
    return sig


def _diff(name: str, sigs: dict, findings: list, path: str) -> None:
    base_seed = _PROBE_SEEDS[0]
    base = sigs[base_seed]
    for seed, sig in sigs.items():
        if seed == base_seed:
            continue
        for field in sorted(set(base) | set(sig)):
            a, b = base.get(field), sig.get(field)
            if a != b:
                findings.append(Finding(
                    "PLN003", path, 0,
                    f"{name}: field {field!r} unstable across seeds "
                    f"(seed {base_seed}: {a}, seed {seed}: {b})"))


def probe_plan_shapes() -> list[Finding]:
    """Run ``plan_fleet`` across the probe seeds; findings on any layout
    drift."""
    from repro_torch.channel import ChannelParams
    from repro_torch.core.jit_engine import plan_fleet

    findings: list[Finding] = []
    p = dataclasses.replace(ChannelParams(), K=5)
    sigs = {s: _signature(plan_fleet(p, seed=s, rounds=12))
            for s in _PROBE_SEEDS}
    _diff("plan_fleet", sigs, findings, "<probe:plan_fleet>")
    return findings
