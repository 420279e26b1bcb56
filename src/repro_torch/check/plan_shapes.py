"""PLN003 probe: plan tables must be shape- and dtype-stable across seeds.
The ``plan_fleet`` part of ``repro.check.plan_shapes``.

A multi-world engine stacks the plans of many seeds, so a planner that
emitted a seed-dependent shape (a ragged table, a pruned slot array) could
never batch them.  This probe runs the planner twice with different seeds
on a small fleet and diffs the ndarray fields' ``(shape, dtype)``
signatures.

The same holds for ``plan_corridor``, for the padded tables of
``CorridorPlan.tables()`` and for the selection plan's ``[rounds, K]``
admission tables (``SelectionPlan.tables``), whose ragged ``boundaries``
source is exactly the kind of data that drifts.  Exempt by design, as in
``repro``: ``waves`` is a host-side tuple whose length legitimately varies
by seed (the engine walks it on the host), and ``n_slots`` is a Python int
sizing the gain table.  The fault plans' padded tables and their
``i32[rounds, 4]`` counter rows are held the same way under FLT001, for the
fleet and the corridor planner.  The sweep part of ``repro``'s probe waits
for the port's item 11.

FLT001's faults-off probe (:func:`probe_faults_off`) runs here too:
``resolve_faults`` must collapse every off spelling to ``None`` and a
faults-off ``plan_fleet`` / ``plan_corridor`` must carry ``flt=None``, so
the engines build no fault table.  ``repro``'s probe also holds the
program cache's executable object identical across the off spellings; the
port stages no program and keeps no cache, so that half has no subject.
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


def _diff(name: str, sigs: dict, findings: list, path: str,
          rule: str = "PLN003") -> None:
    base_seed = _PROBE_SEEDS[0]
    base = sigs[base_seed]
    for seed, sig in sigs.items():
        if seed == base_seed:
            continue
        for field in sorted(set(base) | set(sig)):
            a, b = base.get(field), sig.get(field)
            if a != b:
                findings.append(Finding(
                    rule, path, 0,
                    f"{name}: field {field!r} unstable across seeds "
                    f"(seed {base_seed}: {a}, seed {seed}: {b})"))


def _tables_signature(tabs: dict) -> dict:
    return {f"tables[{k}]": (np.asarray(v).shape, str(np.asarray(v).dtype))
            for k, v in tabs.items()}


def probe_plan_shapes() -> list[Finding]:
    """Run ``plan_fleet`` and ``plan_corridor`` across the probe seeds;
    findings on any layout drift."""
    from repro_torch.channel import ChannelParams
    from repro_torch.core.jit_engine import plan_fleet
    from repro_torch.corridor.plan import plan_corridor
    from repro_torch.selection import SelectionSpec

    findings: list[Finding] = []
    p = dataclasses.replace(ChannelParams(), K=5)
    sigs = {s: _signature(plan_fleet(p, seed=s, rounds=12))
            for s in _PROBE_SEEDS}
    _diff("plan_fleet", sigs, findings, "<probe:plan_fleet>")

    plans = {s: plan_corridor(p, n_rsus=2, seed=s, rounds=12)
             for s in _PROBE_SEEDS}
    sigs = {s: _signature(plan) for s, plan in plans.items()}
    _diff("plan_corridor", sigs, findings, "<probe:plan_corridor>")
    sigs = {s: _tables_signature(plan.tables()) for s, plan in plans.items()}
    _diff("CorridorPlan.tables", sigs, findings, "<probe:plan_corridor>")

    spec = SelectionSpec(policy="weighted-topk", k=3, resel_every=4)
    sigs = {s: _tables_signature(
        plan_fleet(p, seed=s, rounds=12, selection=spec).sel.tables(12))
        for s in _PROBE_SEEDS}
    _diff("SelectionPlan.tables", sigs, findings, "<probe:selection>")

    # fault-table shape stability (FLT001): the padded fault tables and the
    # counter rows depend only on (rounds, K, l_iters), never on the seed
    from repro_torch.faults import named_profile
    fspec = named_profile("flaky")

    def _fault_sig(flt_plan, rounds, l_iters):
        ct = flt_plan.counts_table(l_iters)
        return {**_tables_signature(flt_plan.tables(rounds)),
                "counts_table": (ct.shape, str(ct.dtype))}

    sigs = {s: _fault_sig(
        plan_fleet(p, seed=s, rounds=12, faults=fspec, l_iters=2).flt,
        12, 2) for s in _PROBE_SEEDS}
    _diff("FaultPlan.tables (fleet)", sigs, findings,
          "<probe:fault_tables>", rule="FLT001")
    sigs = {s: _fault_sig(
        plan_corridor(p, n_rsus=2, seed=s, rounds=12, faults=fspec,
                      reconcile_every=4).flt, 12, 1)
        for s in _PROBE_SEEDS}
    _diff("FaultPlan.tables (corridor)", sigs, findings,
          "<probe:fault_tables>", rule="FLT001")
    return findings + probe_faults_off()


def probe_faults_off() -> list[Finding]:
    """FLT001's off path: every falsy or no-op ``faults`` spelling resolves
    to ``None``, a faults-off plan carries ``flt=None`` on both planners,
    and a live profile does not."""
    from repro_torch.channel import ChannelParams
    from repro_torch.core.jit_engine import plan_fleet
    from repro_torch.corridor.plan import plan_corridor
    from repro_torch.faults import FaultSpec, resolve_faults

    findings: list[Finding] = []
    for falsy in (None, False, "off", "none", "", FaultSpec(),
                  FaultSpec(straggler_frac=0.5, straggler_mult=1.0)):
        if resolve_faults(falsy) is not None:
            findings.append(Finding(
                "FLT001", "<probe:faults-off-resolve>", 0,
                f"resolve_faults({falsy!r}) did not return None — the "
                "falsy/no-op path must carry zero fault state"))
    p = dataclasses.replace(ChannelParams(), K=5)
    planners = {
        "plan_fleet": lambda f: plan_fleet(p, 0, 6, faults=f, l_iters=1),
        "plan_corridor": lambda f: plan_corridor(p, 2, 0, 6, faults=f,
                                                 reconcile_every=3),
    }
    for name, plan in planners.items():
        for off in (None, "off", FaultSpec()):
            if plan(off).flt is not None:
                findings.append(Finding(
                    "FLT001", f"<probe:faults-off-{name}>", 0,
                    f"{name}(faults={off!r}) carries a fault plan: the "
                    "engines would fold fault tables into a run without "
                    "faults"))
        if plan("flaky").flt is None:
            findings.append(Finding(
                "FLT001", f"<probe:faults-off-{name}>", 0,
                f"{name}(faults='flaky') carries no fault plan"))
    return findings
