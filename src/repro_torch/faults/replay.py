"""f64 host replay of the fault decisions: ``repro.faults.replay`` for the
port (DESIGN.md §16).

The conformance oracle: re-drive the exact event timeline the planners
dry-run (``plan_fleet`` / ``plan_corridor`` — same ``_Timeline``, same
selection driving, same fault driving, same pop order) and return the
:class:`~repro_torch.faults.runtime.FaultPlan` every engine must
reproduce decision for decision: which pops were dropped or blacked out,
which survived the staleness cap, how many local epochs each cycle ran,
which recovery sweeps re-admitted whom, and every straggler multiplier.

Planner discipline applies (rule FLT001): everything here is pure f64
numpy over the host timeline — no torch, no device state, no engine
imports.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.channel import ChannelParams, CorridorMobility, Mobility
from repro_torch.faults.runtime import (FaultPlan, arrival_step,
                                        initial_vehicles, make_fault_state)
from repro_torch.selection import make_selection_state


def replay_fleet_faults(p: ChannelParams, seed: int, rounds: int,
                        faults, l_iters: int = 5,
                        selection=None) -> Optional[FaultPlan]:
    """Re-drive the single-RSU fleet timeline under ``faults`` and return
    the decision residue (None when faults resolve to off)."""
    from repro_torch.core.mafl import _Timeline

    flt = make_fault_state(faults, p, seed, rounds, l_iters)
    if flt is None:
        return None
    sel = make_selection_state(selection, p, Mobility(p), seed, rounds)
    tl = _Timeline(p, seed, cl_scale=flt.cl_scale)
    for k in initial_vehicles(sel, flt, p.K):
        tl.schedule(k, 0.0)

    for r in range(rounds):
        ev = tl.queue.pop()
        flt.on_pop(ev.vehicle, r)
        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: tl.schedule(v, t))
        tl.prune()
    return flt.plan()


def replay_corridor_faults(p: ChannelParams, n_rsus: int, seed: int,
                           rounds: int, faults, l_iters: int = 1,
                           entry: str = "uniform", selection=None,
                           reconcile_every: int = 0
                           ) -> Optional[FaultPlan]:
    """Re-drive the corridor timeline under ``faults``.  Recovery sweeps
    run at reconcile boundaries only (``reconcile_every=0`` disables
    them — recovered vehicles stay parked), mirroring selection."""
    from repro_torch.core.mafl import _Timeline

    flt = make_fault_state(faults, p, seed, rounds, l_iters,
                           recheck_every=reconcile_every)
    if flt is None:
        return None
    corridor = CorridorMobility(p, n_rsus, entry=entry)
    sel = make_selection_state(selection, p, corridor, seed, rounds,
                               resel_every=reconcile_every)
    tl = _Timeline(p, seed, distance_fn=corridor.distance,
                   cl_scale=flt.cl_scale)
    for k in initial_vehicles(sel, flt, p.K):
        tl.schedule(k, 0.0)

    for r in range(rounds):
        ev = tl.queue.pop()
        flt.on_pop(ev.vehicle, r)
        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: tl.schedule(v, t))
        tl.prune()
    return flt.plan()
