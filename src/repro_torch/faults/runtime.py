"""Composition of the admission layers with the event timeline:
``repro.faults.runtime``'s three helpers, which every engine drives
selection through.

- :func:`initial_vehicles` — who is scheduled at t = 0;
- :func:`arrival_step` — one consumed arrival: re-schedule under the mask
  or park, then the boundary's re-admissions;
- :func:`fold_readmits` — the ``{boundary: [vehicle, ...]}`` map the device
  engines write into their queues between pops.

Each takes a fault state ``flt`` beside the selection state ``sel``.  The
port has no fault models yet: every caller passes ``flt=None``, a fault
state raises here, and the engines raise for a fault profile before they
get this far.
"""
from __future__ import annotations


def _no_faults(flt) -> None:
    if flt is not None:
        raise NotImplementedError(
            "a fault state is not ported yet; it arrives with the port's "
            "faults (item 9) slice (ROADMAP.md, queue 1)")


def initial_vehicles(sel, flt, K: int) -> list:
    """Vehicles to schedule at t=0 under the selection mask,
    index-ascending (every vehicle without selection)."""
    _no_faults(flt)
    return list(range(K)) if sel is None else sel.initial_vehicles()


def arrival_step(sel, flt, *, r: int, vehicle: int, time: float,
                 upload_delay: float, train_delay: float, pending: int,
                 schedule, readmit=None) -> None:
    """The selection re-scheduling composition for one consumed arrival.
    The caller pops, aggregates, then calls this.

    ``schedule(v)`` re-enters vehicle ``v``'s next cycle at ``time``;
    ``readmit(v)`` (default ``schedule``) additionally does the caller's
    boundary bookkeeping (the planners' ``last_pop[v] = r``).  ``pending``
    is the in-flight upload count *after* this pop; only the fault gate
    reads it."""
    _no_faults(flt)
    if readmit is None:
        readmit = schedule
    if sel is None or sel.on_arrival(vehicle, upload_delay, train_delay):
        schedule(vehicle)
    if sel is not None:
        for v in sel.maybe_reselect(r + 1, time):
            readmit(v)


def fold_readmits(sel_plan, flt_plan) -> dict:
    """The selection re-admissions as one ``{boundary: [vehicle, ...]}``
    map for the engines' readmit fold."""
    _no_faults(flt_plan)
    if sel_plan is None:
        return {}
    return {b: list(newly) for b, newly, _ in sel_plan.boundaries if newly}
