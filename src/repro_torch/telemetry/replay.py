"""f64 host replay of the telemetry channels: ``repro.telemetry.replay``
for the port (DESIGN.md §14).

The conformance oracle: re-drive the event timeline the planners dry-run
(``plan_fleet`` / ``plan_corridor``: the same ``_Timeline``, the same
selection and fault driving, the same pop order) while recording the
channel values the device accumulators must reproduce:

- ``stale[r]``      pop time minus download time (f64); binned through
                    :func:`repro_torch.telemetry.spec.stale_histogram` it
                    must equal the device histogram exactly,
- ``occupancy[r]``  live slots at the moment of pop ``r`` (the popped
                    upload included): the device's ``isfinite(qt)`` count,
- ``gap[r]``        argmin-pop wait ``times[r] - times[r-1]`` (f32 on the
                    device, so compared within the divergence-guard
                    tolerance),
- corridor only: per-RSU occupancy ``[M, R]``, the per-pop handover flag
  (the re-schedule lands on a different RSU than the upload arrived on)
  and its per-source-RSU count.

Pure f64 numpy over the host timeline (rule PLN002): no torch, no device
state.
"""
from __future__ import annotations

import numpy as np

from repro_torch.channel import ChannelParams, CorridorMobility, Mobility
from repro_torch.faults import (arrival_step, initial_vehicles,
                                make_fault_state)
from repro_torch.selection import make_selection_state


def replay_fleet_channels(p: ChannelParams, seed: int, rounds: int,
                          selection=None, faults=None,
                          l_iters: int = 5) -> dict:
    """Re-drive the single-RSU fleet timeline; returns the f64 channel
    record for ``rounds`` pops.  A fault model drives the same
    ``FaultState`` composition the engines replay."""
    from repro_torch.core.mafl import _Timeline

    sel = make_selection_state(selection, p, Mobility(p), seed, rounds)
    flt = make_fault_state(faults, p, seed, rounds, l_iters)
    tl = _Timeline(p, seed, cl_scale=None if flt is None else flt.cl_scale)
    for k in initial_vehicles(sel, flt, p.K):
        tl.schedule(k, 0.0)

    M = rounds
    veh = np.empty(M, np.int64)
    stale = np.empty(M)
    occ = np.empty(M, np.int64)
    gap = np.empty(M)
    times = np.empty(M)
    prev_t = 0.0
    for r in range(M):
        occ[r] = len(tl.queue)            # live slots incl. the pop itself
        ev = tl.queue.pop()
        veh[r] = ev.vehicle
        times[r] = ev.time
        stale[r] = ev.time - ev.download_time
        gap[r] = ev.time - prev_t
        prev_t = ev.time
        if flt is not None:
            flt.on_pop(ev.vehicle, r)
        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: tl.schedule(v, t))
        tl.prune()
    return {"veh": veh, "times": times, "stale": stale,
            "occupancy": occ, "gap": gap}


def replay_corridor_channels(p: ChannelParams, n_rsus: int, seed: int,
                             rounds: int, entry: str = "uniform",
                             selection=None,
                             reconcile_every: int = 0, faults=None,
                             l_iters: int = 1) -> dict:
    """Re-drive the corridor timeline; adds the per-RSU channels.

    A pending slot's RSU row is the cell serving the vehicle at *arrival*
    time (positions are pure in t, the rule the engine's slot migration
    follows), so per-RSU occupancy is computable from the pending events
    alone.  The handover flag marks an admitted re-schedule whose new
    arrival is served by a different RSU than the upload it follows; it is
    counted at the source RSU (a suppressed re-schedule and a boundary
    re-admission never count)."""
    from repro_torch.core.mafl import _Timeline

    corridor = CorridorMobility(p, n_rsus, entry=entry)
    sel = make_selection_state(selection, p, corridor, seed, rounds,
                               resel_every=reconcile_every)
    flt = make_fault_state(faults, p, seed, rounds, l_iters,
                           recheck_every=reconcile_every)
    tl = _Timeline(p, seed, distance_fn=corridor.distance,
                   cl_scale=None if flt is None else flt.cl_scale)
    for k in initial_vehicles(sel, flt, p.K):
        tl.schedule(k, 0.0)

    M = rounds
    R = n_rsus
    veh = np.empty(M, np.int64)
    stale = np.empty(M)
    occ = np.zeros((M, R), np.int64)
    gap = np.empty(M)
    times = np.empty(M)
    up_rsu = np.empty(M, np.int64)
    handover = np.zeros(M, bool)
    prev_t = 0.0
    for r in range(M):
        pend = list(tl.queue.pending())
        if pend:
            vs = np.array([pe.vehicle for pe in pend], np.int64)
            ts = np.array([pe.time for pe in pend])
            occ[r] = np.bincount(
                np.asarray(corridor.serving_rsu(vs, ts), np.int64),
                minlength=R)
        ev = tl.queue.pop()
        j = int(corridor.serving_rsu(ev.vehicle, ev.time))
        veh[r] = ev.vehicle
        times[r] = ev.time
        up_rsu[r] = j
        stale[r] = ev.time - ev.download_time
        gap[r] = ev.time - prev_t
        prev_t = ev.time
        if flt is not None:
            flt.on_pop(ev.vehicle, r)
        res = {}
        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: res.__setitem__(
                "nev", tl.schedule(v, t)),
            readmit=lambda v, t=ev.time: tl.schedule(v, t))
        nev = res.get("nev")
        if nev is not None:
            handover[r] = int(corridor.serving_rsu(ev.vehicle,
                                                   nev.time)) != j
        tl.prune()
    return {"veh": veh, "times": times, "stale": stale,
            "occupancy": occ, "gap": gap, "up_rsu": up_rsu,
            "handover": handover,
            "handover_count": np.bincount(up_rsu[handover], minlength=R)}
