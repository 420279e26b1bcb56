"""The serial multi-RSU handover loop: ``repro.corridor.reference``, the
executable specification the device corridor engine is held against.

One heap pop, one local update and one cohort merge per arrival, with a
periodic cross-RSU reconcile; it pays Python dispatch per event.  The
timeline is host f64 (``_Timeline`` with the corridor geometry); training,
the merges, the reconcile and eval run on ``device``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.channel import ChannelParams, CorridorMobility
from repro_torch.core.client import Vehicle
from repro_torch.core.hierarchical import ema_toward, reconcile_models
from repro_torch.core.mafl import SimResult, _Timeline, evaluate, host_report
from repro_torch.core.server import RSUServer
from repro_torch.device import resolve_device
from repro_torch.faults import (arrival_step, check_faults_reconcile,
                                initial_vehicles, make_fault_state)
from repro_torch.models.cnn import init_cnn
from repro_torch.selection import (check_reconcile_mode, make_selection_state,
                                   scenario_spec)
from repro_torch.telemetry import PhaseTimers, metrics_requested


def run_handover_simulation(sc, vehicles_data: Sequence,
                            test_images, test_labels, p: ChannelParams,
                            *, seed: int = 0, eval_every: int = 10,
                            interpretation: str = "mixing",
                            use_kernel: bool = False,
                            batch_size: int = 128,
                            progress=None, selection=None, metrics=None,
                            faults=None, init_params=None, device=None):
    """Multi-RSU MAFL with handover.

    Each RSU keeps its own cohort model and applies the paper's
    per-arrival aggregation; a vehicle downloads from the RSU serving its
    position at download time and uploads to the RSU serving it at arrival
    time.  Every ``sc.reconcile_every`` arrivals the cohorts are
    reconciled: FedAvg (``sc.reconcile_mode == "fedavg"``: all adopt the
    mean) or EMA (``"ema"``: each moves ``sc.reconcile_tau`` toward it).
    Evals read the consensus (the mean of the cohorts).

    ``sc`` is any object with the Scenario fields this reads (scheme,
    rounds, l_iters, lr, n_rsus, reconcile_every, reconcile_mode,
    reconcile_tau, corridor_entry, selection fields).  ``selection`` (or
    the scenario's policy) parks unadmitted vehicles at re-schedule and
    re-scores at every reconcile boundary; it raises ``ValueError`` with
    the EMA reconcile, and ``result.report.selection`` holds the plan's
    ``summary()``.  ``faults`` drives one ``FaultState`` with recovery
    sweeps at the reconcile boundaries: a cap-discarded arrival counts its
    round but leaves its cohort as it is, a partial cycle trains its
    first ``n_ep`` steps; ``result.extras["faults"]`` holds the plan's
    ``summary(sc.l_iters)`` and ``result.report.faults`` its spec and
    counts; faults that suppress re-schedules raise ``ValueError`` with
    the EMA reconcile.  ``init_params`` is a param dict (e.g. ``repro``'s
    init through :func:`repro_torch.convert.params_from_jax`); without it
    the model is drawn by :func:`init_cnn` from a generator seeded with
    ``seed``.  ``use_kernel`` routes every mafl merge through
    ``weighted_agg`` (the reconcile stays plain, as in ``repro``).
    ``device=None`` runs on the card.

    ``metrics`` (None/False/"off" | True/"on" | ``MetricsSpec``): on, the
    loop records the channels in f64 beside it, with the per-RSU
    occupancy, the serving RSU of each upload and the handover flag of
    each admitted re-schedule.  ``result.report`` (engine ``"serial"``,
    scheme ``"<scheme>+handover"``) is attached either way."""
    mode = getattr(sc, "reconcile_mode", "fedavg")
    spec = selection if selection is not None else scenario_spec(sc)
    check_reconcile_mode(spec, mode)
    check_faults_reconcile(faults, mode)
    met_req = metrics_requested(metrics)
    device = resolve_device(device)
    tau = getattr(sc, "reconcile_tau", 0.5)
    entry = getattr(sc, "corridor_entry", "uniform")
    if init_params is None:
        init_params = init_cnn(torch.Generator().manual_seed(seed),
                               device=device)

    servers = [RSUServer(init_params, p, scheme=sc.scheme,
                         use_kernel=use_kernel,
                         interpretation=interpretation, device=device)
               for _ in range(sc.n_rsus)]
    corridor = CorridorMobility(p, sc.n_rsus, entry=entry)
    # selection re-scores at every reconcile boundary (handed-over vehicles
    # by their new RSU)
    sel = make_selection_state(spec, p, corridor, seed, sc.rounds,
                               resel_every=sc.reconcile_every)
    # fault recovery sweeps follow the reconcile cadence, like selection
    flt = make_fault_state(faults, p, seed, sc.rounds, sc.l_iters,
                           recheck_every=sc.reconcile_every)
    partial = flt is not None and flt.spec.has_partial
    # the single-RSU scheduling rules; only the geometry (distance to the
    # serving RSU) differs
    timeline = _Timeline(p, seed, distance_fn=corridor.distance,
                         cl_scale=None if flt is None else flt.cl_scale)
    queue = timeline.queue
    fleet_batch = min(batch_size, min(d.size for d in vehicles_data))
    clients = [Vehicle(d, lr=sc.lr, batch_size=fleet_batch, seed=seed,
                       device=device) for d in vehicles_data]
    test_images = torch.as_tensor(test_images, device=device)
    test_labels = torch.as_tensor(test_labels, device=device)

    def schedule(vehicle: int, t_download: float):
        rsu = int(corridor.serving_rsu(vehicle, t_download))
        return timeline.schedule(vehicle, t_download,
                                 payload=servers[rsu].global_params)

    for k in initial_vehicles(sel, flt, p.K):
        schedule(k, 0.0)

    timers = PhaseTimers()
    ch_stale, ch_occ, ch_gap, ch_times = [], [], [], []
    ch_rsu, ch_ho = [], []

    result = SimResult(scheme=f"{sc.scheme}+handover", rounds=[],
                       acc_history=[], loss_history=[])
    total = 0
    with timers.phase("run"):
        while total < sc.rounds and len(queue):
            if met_req:
                # per-RSU live slots before the pop: a pending slot's row
                # is the RSU serving its vehicle at arrival time (the
                # device's slot-migration rule)
                pend = list(queue.pending())
                vs = np.array([pe.vehicle for pe in pend], np.int64)
                ts = np.array([pe.time for pe in pend])
                ch_occ.append(np.bincount(
                    np.asarray(corridor.serving_rsu(vs, ts), np.int64),
                    minlength=sc.n_rsus))
            ev = queue.pop()
            # the staleness-cap verdict and this cycle's epoch count,
            # fixed before the gate in arrival_step draws the next
            # cycle's block
            keep = True if flt is None else flt.on_pop(ev.vehicle,
                                                        total)[0]
            local_params, _ = clients[ev.vehicle].local_update(
                ev.payload, sc.l_iters,
                n_ep=flt.epoch_of(ev.vehicle) if partial else None)
            # handover target
            rsu = int(corridor.serving_rsu(ev.vehicle, ev.time))
            if met_req:
                ch_stale.append(ev.time - ev.download_time)
                ch_gap.append(ev.time - (ch_times[-1] if ch_times else 0.0))
                ch_times.append(ev.time)
                ch_rsu.append(rsu)
            rec = servers[rsu].receive(
                local_params, time=ev.time, vehicle=ev.vehicle,
                upload_delay=ev.upload_delay, train_delay=ev.train_delay,
                download_time=ev.download_time, discard=not keep)
            rec.rsu = rsu
            total += 1
            consensus = None
            if total % sc.reconcile_every == 0:
                consensus = reconcile_models(
                    [s.global_params for s in servers])
                if mode == "ema":
                    for s in servers:
                        s.global_params = ema_toward(s.global_params,
                                                     consensus, tau)
                else:
                    for s in servers:
                        s.global_params = consensus
            if total % eval_every == 0 or total == sc.rounds:
                if consensus is None or mode == "ema":
                    consensus = reconcile_models(
                        [s.global_params for s in servers])
                with timers.phase("eval"):
                    acc, loss = evaluate(consensus, test_images, test_labels,
                                         device=device)
                rec.accuracy, rec.loss = acc, loss
                result.acc_history.append((total, acc))
                result.loss_history.append((total, loss))
                if progress:
                    progress(total, acc)
            result.rounds.append(rec)
            # the re-download reads the post-reconcile cohort of the RSU
            # the upload landed on; selection parks unadmitted vehicles,
            # faults park dropped and dark ones, and both re-admit at
            # reconcile boundaries
            res = {}
            arrival_step(sel, flt, r=total - 1, vehicle=ev.vehicle,
                         time=ev.time, upload_delay=ev.upload_delay,
                         train_delay=ev.train_delay, pending=len(queue),
                         schedule=lambda v, t=ev.time: res.__setitem__(
                             "nev", schedule(v, t)),
                         readmit=lambda v, t=ev.time: schedule(v, t))
            if met_req:
                # a handover: the admitted re-schedule lands on another
                # RSU (a parked vehicle and a re-admission never count)
                nev = res.get("nev")
                ch_ho.append(nev is not None and int(
                    corridor.serving_rsu(ev.vehicle, nev.time)) != rsu)
            timeline.prune()

    result.final_params = reconcile_models([s.global_params for s in servers])
    flt_plan = None if flt is None else flt.plan()
    if flt_plan is not None:
        result.extras["faults"] = flt_plan.summary(sc.l_iters)
    up_rsu = np.asarray(ch_rsu, np.int64)
    ho = np.asarray(ch_ho, bool)
    result.report = host_report(
        engine="serial", scheme=f"{sc.scheme}+handover", rounds=total,
        seed=seed, metrics=metrics, met_req=met_req, p=p, timers=timers,
        device=device,
        selection=None if sel is None else sel.plan().summary(),
        records=result.rounds, stale=ch_stale, occ=ch_occ, gap=ch_gap,
        times=ch_times, n_rsus=sc.n_rsus,
        up_rsu=up_rsu if met_req else None,
        handover=ho if met_req else None,
        handover_count=(np.bincount(up_rsu[ho], minlength=sc.n_rsus)
                        if met_req else None),
        faults=flt_plan, l_iters=sc.l_iters)
    return result
