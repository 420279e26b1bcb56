"""Top-level MAFL simulation (Algorithm 1) — the paper's experiment engine.

Couples the channel/mobility simulator, the event-driven async scheduler, the
vehicle clients, and the RSU aggregation into ``run_simulation``.  The host
engines of ``repro.core.mafl`` share identical event semantics
(DESIGN.md §2-§3):

``engine="serial"`` (alias ``"unbatched"``)
    One event at a time, exactly Algorithm 1's arrival order.

``engine="batched"`` (default)
    Wave-based: every pending upload's payload snapshot is frozen at
    schedule time, so all pending local updates are mutually independent
    and train together — full ``wave_chunk``-sized slices as one vmapped
    step, remainders through the serial loop.  Aggregation still consumes
    events strictly in time order, so the (round, vehicle, time) sequence
    is identical to the serial engine's.

``engine="jit"``
    The device-resident fleet engine (``core/jit_engine.py``): an f32 slot
    queue on the card, wave-hoisted training and fused ``ring_agg`` chains
    over the packed flat layout, optionally with a bf16 ring.

The host engines' timeline is numpy f64 and never reads parameters; the
model, local training, aggregation and eval run on ``device``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.channel import (ChannelParams, Mobility, RayleighAR1,
                                 SlotGainCache, shannon_rate, training_delay,
                                 upload_delay)
from repro_torch.core.client import Vehicle, VehicleData, local_update_many
from repro_torch.core.events import EventQueue
from repro_torch.core.server import RSUServer
from repro_torch.device import resolve_device
from repro_torch.faults import (arrival_step, initial_vehicles,
                                make_fault_state)
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.selection import make_selection_state
from repro_torch.telemetry import (PhaseTimers, RunReport, memory_stats,
                                   metrics_requested, resolve_metrics)
from repro_torch.telemetry.spec import stale_histogram

# accepted run_simulation engine names ('unbatched' is a legacy alias for
# 'serial')
ENGINES = ("batched", "serial", "unbatched", "jit")


@dataclass
class SimResult:
    scheme: str
    rounds: list
    acc_history: list          # (round, accuracy)
    loss_history: list         # (round, loss)
    final_params: object = None
    extras: dict = field(default_factory=dict)
    # the run's RunReport (repro_torch.telemetry.report): phase timers,
    # memory and plan statics always; channels when metrics are on
    report: object = None

    def final_accuracy(self) -> float:
        return self.acc_history[-1][1] if self.acc_history else float("nan")


@torch.no_grad()
def _eval_step(params, images, labels, mask):
    """Masked per-batch eval: (#correct, summed NLL) over mask==1 rows."""
    logits = cnn_forward(params, images)
    correct = ((logits.argmax(-1) == labels).float() * mask).sum()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    return correct, (nll * mask).sum()


def evaluate(params, images, labels, batch: int = 1000, device=None):
    """Global-model metrics on the test set (Eqs. 1, 12).

    ``images`` / ``labels`` may be numpy arrays or tensors; they are moved
    to ``device`` (``None`` -> the card).  Every slice — including the
    ragged final one — is padded to exactly ``batch`` rows with the padding
    masked out of both metrics, as in ``repro.core.mafl.evaluate``;
    ``batch`` is capped at the test-set size."""
    device = resolve_device(device)
    images = torch.as_tensor(images, device=device)
    labels = torch.as_tensor(labels, device=device).long()
    n = len(labels)
    batch = max(min(batch, n), 1)
    correct = loss_sum = 0.0
    for s in range(0, n, batch):
        img, lab = images[s:s + batch], labels[s:s + batch]
        m = len(lab)
        if m < batch:
            pad = (batch - m,) + img.shape[1:]
            img = torch.cat([img, img.new_zeros(pad)])
            lab = torch.cat([lab, lab.new_zeros(batch - m)])
        mask = (torch.arange(batch, device=device) < m).float()
        c, l = _eval_step(params, img, lab, mask)
        correct += float(c)
        loss_sum += float(l)
    return correct / n, loss_sum / n


def run_simulation(
    vehicles_data: Sequence[VehicleData],
    test_images: np.ndarray,
    test_labels: np.ndarray,
    *,
    scheme: str = "mafl",
    rounds: int = 60,
    l_iters: int = 5,
    lr: float = 0.01,
    params: Optional[ChannelParams] = None,
    seed: int = 0,
    eval_every: int = 1,
    use_kernel: bool = False,
    init_params=None,
    interpretation: str = "mixing",
    progress: Optional[Callable[[int, float], None]] = None,
    engine: str = "batched",
    wave_chunk: int = 16,
    batch_size: int = 128,
    selection=None,
    flat: bool = True,
    ring_dtype: str = "f32",
    metrics=None,
    faults=None,
    device=None,
) -> SimResult:
    """Run M rounds of the chosen aggregation scheme (Algorithm 1).

    Every vehicle uses the same minibatch size — ``min(batch_size, min_i
    D_i)`` — as in ``repro`` (DESIGN.md §6).  ``init_params`` is a param
    dict (e.g. from :func:`repro_torch.convert.params_from_jax`); without
    it the model is drawn by :func:`init_cnn` from a generator seeded with
    ``seed``.  ``device=None`` runs on the card.

    ``engine="jit"`` runs the device fleet engine
    (:func:`repro_torch.core.jit_engine.run_simulation_jit`); ``flat``
    (``False``: its pytree program) and ``ring_dtype="bf16"`` reach it
    only.

    ``selection`` (None | policy name | ``SelectionSpec``) parks the
    vehicles a policy does not admit at (re-)schedule time and re-scores
    every ``spec.resel_every`` arrivals; ``result.report.selection`` holds
    the plan's ``summary()``.

    ``faults`` (None/"off" | profile name | ``FaultSpec``) injects
    seeded stochastic dropout, blackout, partial computation, straggler
    inflation and staleness-cap discard, decided by one host
    ``FaultState`` and identical decision for decision on every engine;
    ``result.extras["faults"]`` holds its plan's ``summary(l_iters)`` and
    ``result.report.faults`` its spec and counts.  Off is bitwise the run
    without faults.

    ``metrics`` (None/False/"off" | True/"on" | ``MetricsSpec``) asks for
    the telemetry channels (DESIGN.md §14): the host engines record them
    in f64 beside the event loop, the fleet engine on the card.  Every
    result carries a ``RunReport`` in ``result.report`` (phase timers,
    memory, plan statics; the channels when metrics are on).  Off is the
    path without telemetry; an unknown setting raises ``ValueError``."""
    if engine == "jit":
        from repro_torch.core.jit_engine import run_simulation_jit
        return run_simulation_jit(
            vehicles_data, test_images, test_labels, scheme=scheme,
            rounds=rounds, l_iters=l_iters, lr=lr, params=params, seed=seed,
            eval_every=eval_every, use_kernel=use_kernel,
            init_params=init_params, interpretation=interpretation,
            progress=progress, batch_size=batch_size, selection=selection,
            flat=flat, ring_dtype=ring_dtype, metrics=metrics,
            faults=faults, device=device)
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {ENGINES}")
    if ring_dtype != "f32":
        raise ValueError(
            f"ring_dtype={ring_dtype!r} requires engine='jit'; the host "
            "engines keep full-precision params")
    met_req = metrics_requested(metrics)
    device = resolve_device(device)
    p = params or ChannelParams()
    if len(vehicles_data) != p.K:
        raise ValueError(
            f"{len(vehicles_data)} vehicle shards for K={p.K} vehicles")
    if init_params is None:
        init_params = init_cnn(torch.Generator().manual_seed(seed),
                               device=device)

    timers = PhaseTimers()
    with timers.phase("stage"):
        server = RSUServer(init_params, p, scheme=scheme,
                           use_kernel=use_kernel,
                           interpretation=interpretation, device=device)
        fleet_batch = min(batch_size, min(d.size for d in vehicles_data))
        clients = [Vehicle(d, lr=lr, batch_size=fleet_batch, seed=seed,
                           device=device) for d in vehicles_data]
        test_images = torch.as_tensor(test_images, device=device)
        test_labels = torch.as_tensor(test_labels, device=device)
    # the host engines record the channels in f64 beside the event loop:
    # it sees every value the device accumulators fold
    ch_stale: list = []
    ch_occ: list = []
    ch_gap: list = []
    ch_times: list = []

    sel = make_selection_state(selection, p, Mobility(p), seed, rounds)
    flt = make_fault_state(faults, p, seed, rounds, l_iters)
    timeline = _Timeline(p, seed,
                         cl_scale=None if flt is None else flt.cl_scale)
    queue = timeline.queue
    # partial computation: each cycle's epoch count was fixed at its
    # schedule; all l_iters batches are still drawn (RNG alignment)
    partial = flt is not None and flt.spec.has_partial
    if engine == "batched":
        # The event timeline depends only on the channel/mobility/data-size
        # processes, never on training — so a time-only dry run tells us
        # *exactly* which (vehicle, cycle) uploads the M rounds consume, and
        # the wave engine trains nothing else.  The replay carries its own
        # SelectionState and FaultState, so admission and fault decisions
        # are reproduced exactly.
        with timers.phase("plan"):
            consumed = _consumed_events(p, seed, rounds, selection,
                                        faults=faults, l_iters=l_iters)

    def schedule(vehicle: int, t_download: float):
        timeline.schedule(vehicle, t_download, server.global_params)

    for k in initial_vehicles(sel, flt, p.K):
        schedule(k, 0.0)

    result = SimResult(scheme=scheme, rounds=[], acc_history=[],
                       loss_history=[])

    def consume(ev) -> None:
        """One arrival: aggregate in time order, eval, re-download (Fig. 2).

        ``ev.local_params`` must already hold the local update trained from
        the stale payload snapshot."""
        r = server.round                    # 0-based index of this pop
        if met_req:
            # the pop happened (+1) and the re-schedule has not: the
            # instant the device engines count isfinite slots at
            ch_occ.append(len(queue) + 1)
            ch_stale.append(ev.time - ev.download_time)
            ch_gap.append(ev.time - (ch_times[-1] if ch_times else 0.0))
            ch_times.append(ev.time)
        # staleness-cap verdict before aggregation: a discarded arrival
        # still counts as a round, only the model update is skipped
        keep = True if flt is None else flt.on_pop(ev.vehicle, r)[0]
        rec = server.receive(
            ev.local_params, time=ev.time, vehicle=ev.vehicle,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            download_time=ev.download_time, discard=not keep)
        ev.local_params = ev.payload = None
        if server.round % eval_every == 0 or server.round == rounds:
            with timers.phase("eval"):
                acc, loss = evaluate(server.global_params, test_images,
                                     test_labels, device=device)
            rec.accuracy, rec.loss = acc, loss
            result.acc_history.append((server.round, acc))
            result.loss_history.append((server.round, loss))
            if progress:
                progress(server.round, acc)
        # mask at schedule: the vehicle re-downloads the fresh global model
        # (Fig. 2) only while admitted and live; epoch boundaries re-score,
        # recovery sweeps wake dark vehicles whose blackout has passed
        arrival_step(sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
                     upload_delay=ev.upload_delay,
                     train_delay=ev.train_delay, pending=len(queue),
                     schedule=lambda v: schedule(v, ev.time))
        timeline.prune()

    if engine in ("serial", "unbatched"):
        with timers.phase("run"):
            while server.round < rounds and len(queue):
                ev = queue.pop()
                # local training from the model the vehicle downloaded (the
                # stale snapshot in the payload); the compute runs now, but
                # the ordering and delays follow the event times
                # (DESIGN.md §2)
                ev.local_params, _ = clients[ev.vehicle].local_update(
                    ev.payload, l_iters,
                    n_ep=flt.epoch_of(ev.vehicle) if partial else None)
                consume(ev)
    else:
        with timers.phase("run"):
            while server.round < rounds and len(queue):
                # Wave: train every pending upload that the dry run proved
                # will be consumed and whose result is missing.  Payload
                # snapshots are frozen at schedule time, so these trainings
                # are mutually independent and none is wasted.
                with timers.phase("wave"):
                    untrained = sorted(
                        (ev for ev in queue.pending()
                         if ev.local_params is None
                         and (ev.vehicle, ev.cycle) in consumed),
                        key=lambda ev: (ev.time, ev.seq))
                    batches = [clients[ev.vehicle].sample_batches(l_iters)
                               for ev in untrained]
                    n_eps = ([flt.epoch_of(ev.vehicle) for ev in untrained]
                             if partial else None)
                    outs, losses = local_update_many(
                        [ev.payload for ev in untrained], batches, lr,
                        chunk=wave_chunk, n_eps=n_eps)
                    for ev, out, lo in zip(untrained, outs, losses):
                        ev.local_params, ev.local_loss = out, lo
                # Drain in time order until an event without a precomputed
                # result (freshly re-scheduled) reaches the front —
                # identical arrival semantics to the serial engine.
                while (server.round < rounds and len(queue)
                       and queue.peek().local_params is not None):
                    consume(queue.pop())
                if (not untrained and server.round < rounds and len(queue)
                        and queue.peek().local_params is None):
                    # the dry run said the front event is never consumed,
                    # yet rounds remain — the timelines have diverged; fail
                    # loudly
                    raise RuntimeError(
                        "batched engine: dry-run consumed-set diverged "
                        f"from live timeline at round {server.round} "
                        f"(front event vehicle={queue.peek().vehicle} "
                        f"cycle={queue.peek().cycle})")

    result.rounds = server.rounds
    result.final_params = server.global_params
    flt_plan = None if flt is None else flt.plan()
    if flt_plan is not None:
        result.extras["faults"] = flt_plan.summary(l_iters)
    result.report = host_report(
        engine=engine, scheme=scheme, rounds=rounds, seed=seed,
        metrics=metrics, met_req=met_req, p=p, timers=timers,
        device=device,
        selection=None if sel is None else sel.plan().summary(),
        records=result.rounds, stale=ch_stale, occ=ch_occ, gap=ch_gap,
        times=ch_times, faults=flt_plan, l_iters=l_iters)
    return result


def fault_report(flt_plan, l_iters: int):
    """``RunReport.faults``: the fault spec and its decision counts (None
    without a fault model)."""
    if flt_plan is None:
        return None
    return {"spec": dataclasses.asdict(flt_plan.spec),
            "counts": flt_plan.counts(l_iters)}


def reward_channel(p: ChannelParams, cu, cl) -> np.ndarray:
    """The per-pop reward trace (the paper's delay weight, Eqs. 7, 9) in
    f64 from the recorded delays, published for every scheme."""
    return (p.gamma ** (np.asarray(cu, np.float64) - 1.0)
            * p.zeta ** (np.asarray(cl, np.float64) - 1.0))


def host_report(*, engine, scheme, rounds, seed, metrics, met_req, p,
                timers, device, selection, records, stale, occ, gap, times,
                n_rsus=1, up_rsu=None, handover=None, handover_count=None,
                faults=None, l_iters=1):
    """The host engines' :class:`RunReport` (``repro``'s ``_host_report``):
    f64 channels collected beside the event loop, bucketed through the
    planner's edges (identical by construction: the host values are the
    planner's replay)."""
    report = RunReport(engine=engine, scheme=scheme, rounds=rounds,
                       seed=seed, metrics_on=met_req,
                       phases=timers.snapshot(), memory=memory_stats(device),
                       selection=selection,
                       faults=fault_report(faults, l_iters))
    if met_req:
        st = np.asarray(stale)
        spec = resolve_metrics(metrics, stale=st, times=np.asarray(times),
                               n_rsus=n_rsus,
                               fault_counters=faults is not None)
        report.spec = spec.to_json()
        channels = {
            "stale_hist": stale_histogram(spec.edges, st, rsu=up_rsu,
                                          n_rsus=n_rsus),
            "occupancy": np.asarray(occ, np.int64),
            "gap": np.asarray(gap),
        }
        if records:
            channels["reward"] = reward_channel(
                p, [r.upload_delay for r in records],
                [r.train_delay for r in records])
        if handover is not None:
            channels["handover"] = np.asarray(handover, np.int64)
            channels["handover_count"] = np.asarray(handover_count,
                                                    np.int64)
        report.channels = channels
    return report


class _Timeline:
    """The event timeline: channel gains, mobility, and the pending-upload
    queue.  Times depend only on (params, seed) — never on training — so a
    payload-free instance replays the identical schedule (DESIGN.md §3).

    ``distance_fn(vehicle, t) -> meters`` defaults to the single-RSU
    :class:`Mobility`; the corridor planner and the serial handover loop
    substitute the corridor geometry and keep every other scheduling rule.

    Channel gains are sampled per discrete slot and kept only for the live
    event window (``SlotGainCache``).  ``cl_scale`` (f64 per vehicle, the
    fault model's straggler multipliers) scales the Eq. 8 training delay;
    None is the identity."""

    def __init__(self, p: ChannelParams, seed: int, distance_fn=None,
                 cl_scale=None):
        self.p = p
        self.distance = distance_fn or Mobility(p).distance
        self.gains = SlotGainCache(RayleighAR1(p, seed=seed))
        self.queue = EventQueue()
        self._cycle = [0] * p.K
        self.cl_scale = cl_scale

    def schedule(self, vehicle: int, t_download: float, payload=None):
        """Vehicle downloads w_g at t_download, trains C_l, uploads C_u.

        The *snapshot of the global model at download time* rides along in
        the event payload, which is what makes the uploads stale."""
        p = self.p
        c_l = training_delay(p, vehicle + 1)                # 1-based index
        if self.cl_scale is not None:
            c_l = c_l * float(self.cl_scale[vehicle])
        t_up = t_download + c_l
        gain = self.gains.at(t_up)[vehicle]
        rate = shannon_rate(p, gain, self.distance(vehicle, t_up))
        c_u = upload_delay(p, rate)
        cyc = self._cycle[vehicle]
        self._cycle[vehicle] += 1
        return self.queue.push(t_up + c_u, vehicle,
                               download_time=t_download, train_delay=c_l,
                               upload_delay=c_u, payload=payload, cycle=cyc)

    def prune(self):
        if len(self.queue):
            self.gains.prune_below(self.queue.earliest_time())


def _consumed_events(p: ChannelParams, seed: int, rounds: int,
                     selection=None, faults=None,
                     l_iters: int = 5) -> set[tuple[int, int]]:
    """Dry-run the timeline (no training, no payloads): the exact set of
    (vehicle, cycle) uploads consumed within ``rounds`` arrivals.  With a
    selection policy or a fault model the replay drives identical
    ``SelectionState``/``FaultState`` instances, so parked, dropped and
    blacked-out cycles never enter the set."""
    flt = make_fault_state(faults, p, seed, rounds, l_iters)
    tl = _Timeline(p, seed, cl_scale=None if flt is None else flt.cl_scale)
    sel = make_selection_state(selection, p, Mobility(p), seed, rounds)
    for k in initial_vehicles(sel, flt, p.K):
        tl.schedule(k, 0.0)
    out: set[tuple[int, int]] = set()
    while len(out) < rounds and len(tl.queue):
        ev = tl.queue.pop()
        r = len(out)
        out.add((ev.vehicle, ev.cycle))
        if flt is not None:
            flt.on_pop(ev.vehicle, r)
        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: tl.schedule(v, t))
        tl.prune()
    return out
