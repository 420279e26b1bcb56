"""Device-resident fleet engine (``engine="jit"``, repro's DESIGN.md §9/§12):
the round loop of ``repro.core.jit_engine``'s packed flat program and, with
``flat=False``, of its pytree program, run eagerly on the card.

- **Fixed-capacity slot queue.**  Every vehicle has exactly one in-flight
  upload at all times, so the event queue is ``K`` slots: ``f32[K]``
  times/delays indexed by vehicle.  A pop is an ``argmin`` over the time
  column; a re-schedule is a one-slot write.  The popped index stays a
  one-element device tensor (read with ``index_select``, written with
  ``index_copy_``), so the event loop never waits for the device.
- **Precomputed slot gains.**  The AR(1) gains of every slot the plan
  reaches are one ``[S, K]`` table (:func:`slot_gain_table`) on the card.
- **Snapshot rows only where read.**  The model is one f32 ``[P]`` master
  buffer (``core/flat.py``).  A post-round row is stored only at the rounds
  a later wave downloads or an eval reads (``needed``); the rows are
  shared by reference, and nothing writes ``g`` or a stored row in place.
- **Wave-hoisted training.**  Every pending upload whose payload round has
  completed trains together, between event-loop segments: through a
  broadcast of one params dict when the wave shares its payload (every
  initial-download wave), else through a vmap of stacked params.
- **Fused aggregation.**  A segment's pops give per-upload ``(c, d)``
  pairs on the device (``aggregation.chain_coeffs``); the global model then
  streams once per checkpoint interval through the ``ring_agg`` kernel.
  That is what ``repro`` runs on every accelerator; its in-scan ``[P]`` mix
  (``fused_chain=False``) exists only to pin XLA:CPU digests and is not
  ported.
- ``ring_dtype="bf16"`` stores snapshot rows and upload rows in bf16
  around the f32 master and f32 accumulation.
- **The pytree program** (``flat=False``, ``repro``'s benchmark baseline,
  :func:`_run_pytree`): the same queue, plan, waves and folds, with the
  model a param dict mixed pop by pop (``aggregation.arrival_mix``: per-leaf
  f32 ops, or K2 in its device-scalar form under ``use_kernel``) and a
  ring of every post-round model.  Without ``use_kernel`` its params are
  bitwise the flat program's: both round each product and sum alone.
- **Selection** is host data: an ``[M, K]`` admission table on the card
  gates each pop's re-schedule (a parked vehicle's slot goes ``+inf``),
  boundary re-admissions write the queue between two pops, and the
  eps-bandit's f32 reward accumulators are checked after the run against
  the host replay's f64 expectation.
- **Faults** are the same fold: dropped and blacked-out re-schedules AND
  into the admission table (all-True without selection), recovery sweeps
  join the re-admissions, a cap-discarded pop's chain coefficients become
  ``(1, 0)`` (an exact no-op inside its ``ring_agg`` chain, which keeps
  the plan's chains), and the per-cycle epoch counts feed the masked
  partial trainer.  Straggler multipliers are in the plan's train delays.
- **Telemetry** (``metrics="on"``) is plan data too: histogram edges from
  the f64 plan, device counters updated in place per pop
  (``telemetry/device.py``), the occupancy and pop wait as two more trace
  columns, the fault plan's counts table added row by row, and the bf16
  ring guard around ``store``.  Off builds none of it.

Times on the device are f32.  The timeline never depends on training, so
an f64 host dry run (:func:`plan_fleet`) fixes the pop order, the waves and
one minibatch stack per round, and afterwards cross-checks the device
trace: any divergence raises.  The sweep tier (``core/sweep.py``,
``engine="vmap"``) runs this loop over a leading world axis and stacks
each world's :meth:`FleetPlan.tables`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.channel import (ChannelParams, Mobility, slot_gain_table,
                                 training_delay)
from repro_torch.core import client as client_mod
from repro_torch.core.aggregation import arrival_mix, chain_coeffs
from repro_torch.core.client import Vehicle, VehicleData
from repro_torch.core.flat import ParamLayout
from repro_torch.core.mafl import (SimResult, _Timeline, evaluate,
                                   fault_report, reward_channel, unported)
from repro_torch.core.server import DEFAULT_FEDASYNC_MIX, RoundRecord
from repro_torch.device import resolve_device
from repro_torch.faults import (arrival_step, fold_admission, fold_readmits,
                                initial_vehicles, make_fault_state)
from repro_torch.kernels.weighted_agg import ops as agg_ops
from repro_torch.models.cnn import init_cnn
from repro_torch.selection import make_selection_state
from repro_torch.telemetry import PhaseTimers, RunReport, memory_stats
from repro_torch.telemetry import device as tel_dev
from repro_torch.telemetry.report import wave_stats
from repro_torch.telemetry.spec import resolve_metrics

_SUPPORTED_SCHEMES = ("mafl", "afl", "fedasync")


@dataclass
class FleetPlan:
    """Host dry run of the timeline: everything the device loop needs that
    training cannot change."""
    veh: np.ndarray             # i32[M] vehicle popped at round r
    cycle: np.ndarray           # i32[M] that vehicle's upload cycle
    dl_round: np.ndarray        # i32[M] round after which it downloaded (-1 = initial)
    times: np.ndarray           # f64[M] host-reference pop times
    train_delay: np.ndarray     # f64[M]
    upload_delay: np.ndarray    # f64[M]
    download_time: np.ndarray   # f64[M]
    waves: tuple                # ((train_rounds, seg_start, seg_end), ...)
    n_slots: int                # gain-table height
    q0: dict                    # initial per-vehicle slot arrays
    sel: object = None          # SelectionPlan, or None without selection
    sel_bandit: object = None   # (rew_sum, rew_cnt) f64 the bandit guard reads
    flt: object = None          # FaultPlan, or None without faults

    def tables(self) -> dict:
        """Fixed-shape padded plan tables for the multi-world sweep tier
        (DESIGN.md §15): every array's shape depends only on ``(M, K)`` —
        never on the seed — so per-world tables stack along a leading
        world axis (``repro_torch.core.sweep.stack_plan_tables``; PLN003
        probes the stability).  The ragged ``waves`` tuple is re-encoded as
        two per-round columns: ``train_round[r]`` = the wave start at which
        consumed upload ``r`` trains, ``seg_end[r]`` = the end of the
        segment containing pop ``r``.  ``n_slots`` pads as a value, not a
        shape — the sweep engine zero-pads the gain tables to the batch
        maximum."""
        M = len(self.veh)
        train_round = np.full(M, -1, np.int32)
        seg_end = np.zeros(M, np.int32)
        for T, s, e in self.waves:
            for t in T:
                train_round[t] = s
            seg_end[s:e] = e
        return {
            "veh": np.asarray(self.veh, np.int32),
            "cycle": np.asarray(self.cycle, np.int32),
            "dl_round": np.asarray(self.dl_round, np.int32),
            "times": np.asarray(self.times, np.float64),
            "train_delay": np.asarray(self.train_delay, np.float64),
            "upload_delay": np.asarray(self.upload_delay, np.float64),
            "download_time": np.asarray(self.download_time, np.float64),
            "train_round": train_round,
            "seg_end": seg_end,
            "n_slots": np.asarray(self.n_slots, np.int32),
            "q0_time": np.asarray(self.q0["time"], np.float64),
            "q0_download_time": np.asarray(self.q0["download_time"],
                                           np.float64),
            "q0_upload_delay": np.asarray(self.q0["upload_delay"],
                                          np.float64),
            "q0_train_delay": np.asarray(self.q0["train_delay"],
                                         np.float64),
        }


def plan_fleet(p: ChannelParams, seed: int, rounds: int,
               selection=None, faults=None, l_iters: int = 5) -> FleetPlan:
    """Dry-run ``rounds`` arrivals (no payloads, no training) and derive the
    pop order, the wave partition and the initial queue slots, as
    ``repro.core.jit_engine.plan_fleet`` does.  A selection policy is
    replayed by its own ``SelectionState``: parked vehicles hold ``+inf``
    in ``q0`` and re-admissions are part of the plan.  A fault model is
    replayed by its own ``FaultState`` the same way: suppressions, recovery
    sweeps, staleness-cap verdicts, epoch counts and straggler delays
    are plan data (``FleetPlan.flt``)."""
    sel = make_selection_state(selection, p, Mobility(p), seed, rounds)
    flt = make_fault_state(faults, p, seed, rounds, l_iters)
    tl = _Timeline(p, seed, cl_scale=None if flt is None else flt.cl_scale)
    for k in initial_vehicles(sel, flt, p.K):
        tl.schedule(k, 0.0)

    ev0 = tl.queue.as_struct_arrays()
    if sel is None and flt is None:
        assert len(np.unique(ev0["vehicle"])) == p.K, \
            "slot queue invariant: one in-flight upload per vehicle"
    # full-K slot arrays; a parked vehicle holds +inf (never popped) until
    # a re-admission boundary writes it a live slot.  train_delay is Eq. 8
    # for every vehicle, parked ones too: a re-admission reads it; the
    # straggler multipliers scale it as the timeline does
    q0 = {
        "time": np.full(p.K, np.inf),
        "download_time": np.zeros(p.K),
        "upload_delay": np.zeros(p.K),
        "train_delay": np.array(
            [training_delay(p, i) for i in range(1, p.K + 1)]),
    }
    if flt is not None:
        q0["train_delay"] = q0["train_delay"] * flt.cl_scale
    q0["time"][ev0["vehicle"]] = ev0["time"]
    q0["download_time"][ev0["vehicle"]] = ev0["download_time"]
    q0["upload_delay"][ev0["vehicle"]] = ev0["upload_delay"]

    M = rounds
    veh = np.empty(M, np.int32)
    cyc = np.empty(M, np.int32)
    dlr = np.empty(M, np.int32)
    times = np.empty(M)
    c_l = np.empty(M)
    c_u = np.empty(M)
    dlt = np.empty(M)
    last_pop = np.full(p.K, -1, np.int32)
    for r in range(M):
        ev = tl.queue.pop()
        veh[r], cyc[r] = ev.vehicle, ev.cycle
        dlr[r] = last_pop[ev.vehicle]
        times[r], c_l[r], c_u[r] = ev.time, ev.train_delay, ev.upload_delay
        dlt[r] = ev.download_time
        last_pop[ev.vehicle] = r
        if flt is not None:
            # the staleness verdict reads the download round before the
            # gate below re-schedules
            flt.on_pop(ev.vehicle, r)

        def _readmit(v, t=ev.time, r=r):
            # a re-admitted (or recovered) vehicle downloads the
            # post-round-r model, so its next pop's payload is row r+1, as
            # for an ordinary re-download
            tl.schedule(v, t)
            last_pop[v] = r

        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: tl.schedule(v, t),
            readmit=_readmit)
        tl.prune()

    # Wave partition, the batched engine's rule: a wave trains every
    # not-yet-trained consumed upload whose payload round has completed,
    # then the segment consumes pops up to the first event scheduled
    # during it.
    waves = []
    trained = np.zeros(M, bool)
    s = 0
    while s < M:
        T = np.where(~trained & (dlr < s))[0]
        trained[T] = True
        untrained = np.where(~trained)[0]
        e = int(untrained[0]) if len(untrained) else M
        waves.append((tuple(int(x) for x in T), s, e))
        s = e

    return FleetPlan(veh=veh, cycle=cyc, dl_round=dlr, times=times,
                     train_delay=c_l, upload_delay=c_u, download_time=dlt,
                     waves=tuple(waves), n_slots=tl.gains.last_slot + 3,
                     q0=q0, sel=None if sel is None else sel.plan(),
                     sel_bandit=None if sel is None
                     else sel.bandit_expectation(),
                     flt=None if flt is None else flt.plan())


def eval_rounds_of(rounds: int, eval_every: int) -> tuple:
    return tuple(rr for rr in range(1, rounds + 1)
                 if rr % eval_every == 0 or rr == rounds)


def needed_rounds(plan: FleetPlan, eval_rounds: Sequence[int]) -> set:
    """Rounds whose post-round model must be stored: later-wave payloads
    and eval rows.  No other row is ever read, so the chain streams
    straight through it."""
    d = plan.dl_round
    needed = set(int(x) for x in eval_rounds)
    for T, _s, _e in plan.waves:
        needed |= {int(d[t]) + 1 for t in T if d[t] >= 0}
    return needed


def chain_bounds(s: int, e: int, needed: set) -> list:
    """Ends of the ``ring_agg`` chains of segment ``[s, e)``: each needed
    round inside it, and ``e``.  One chain (one launch) per end."""
    return sorted({x for x in needed if s < x <= e} | {e})


def _chain_segment(g, locals_buf, coeffs, snaps, s: int, e: int,
                   needed: set, store):
    """Advance the f32 master ``g`` across segment ``[s, e)`` as fused
    ``ring_agg`` chains, storing a snapshot row only at the rounds in
    ``needed``.  ``coeffs`` are the segment's ``(c, d)`` pairs,
    ``f32[e-s, 2]``; ``snaps`` maps round -> stored row."""
    a = s
    for b in chain_bounds(s, e, needed):
        g = agg_ops.ring_agg(g, locals_buf[a:b], coeffs[a - s:b - s])
        if b in needed:
            snaps[b] = store(g)
        a = b
    return g


class _SlotQueue:
    """The device slot queue and the Eq. 3-6 re-scheduler.

    Channel constants are rounded to f32 first and applied as f32 scalars
    in ``repro``'s op order.  Under an active selection plan, or a fault
    plan that can suppress re-schedules, the queue holds the ``[M, K]``
    admission table (``adm``, all-True before the fault fold when only
    faults are on) and, for eps-bandit, the f32 reward accumulators
    ``rs``/``rc``; otherwise these are None and a pop is the path without
    them.  A fault plan with a staleness cap adds the ``bool[M]`` keep
    column (``keep``), one with partial computation the ``i32[M]`` epoch
    column (``epochs``): the event segments and the waves read them.
    ``occupancy`` (set when metrics are on) makes every pop also return
    the live-slot count before it."""

    def __init__(self, p: ChannelParams, plan: FleetPlan, gains, x0,
                 device):
        f32 = np.float32
        self.K = p.K
        self.n_slots = plan.n_slots
        self.gains = gains.reshape(-1)              # [S*K], row-major
        self.x0 = x0
        self.v = float(f32(p.v))
        self.cov = float(f32(p.coverage))
        self.dy2H2 = float(f32(p.d_y ** 2 + p.H ** 2))
        self.pm = float(f32(p.p_m))
        self.alpha = float(f32(p.alpha))
        self.sigma2 = float(f32(p.sigma2))
        self.bw = float(f32(p.B))
        self.bits = float(f32(p.model_bits))
        self.gamma = float(f32(p.gamma))
        self.zeta = float(f32(p.zeta))

        def col(x):
            return torch.from_numpy(
                np.asarray(x, np.float64).astype(np.float32)).to(device)
        self.qt = col(plan.q0["time"])
        self.qdl = col(plan.q0["download_time"])
        self.qcu = col(plan.q0["upload_delay"])
        self.qcl = col(plan.q0["train_delay"])
        self.inf = torch.full((1,), np.inf, dtype=torch.float32,
                              device=device)
        self.adm = self.rs = self.rc = self.keep = self.epochs = None
        self.occupancy = False
        M = len(plan.veh)
        sel, flt = plan.sel, plan.flt
        sel_on = sel is not None and not sel.is_noop
        flt_adm = flt is not None and flt.timeline_active
        if sel_on or flt_adm:
            adm = (sel.tables(M)["mask"] if sel_on
                   else np.ones((M, p.K), bool))
            if flt_adm:
                adm = fold_admission(adm, flt, plan.veh)
            self.adm = torch.from_numpy(adm).to(device)   # one copy
        if sel_on and sel.spec.policy == "eps-bandit":
            self.rs = torch.zeros(p.K, dtype=torch.float32, device=device)
            self.rc = torch.zeros_like(self.rs)
        if flt is not None and flt.spec.has_cap:
            self.keep = torch.from_numpy(
                np.asarray(flt.keep, bool)).to(device)
        if flt is not None and flt.spec.has_partial:
            self.epochs = torch.from_numpy(
                np.asarray(flt.epochs, np.int32)).to(device)

    def admit(self, r: int, i, t_new, cu, cl, weight, mafl: bool):
        """Selection at pop ``r`` (a host int) of vehicle ``i``: fold the
        bandit reward (the delay weight, Eqs. 7, 9) into ``rs``/``rc``, and
        return the re-schedule time, ``+inf`` where the vehicle is parked
        (the argmin never picks it)."""
        if self.rs is not None:
            rew = (weight if mafl else
                   self.gamma ** (cu - 1.0) * self.zeta ** (cl - 1.0))
            self.rs.index_add_(0, i, rew)
            self.rc.index_add_(0, i, torch.ones_like(rew))
        if self.adm is None:
            return t_new
        return torch.where(self.adm[r].index_select(0, i), t_new, self.inf)

    def readmit(self, idx, t_b):
        """Re-admit the parked vehicles ``idx`` (a device index tensor) at
        the boundary time ``t_b`` (a one-element tensor): each downloads
        now, trains C_l and uploads C_u, as a re-schedule does."""
        t_up = t_b + self.qcl.index_select(0, idx)
        cu_new = self.upload_delay(idx, t_up)
        self.qt.index_copy_(0, idx, t_up + cu_new)
        self.qdl.index_copy_(0, idx, t_b.expand_as(cu_new))
        self.qcu.index_copy_(0, idx, cu_new)

    def upload_delay(self, idx, t_up):
        """Eq. 3-6: slot gain -> position wrap -> distance -> SNR ->
        Shannon rate -> upload delay, for vehicles ``idx`` uploading at
        ``t_up`` (both ``[n]`` device tensors)."""
        # int32 cast truncates toward zero, as astype(int32) does
        slot = t_up.to(torch.int32).clamp_(0, self.n_slots - 1)
        gain = self.gains.index_select(0, slot.long() * self.K + idx)
        dx = self.x0.index_select(0, idx) + self.v * t_up      # Eq. 3
        # floored modulo (jnp.mod), not fmod: dx may be negative
        dx = torch.remainder(dx + self.cov, 2.0 * self.cov) - self.cov
        dist = torch.sqrt(dx * dx + self.dy2H2)                 # Eq. 4
        snr = self.pm * gain * dist ** (-self.alpha) / self.sigma2
        rate = self.bw * torch.log2(1.0 + snr)                  # Eq. 5
        return self.bits / torch.clamp_min(rate, 1e-12)         # Eq. 6

    def pop(self, mafl: bool, r: int):
        """Pop ``r``: take the earliest slot and re-schedule its vehicle
        (download now, train C_l, upload C_u) unless selection parks it.
        Returns the trace columns of the pop as one-element tensors:
        (vehicle, time, C_u, C_l, download time, delay weight), and with
        ``occupancy`` the live slots before the pop writes (the popped one
        included)."""
        i = torch.argmin(self.qt, dim=0, keepdim=True)
        occ = (torch.isfinite(self.qt).sum(0, keepdim=True)
               if self.occupancy else None)
        t = self.qt.index_select(0, i)
        cu = self.qcu.index_select(0, i)
        cl = self.qcl.index_select(0, i)
        dl_t = self.qdl.index_select(0, i)
        if mafl:                                                # Eqs. 7, 9
            weight = self.gamma ** (cu - 1.0) * self.zeta ** (cl - 1.0)
        else:
            weight = torch.ones_like(t)
        t_up = t + cl
        cu_new = self.upload_delay(i, t_up)
        t_new = self.admit(r, i, t_up + cu_new, cu, cl, weight, mafl)
        self.qt.index_copy_(0, i, t_new)
        self.qdl.index_copy_(0, i, t)
        self.qcu.index_copy_(0, i, cu_new)
        if occ is None:
            return i, t, cu, cl, dl_t, weight
        return i, t, cu, cl, dl_t, weight, occ


def keep_coeffs(queue: _SlotQueue, cc, dd, s: int, e: int):
    """The staleness-cap fold on the chain coefficients of pops
    ``s..e-1``: a discarded pop becomes ``(c, d) = (1, 0)``, so
    ``c g + d l = g`` exactly inside its chain and the chain bounds (and
    the ``ring_agg`` count) stay the plan's.  Without a cap, unchanged."""
    if queue.keep is None:
        return cc, dd
    keep = queue.keep[s:e]
    return torch.where(keep, cc, 1.0), torch.where(keep, dd, 0.0)


def _pop_segment(queue: _SlotQueue, s: int, e: int, *, mafl: bool,
                 readmits: dict, mst=None, fault_tab=None, on_pop=None):
    """Pops ``s..e-1`` of the slot queue.  The re-admissions of boundary
    ``b`` (``readmits[b]``, a device index tensor) are written between
    pops ``b-1`` and ``b``, at pop ``b-1``'s time.  With metrics on, ``mst``
    (``telemetry.device.fleet_state``) folds each pop, with row ``r`` of
    the fault counts table ``fault_tab`` where one is armed.  ``on_pop(r,
    pop)`` (the pytree program's merge) runs after each pop.  Nothing here
    reads a device value on the host.  Returns the segment's trace columns
    (``[e-s]`` each): six, and with metrics the occupancy and the pop
    wait."""
    pops = []
    for r in range(s, e):
        pop = queue.pop(mafl, r)
        if mst is not None:
            pop += (tel_dev.fleet_pop(
                mst, t=pop[1], dl_t=pop[4],
                fault_row=None if fault_tab is None else fault_tab[r]),)
        if on_pop is not None:
            on_pop(r, pop)
        pops.append(pop)
        if r + 1 in readmits:
            queue.readmit(readmits[r + 1], pop[1])
    return tuple(torch.cat(c) for c in zip(*pops))


def _event_segment(queue: _SlotQueue, g, locals_buf, snaps, s: int, e: int,
                   needed: set, store, *, scheme: str, interpretation: str,
                   beta: float, fedasync_mix: float, readmits: dict,
                   mst=None, fault_tab=None):
    """The flat program's event loop between two waves: pops ``s..e-1``
    (:func:`_pop_segment`), their chain coefficients, and the ``ring_agg``
    chains that merge them into ``g``.  Re-admissions split the pops,
    never the chains.  A cap-discarded pop stays in its chain as a no-op
    (:func:`keep_coeffs`).  Returns the new ``g`` and the segment's trace
    columns."""
    cols = _pop_segment(queue, s, e, mafl=scheme == "mafl",
                        readmits=readmits, mst=mst, fault_tab=fault_tab)
    _, t_c, _, _, dlt_c, w_c = cols[:6]
    cc, dd = chain_coeffs(scheme, interpretation, beta, w_c, t=t_c,
                          dl_t=dlt_c, fedasync_mix=fedasync_mix)
    cc, dd = keep_coeffs(queue, cc, dd, s, e)
    coeffs = torch.stack([cc, dd], dim=1)
    g = _chain_segment(g, locals_buf, coeffs, snaps, s, e, needed, store)
    return g, cols


def _train_wave(rows: dict, pay_rounds: np.ndarray, T_dev, imgs, labs,
                lr: float, epochs=None, unpack=None) -> dict:
    """Train the wave of rounds ``T_dev`` (a device index tensor) from
    their payload rows ``rows[pay_rounds]`` and return the uploads as one
    batched param dict (leaves ``[len(T), ...]``): through a broadcast of
    one params dict when the wave shares its payload (every
    initial-download wave), else through a vmap of stacked params.  A row
    is a param dict (the pytree programs) or a packed ``[P]`` buffer that
    ``unpack`` (``ParamLayout.unpack``) turns into one, after stacking.
    ``epochs`` (the fault plan's ``i32[M]`` epoch column on the device,
    under partial computation) switches to the masked partial scan."""
    shared = bool((pay_rounds == pay_rounds[0]).all())
    if shared:
        pay = rows[int(pay_rounds[0])]
    else:
        pay = [rows[int(pr)] for pr in pay_rounds]
        pay = (torch.stack(pay) if isinstance(pay[0], torch.Tensor)
               else {k: torch.stack([x[k] for x in pay]) for k in pay[0]})
    if unpack is not None:
        pay = unpack(pay)
    args = (pay, imgs.index_select(0, T_dev), labs.index_select(0, T_dev),
            lr)
    if epochs is None:
        train = (client_mod._local_scan_shared if shared
                 else client_mod._local_scan_vmap)
    else:
        train = (client_mod._local_scan_partial_shared if shared
                 else client_mod._local_scan_partial_vmap)
        args += (epochs.index_select(0, T_dev),)
    loc, _ = train(*args)
    return loc


def upload_indices(lists: list, device) -> list:
    """Index lists the loop reads, copied to the device in one transfer
    before the loop and handed back as slices in the same order: no copy
    inside the loop waits for the card."""
    flat = np.concatenate([np.asarray(x, np.int64) for x in lists])
    dev = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for x in lists:
        out.append(dev[off:off + len(x)])
        off += len(x)
    return out


def readmit_points(plan) -> dict:
    """``{boundary: [vehicle, ...]}``: the selection plan's re-admissions
    and the fault plan's recovery sweeps, merged (empty without either)."""
    sel = plan.sel
    return fold_readmits(None if sel is None or sel.is_noop else sel,
                         plan.flt)


def metrics_setup(metrics, plan, l_iters: int, bf16: bool, store, device,
                  state):
    """The device telemetry of one run (both device engines): the metrics
    state from ``state`` (``fleet_state`` or ``corridor_state``), the fault
    plan's ``i32[M, 4]`` counts table on the device when the spec arms the
    fault counters, and under the bf16 ring guard a :class:`RingStats`
    with the ``store`` it wraps.  Returns ``(mst, fault_tab, ring_stats,
    store)``."""
    mst = state(metrics, device)
    fault_tab = ring_stats = None
    if metrics.fault_counters and plan.flt is not None:
        fault_tab = torch.from_numpy(
            plan.flt.counts_table(l_iters)).to(device)
    if metrics.ring_guard and bf16:
        ring_stats = tel_dev.RingStats(device)
        store = ring_stats.wrap(store)
    return mst, fault_tab, ring_stats, store


def metrics_channels(mst, ring_stats, occ, gap) -> dict:
    """The device channels of a run, still on the device: the histogram,
    the occupancy and wait columns, and the counters the state holds."""
    out = {"stale_hist": mst.hist, "occupancy": occ, "gap": gap}
    if mst.handover is not None:
        out["handover_count"] = mst.handover
    if mst.faults is not None:
        out["fault_counts"] = mst.faults
    if ring_stats is not None:
        out.update(ring_stats.out())
    return out


def _run_program(plan: FleetPlan, queue: _SlotQueue, layout: ParamLayout,
                 w0, imgs, labs, lr: float, *, scheme: str,
                 interpretation: str, beta: float, fedasync_mix: float,
                 ring_dtype: str, eval_rounds: tuple, metrics=None,
                 l_iters: int = 1):
    """The flat program: waves and event segments in plan order.  Returns
    the final master ``[P]``, the stored rows, the trace columns and, with
    ``metrics`` (a resolved ``MetricsSpec``), the device channels (else
    None)."""
    M = len(plan.veh)
    d = plan.dl_round
    device = imgs.device
    bf16 = ring_dtype == "bf16"
    store_dtype = torch.bfloat16 if bf16 else torch.float32
    # a stored row is a new tensor (bf16) or g itself (f32): g is never
    # written in place, so sharing it by reference is safe
    store = ((lambda x: x.to(torch.bfloat16)) if bf16 else (lambda x: x))
    mst = fault_tab = ring_stats = None
    if metrics is not None:
        mst, fault_tab, ring_stats, store = metrics_setup(
            metrics, plan, l_iters, bf16, store, device, tel_dev.fleet_state)
        queue.occupancy = True
    needed = needed_rounds(plan, eval_rounds)

    readmit_at = readmit_points(plan)
    # wave rows and re-admitted vehicles: one host-to-device copy
    idx = upload_indices([T for T, _, _ in plan.waves]
                         + [readmit_at[b] for b in sorted(readmit_at)],
                         device)
    wave_idx = idx[:len(plan.waves)]
    readmits = dict(zip(sorted(readmit_at), idx[len(plan.waves):]))

    g = layout.pack(w0)                         # f32[P] master weights
    locals_buf = torch.zeros((M, layout.P), dtype=store_dtype, device=device)
    snaps = {0: store(g)}
    traces = []
    for (T, s, e), T_dev in zip(plan.waves, wave_idx):
        T = np.asarray(T, np.int64)
        if len(T):
            loc = _train_wave(snaps, d[T] + 1, T_dev, imgs, labs, lr,
                              queue.epochs, unpack=layout.unpack)
            # in place: rows T are written once, before any chain reads
            # them
            locals_buf.index_copy_(0, T_dev, layout.pack(loc,
                                                         dtype=store_dtype))
        g, cols = _event_segment(
            queue, g, locals_buf, snaps, s, e, needed, store, scheme=scheme,
            interpretation=interpretation, beta=beta,
            fedasync_mix=fedasync_mix, readmits=readmits, mst=mst,
            fault_tab=fault_tab)
        traces.append(cols)
    trace = tuple(torch.cat([tr[k] for tr in traces])
                  for k in range(len(traces[0])))
    channels = None
    if mst is not None:
        trace, (occ, gap) = trace[:6], trace[6:]
        channels = metrics_channels(mst, ring_stats, occ, gap)
    return g, snaps, trace, channels


def _run_pytree(plan: FleetPlan, queue: _SlotQueue, w0, imgs, labs,
                lr: float, *, scheme: str, interpretation: str, beta: float,
                fedasync_mix: float, use_kernel: bool, metrics=None,
                l_iters: int = 1):
    """The pytree program (``flat=False``, ``repro``'s benchmark baseline):
    the model is the param dict, every pop mixes its upload into ``g`` on
    its own (:func:`aggregation.arrival_mix`: per-leaf f32 ops, or one K2
    launch in the device form under ``use_kernel``), and the ring keeps
    every post-round model, ``ring[r]`` after round ``r`` (``ring[0]`` the
    init), by reference: every mix returns new tensors and nothing writes
    ``g`` or a ring entry in place.  A cap-discarded pop keeps ``g``
    exactly (``where`` on the keep column).  The slot queue, waves,
    re-admissions, bandit accumulators and telemetry are the flat
    program's.  Returns the final params, the ring, the trace columns and
    the device channels (or None)."""
    d = plan.dl_round
    device = imgs.device
    mst = fault_tab = None
    if metrics is not None:
        mst, fault_tab, _, _ = metrics_setup(
            metrics, plan, l_iters, False, None, device, tel_dev.fleet_state)
        queue.occupancy = True
    readmit_at = readmit_points(plan)
    idx = upload_indices([T for T, _, _ in plan.waves]
                         + [readmit_at[b] for b in sorted(readmit_at)],
                         device)
    wave_idx = idx[:len(plan.waves)]
    readmits = dict(zip(sorted(readmit_at), idx[len(plan.waves):]))

    M = len(plan.veh)
    ring = {0: dict(w0)}
    # the uploads, one [M, ...] buffer per leaf
    uploads = {k: torch.zeros((M,) + tuple(x.shape), dtype=x.dtype,
                              device=device) for k, x in w0.items()}

    def merge(r, pop):
        ring[r + 1] = arrival_mix(
            ring[r], {k: B[r] for k, B in uploads.items()}, pop[5],
            scheme=scheme, interpretation=interpretation, beta=beta,
            t=pop[1], dl_t=pop[4], fedasync_mix=fedasync_mix,
            use_kernel=use_kernel,
            keep=None if queue.keep is None else queue.keep[r])

    traces = []
    for (T, s, e), T_dev in zip(plan.waves, wave_idx):
        if len(T):
            loc = _train_wave(ring, d[np.asarray(T, np.int64)] + 1, T_dev,
                              imgs, labs, lr, queue.epochs)
            for k, B in uploads.items():
                B.index_copy_(0, T_dev, loc[k])
        traces.append(_pop_segment(
            queue, s, e, mafl=scheme == "mafl", readmits=readmits, mst=mst,
            fault_tab=fault_tab, on_pop=merge))
    trace = tuple(torch.cat([tr[k] for tr in traces])
                  for k in range(len(traces[0])))
    channels = None
    if mst is not None:
        trace, (occ, gap) = trace[:6], trace[6:]
        channels = metrics_channels(mst, None, occ, gap)
    return ring[M], ring, trace, channels


def check_bandit(queue: _SlotQueue, plan, engine: str) -> None:
    """The selection divergence guard: the device's f32 reward
    accumulators must reproduce the host replay's f64 ones, from which
    the admission decisions were planned.  Counts exactly, sums within
    rtol 1e-4, atol 1e-3.  Raises ``RuntimeError``."""
    if queue.rs is None:
        return
    exp_rs, exp_rc = plan.sel_bandit
    if not np.array_equal(queue.rc.cpu().numpy(), exp_rc):
        raise RuntimeError(
            f"{engine}: device bandit arrival counts diverged from the host "
            "selection replay")
    if not np.allclose(queue.rs.cpu().numpy(), exp_rs, rtol=1e-4,
                       atol=1e-3):
        raise RuntimeError(
            f"{engine}: device bandit reward accumulators diverged from the "
            "host selection replay")


def _check_jit_args(scheme, ring_dtype, flat, mesh):
    if scheme not in _SUPPORTED_SCHEMES:
        raise ValueError(
            f"engine='jit' supports schemes {_SUPPORTED_SCHEMES}, not "
            f"{scheme!r} (fedbuff keeps host-side buffer state — use the "
            "serial or batched engine)")
    if ring_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown ring_dtype {ring_dtype!r}; "
                         "expected 'f32' or 'bf16'")
    if ring_dtype == "bf16" and not flat:
        raise ValueError("ring_dtype='bf16' requires the flat fast path "
                         "(flat=True): only the packed ring stores bf16 "
                         "snapshots around f32 master weights")
    if mesh is not None:
        raise unported("mesh sharding of the wave training",
                       "distribution (item 13)")


def _stage_run(vehicles_data, *, rounds, l_iters, lr, params, seed,
               init_params, batch_size, selection, faults, metrics,
               ring_dtype, device, timers):
    """Plan and stage one fleet run: the plan, the resolved metrics spec
    (None with metrics off), the slot queue, the initial params and one
    minibatch stack per round, all on ``device``."""
    p = params or ChannelParams()
    if len(vehicles_data) != p.K:
        raise ValueError(
            f"{len(vehicles_data)} vehicle shards for K={p.K} vehicles")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    with timers.phase("plan"):
        plan = plan_fleet(p, seed, rounds, selection, faults=faults,
                          l_iters=l_iters)
        # the spec is plan data: histogram edges from the dry run's f64
        # staleness and pop times
        met = resolve_metrics(
            metrics, stale=plan.times - plan.download_time,
            times=plan.times, n_rsus=1, ring_guard=(ring_dtype == "bf16"),
            fault_counters=plan.flt is not None)
    with timers.phase("stage"):
        w0, imgs, labs, gains = _stage_arrays(
            vehicles_data, p, plan, l_iters=l_iters, lr=lr, seed=seed,
            init_params=init_params, batch_size=batch_size, device=device)
        x0 = torch.from_numpy(Mobility(p).x0.astype(np.float32)).to(device)
        queue = _SlotQueue(p, plan, gains, x0, device)
    return p, plan, met, queue, w0, imgs, labs


def _stage_arrays(vehicles_data, p: ChannelParams, plan, *, l_iters, lr,
                  seed, init_params, batch_size, device):
    """The initial params, one minibatch stack per round of ``plan`` and
    the slot-gain table, on ``device`` (shared with the corridor engine).
    The minibatches are drawn from the same per-vehicle RNG streams in the
    same per-cycle order as the host engines, then copied to the device
    once."""
    w0 = (init_params if init_params is not None
          else init_cnn(torch.Generator().manual_seed(seed), device=device))
    imgs, labs = stage_minibatches(vehicles_data, plan, l_iters=l_iters,
                                   lr=lr, seed=seed, batch_size=batch_size,
                                   device=device)
    gains = torch.from_numpy(slot_gain_table(p, seed, plan.n_slots)
                             .astype(np.float32)).to(device)
    return w0, imgs, labs, gains


def stage_minibatches(vehicles_data, plan, *, l_iters, lr, seed,
                      batch_size, device):
    """One minibatch stack per round of ``plan`` (``[M, l, b, ...]``
    images and labels), drawn from the per-vehicle RNG streams in pop
    order, then copied to ``device`` once."""
    fleet_batch = min(batch_size, min(d.size for d in vehicles_data))
    clients = [Vehicle(d, lr=lr, batch_size=fleet_batch, seed=seed,
                       device=device) for d in vehicles_data]
    im_list, lab_list = [], []
    for v in plan.veh:
        im, lab = clients[v].sample_batches(l_iters)
        im_list.append(im)
        lab_list.append(lab)
    imgs = torch.from_numpy(np.stack(im_list)).to(device)
    labs = torch.from_numpy(np.stack(lab_list).astype(np.int64)).to(device)
    return imgs, labs


def run_simulation_jit(
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
    progress=None,
    batch_size: int = 128,
    mesh=None,
    selection=None,
    flat: bool = True,
    ring_dtype: str = "f32",
    metrics=None,
    faults=None,
    device=None,
) -> SimResult:
    """Run M rounds on the device; returns the ``SimResult`` the host
    engines produce (same record fields, same eval cadence).

    ``flat=True`` (the default) runs the packed flat program: aggregation
    is always the fused ``ring_agg`` chain, so ``use_kernel`` changes
    nothing there: every merge goes through the kernel on the card (its
    plain version on the CPU).  ``flat=False`` runs the pytree program:
    each arrival is merged on its own, by per-leaf f32 ops or, under
    ``use_kernel``, by one ``weighted_agg`` launch with its scalars on the
    card.  ``ring_dtype="bf16"`` (flat only; with ``flat=False`` it raises
    ``ValueError``) stores snapshot and upload rows in bf16 around f32
    master weights and accumulation.
    ``progress`` fires after the run, in round order.  ``device=None`` runs
    on the card.  ``selection`` is replayed by the host plan and folded in
    as the admission table and re-admissions; ``result.report.selection``
    holds the plan's ``summary()``.  ``faults`` is replayed by the same
    plan and folded in as well (admission table, recovery re-admissions,
    the keep fold on the chains, the partial trainer);
    ``result.extras["faults"]`` holds its ``summary(l_iters)`` and
    ``result.report.faults`` its spec and counts.

    ``metrics="on"`` (or a ``MetricsSpec``) folds the telemetry channels
    into the event loop on the device, with no host read inside it: the
    staleness histogram, slot occupancy and pop-wait columns, the fault
    counters (checked against the plan's counts after the run) and, with
    the bf16 ring, its guard; ``result.report.channels`` holds them.  Any
    falsy value runs the loop without telemetry, op for op.  Every result
    carries a ``RunReport`` (phases ``plan``, ``stage``, ``run``, ``eval``,
    memory, waves).

    Not ported yet, and raising: ``mesh``."""
    _check_jit_args(scheme, ring_dtype, flat, mesh)
    device = resolve_device(device)
    timers = PhaseTimers()
    p, plan, met, queue, w0, imgs, labs = _stage_run(
        vehicles_data, rounds=rounds, l_iters=l_iters, lr=lr, params=params,
        seed=seed, init_params=init_params, batch_size=batch_size,
        selection=selection, faults=faults, metrics=metrics,
        ring_dtype=ring_dtype, device=device, timers=timers)
    eval_rounds = eval_rounds_of(rounds, eval_every)
    with timers.phase("run"):
        if flat:
            layout = ParamLayout.from_tree(w0)
            g, snaps, trace, met_dev = _run_program(
                plan, queue, layout, w0, imgs, labs, lr, scheme=scheme,
                interpretation=interpretation, beta=p.beta,
                fedasync_mix=DEFAULT_FEDASYNC_MIX, ring_dtype=ring_dtype,
                eval_rounds=eval_rounds, metrics=met, l_iters=l_iters)
            final, model_at = layout.unpack(g), (
                lambda rr: layout.unpack(snaps[rr]))
        else:
            final, ring, trace, met_dev = _run_pytree(
                plan, queue, w0, imgs, labs, lr, scheme=scheme,
                interpretation=interpretation, beta=p.beta,
                fedasync_mix=DEFAULT_FEDASYNC_MIX, use_kernel=use_kernel,
                metrics=met, l_iters=l_iters)
            model_at = ring.__getitem__
        # reading the trace waits for the card: the run ends here
        t_veh, t_time, t_cu, t_cl, _t_dlt, t_w = (x.cpu().numpy()
                                                  for x in trace)

    # divergence guards: the minibatch stacks were paired to rounds by the
    # host plan, so a device pop order that disagrees fails loudly instead
    # of training the wrong vehicle's batches
    if not np.array_equal(t_veh, plan.veh):
        bad = int(np.argmax(t_veh != plan.veh))
        raise RuntimeError(
            "jit engine: device pop order diverged from the host dry run "
            f"at round {bad} (device vehicle {int(t_veh[bad])}, host "
            f"{int(plan.veh[bad])}) — f32 time ties are not expected")
    if not np.allclose(t_time, plan.times, rtol=1e-4, atol=1e-3):
        bad = int(np.argmax(~np.isclose(t_time, plan.times,
                                        rtol=1e-4, atol=1e-3)))
        raise RuntimeError(
            "jit engine: device event times diverged from the host dry run "
            f"at round {bad}: {t_time[bad]} vs {plan.times[bad]}")
    check_bandit(queue, plan, "jit engine")
    if ring_dtype == "bf16" and not bool(torch.isfinite(g).all()):
        # the timeline guards stay exact (times never depend on params);
        # a non-finite master means the quantized chain blew up
        raise RuntimeError(
            "jit engine: non-finite master weights under "
            "ring_dtype='bf16' — the quantized snapshot ring diverged "
            "(rerun with ring_dtype='f32' to bisect)")

    result = SimResult(scheme=scheme, rounds=[], acc_history=[],
                       loss_history=[], final_params=final)
    if plan.flt is not None:
        result.extras["faults"] = plan.flt.summary(l_iters)
    test_images = torch.as_tensor(test_images, device=device)
    test_labels = torch.as_tensor(test_labels, device=device)
    with timers.phase("eval"):
        for r in range(rounds):
            rec = RoundRecord(round=r + 1, time=float(t_time[r]),
                              vehicle=int(t_veh[r]),
                              upload_delay=float(t_cu[r]),
                              train_delay=float(t_cl[r]),
                              weight=float(t_w[r]))
            rr = r + 1
            if rr in eval_rounds:
                acc, loss = evaluate(model_at(rr), test_images,
                                     test_labels, device=device)
                rec.accuracy, rec.loss = acc, loss
                result.acc_history.append((rr, acc))
                result.loss_history.append((rr, loss))
                if progress:
                    progress(rr, acc)
            result.rounds.append(rec)
    result.report = device_report(
        engine="jit", scheme=scheme, rounds=rounds, seed=seed, met=met,
        met_dev=met_dev, plan=plan, queue=queue, p=p, l_iters=l_iters,
        cu=t_cu, cl=t_cl, timers=timers, device=device)
    return result


def device_report(*, engine, scheme, rounds, seed, met, met_dev, plan,
                  queue, p: ChannelParams, l_iters: int, cu, cl, timers,
                  device) -> RunReport:
    """The device engines' :class:`RunReport`.  With metrics on: the device
    channels read to the host once, the fault-counter divergence guard
    (the device sums must equal the plan's counts table, else
    ``RuntimeError``), the f64 reward trace from the recorded delays, and
    the bandit's f32 accumulators under eps-bandit."""
    channels = {}
    if met is not None:
        channels = {k: v.cpu().numpy() for k, v in met_dev.items()}
        if "fault_counts" in channels:
            exp = plan.flt.counts_table(l_iters).sum(axis=0)
            if not np.array_equal(channels["fault_counts"], exp):
                raise RuntimeError(
                    f"{engine} engine: device fault counters diverged from "
                    f"the host fault replay ({channels['fault_counts']} vs "
                    f"{exp})")
        channels["reward"] = reward_channel(p, cu, cl)
        if queue.rs is not None:
            channels["reward_sum"] = queue.rs.cpu().numpy()
            channels["reward_count"] = queue.rc.cpu().numpy()
    return RunReport(
        engine=engine, scheme=scheme, rounds=rounds, seed=seed,
        metrics_on=met is not None,
        spec=None if met is None else met.to_json(),
        phases=timers.snapshot(), memory=memory_stats(device),
        selection=None if plan.sel is None else plan.sel.summary(),
        faults=fault_report(plan.flt, l_iters),
        waves=wave_stats(plan.waves, p.K), channels=channels)
