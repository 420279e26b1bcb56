"""Host dry-run planner of the corridor engine: ``repro.corridor.plan``.

The event timeline depends only on the channel, mobility and data-size
processes, never on training.  With the corridor's serving-cell geometry in
place of the single-RSU distance, one payload-free f64 replay of the serial
handover loop's scheduling rules gives the pop order, each pop's serving
RSU, the wave partition, the gain-table height and the initial slot of
every vehicle in the ``[R, K]`` queue.  A selection policy is replayed by
its own ``SelectionState`` in the same pass, a fault model by its own
``FaultState`` (recovery sweeps at reconcile boundaries).  numpy f64 only:
the device engine re-derives the times in f32 and checks its trace against
this plan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.channel import ChannelParams, CorridorMobility, training_delay
from repro_torch.faults import (arrival_step, initial_vehicles,
                                make_fault_state)
from repro_torch.selection import make_selection_state


@dataclass
class CorridorPlan:
    """Everything the corridor program needs that training cannot change.
    All times are host-reference f64."""
    n_rsus: int
    veh: np.ndarray             # i32[M] vehicle popped at round r
    cycle: np.ndarray           # i32[M] that vehicle's upload cycle
    dl_round: np.ndarray        # i32[M] round after which it downloaded (-1 = initial)
    up_rsu: np.ndarray          # i32[M] serving RSU at arrival (= handover target,
                                #        = the RSU its re-download reads from)
    times: np.ndarray           # f64[M] host-reference pop times
    train_delay: np.ndarray     # f64[M]
    upload_delay: np.ndarray    # f64[M]
    download_time: np.ndarray   # f64[M]
    waves: tuple                # ((train_rounds, seg_start, seg_end), ...)
    n_slots: int                # gain-table height
    q0: dict                    # initial per-vehicle slot arrays (by vehicle)
    row0: np.ndarray            # i32[K] initial RSU row of each vehicle's slot
    sel: object = None          # SelectionPlan, or None without selection
    sel_bandit: object = None   # (rew_sum, rew_cnt) f64 the bandit guard reads
    flt: object = None          # FaultPlan, or None without faults

    def tables(self) -> dict:
        """Fixed-shape padded plan tables whose shapes depend only on
        ``(M, K)``, never on the seed: the wave partition re-encoded as
        per-round ``train_round``/``seg_end`` columns, ``n_slots`` as a
        value."""
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
            "up_rsu": np.asarray(self.up_rsu, np.int32),
            "times": np.asarray(self.times, np.float64),
            "train_delay": np.asarray(self.train_delay, np.float64),
            "upload_delay": np.asarray(self.upload_delay, np.float64),
            "download_time": np.asarray(self.download_time, np.float64),
            "train_round": train_round,
            "seg_end": seg_end,
            "n_slots": np.asarray(self.n_slots, np.int32),
            "row0": np.asarray(self.row0, np.int32),
            "q0_time": np.asarray(self.q0["time"], np.float64),
            "q0_download_time": np.asarray(self.q0["download_time"],
                                           np.float64),
            "q0_upload_delay": np.asarray(self.q0["upload_delay"],
                                          np.float64),
            "q0_train_delay": np.asarray(self.q0["train_delay"],
                                         np.float64),
        }


def plan_corridor(p: ChannelParams, n_rsus: int, seed: int, rounds: int,
                  entry: str = "uniform", selection=None,
                  reconcile_every: int = 0, faults=None,
                  l_iters: int = 1) -> CorridorPlan:
    """Dry-run ``rounds`` arrivals through the corridor timeline (no
    payloads, no training) and derive everything static.  ``selection``
    re-scores the fleet at every reconcile boundary (``reconcile_every``;
    the spec's own ``resel_every`` is never read here).  ``faults`` drives a
    ``FaultState`` whose recovery sweeps run at the same boundaries;
    ``l_iters`` sizes its epoch draws."""
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

    ev0 = tl.queue.as_struct_arrays()
    if sel is None and flt is None:
        assert len(np.unique(ev0["vehicle"])) == p.K, \
            "slot queue invariant: one in-flight upload per vehicle"
    # full-K slot arrays; a parked vehicle holds +inf until a re-admission
    # boundary writes it a live slot (train_delay is Eq. 8 for all, scaled
    # by the straggler multipliers as the timeline scales it)
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
    # a slot lives in the row of the RSU serving the vehicle at *arrival*
    # time, known at schedule time because positions are pure in t; a
    # parked vehicle's slot is +inf in every row, so its row is moot (0)
    live = np.isfinite(q0["time"])
    row0 = np.zeros(p.K, np.int32)
    row0[live] = np.asarray(
        corridor.serving_rsu(np.flatnonzero(live), q0["time"][live]),
        np.int32)

    M = rounds
    veh = np.empty(M, np.int32)
    cyc = np.empty(M, np.int32)
    dlr = np.empty(M, np.int32)
    ups = np.empty(M, np.int32)
    times = np.empty(M)
    c_l = np.empty(M)
    c_u = np.empty(M)
    dlt = np.empty(M)
    last_pop = np.full(p.K, -1, np.int32)
    for r in range(M):
        ev = tl.queue.pop()
        veh[r], cyc[r] = ev.vehicle, ev.cycle
        dlr[r] = last_pop[ev.vehicle]
        ups[r] = corridor.serving_rsu(ev.vehicle, ev.time)
        times[r], c_l[r], c_u[r] = ev.time, ev.train_delay, ev.upload_delay
        dlt[r] = ev.download_time
        last_pop[ev.vehicle] = r
        if flt is not None:
            flt.on_pop(ev.vehicle, r)

        def _readmit(v, t=ev.time, r=r):
            # re-admitted (or recovered) at the (post-reconcile) boundary
            # round: its next pop's payload is ring[r+1], the reconciled
            # model
            tl.schedule(v, t)
            last_pop[v] = r

        arrival_step(
            sel, flt, r=r, vehicle=ev.vehicle, time=ev.time,
            upload_delay=ev.upload_delay, train_delay=ev.train_delay,
            pending=len(tl.queue),
            schedule=lambda v, t=ev.time: tl.schedule(v, t),
            readmit=_readmit)
        tl.prune()

    # Wave partition, the fleet planner's rule: a wave trains every
    # not-yet-trained consumed upload whose payload round has completed,
    # then the segment consumes pops up to the first event scheduled during
    # it.  Handover adds nothing: the payload of round r's event is one
    # ring row (the cohort its re-download read).
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

    return CorridorPlan(n_rsus=n_rsus, veh=veh, cycle=cyc, dl_round=dlr,
                        up_rsu=ups, times=times, train_delay=c_l,
                        upload_delay=c_u, download_time=dlt,
                        waves=tuple(waves), n_slots=tl.gains.last_slot + 3,
                        q0=q0, row0=row0,
                        sel=None if sel is None else sel.plan(),
                        sel_bandit=None if sel is None
                        else sel.bandit_expectation(),
                        flt=None if flt is None else flt.plan())


def rsu_chain_groups(plan: CorridorPlan, s: int, e: int,
                     needed) -> list:
    """Per-RSU upload chains of segment ``[s, e)``.

    Within a segment the uploads landing on RSU ``j`` form one sequential
    mix chain on cohort row ``j``, so a segment aggregates as one
    ``ring_agg`` chain per active RSU, split at the rounds in ``needed``
    whose ring row a later wave reads (``ring[r+1]`` is the post-upload
    row of ``up_rsu[r]``).  Returns ``[(j, [chunk, ...]), ...]``; each chunk
    is a list of rounds, and every chunk boundary except possibly the last
    materialises a ring row."""
    groups = []
    for j in range(plan.n_rsus):
        rounds_j = [r for r in range(s, e) if int(plan.up_rsu[r]) == j]
        if not rounds_j:
            continue
        chunks, cur = [], []
        for r in rounds_j:
            cur.append(r)
            if r + 1 in needed:
                chunks.append(cur)
                cur = []
        if cur:
            chunks.append(cur)
        groups.append((j, chunks))
    return groups
