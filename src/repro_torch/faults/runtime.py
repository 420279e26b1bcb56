"""Host-side fault driver, the static plan the device engines fold in, and
the composition of the admission layers with the event timeline:
``repro.faults.runtime`` for the port (DESIGN.md §16).

:class:`FaultState` defines the fault semantics.  The serial engines drive
one live; the f64 planners (the batched engine's consumed-set dry run,
``core.jit_engine.plan_fleet``, ``corridor.plan.plan_corridor``) replay an
identical instance over the identical timeline, so every engine makes the
same drop, partial and inflation decisions.  The rules:

- **Draws advance per schedule attempt.**  Every vehicle owns one RNG
  stream (seeded from ``(seed, salt, 1, vehicle)``); each schedule attempt
  — initial admission, post-pop re-schedule, selection re-admission, fault
  recovery — consumes exactly one ``random(5)`` block, so the decision
  sequence depends only on the (engine-identical) timeline.
- **Suppression reuses the selection machinery.**  A dropped upload or a
  blackout is a suppressed re-schedule: the vehicle's slot goes +inf the
  same way a selection-parked vehicle's does, and the device engines fold
  ``sched`` into the ``[M, K]`` admission table at ``[r, veh[r]]``.
- **Recovery is a periodic re-admission sweep.**  Every ``recheck_every``
  consumed arrivals (corridor worlds: every reconcile boundary) dark
  vehicles whose recovery time has passed re-enter at the boundary
  timestamp through the selection re-admission path.
- **The queue never empties.**  If refusing a schedule would leave zero
  in-flight uploads the fault is suppressed (draws are consumed first, so
  determinism is unaffected) — graceful degradation raises nothing.
- **Staleness-cap discard is a per-pop verdict.**  ``keep[r]`` compares
  the pop's model age in consumed rounds against the cap; a discarded
  arrival still counts as a round, only the model update is skipped.

The composition helpers every engine calls:

- :func:`initial_vehicles` — who is scheduled at t = 0;
- :func:`arrival_step` — one consumed arrival: re-schedule under the
  selection mask and the fault gate or park, then the boundary's
  re-admissions and recovery sweeps;
- :func:`fold_admission` / :func:`fold_readmits` — the ``[M, K]``
  admission table and the ``{boundary: [vehicle, ...]}`` map the device
  engines write into their queues.

numpy f64 host code only: the device engines read its residue,
:class:`FaultPlan`, as tables.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.faults.spec import FaultSpec, resolve_faults

_SALT = 0xFA17


@dataclass(frozen=True)
class FaultPlan:
    """Everything static the device engines need about faults.

    Per-pop columns are length-``rounds`` tuples: ``sched[r]`` — was pop
    ``r``'s vehicle re-scheduled (False = dropped/blacked out),
    ``keep[r]`` — does its upload survive the staleness cap, ``epochs[r]``
    — local SGD steps its cycle actually ran, ``cause[r]`` — 0 none /
    1 dropout / 2 blackout.  ``readmits`` holds the recovery sweeps:
    ``(b, (v, ...))`` re-admits vehicles at boundary ``b`` (1-based
    consumed-arrival count, exactly the selection-boundary encoding)."""
    spec: FaultSpec
    cl_scale: tuple             # f64*K straggler train-delay multipliers
    admit0: tuple               # bool*K initially-live vehicles
    sched: tuple                # bool*rounds
    keep: tuple                 # bool*rounds
    epochs: tuple               # int*rounds
    cause: tuple                # int*rounds
    readmits: tuple             # ((b, (v, ...)), ...)

    @property
    def is_noop(self) -> bool:
        return self.spec.is_noop

    @property
    def timeline_active(self) -> bool:
        return self.spec.timeline_active

    def signature(self) -> tuple:
        """Hashable identity of the plan (value-level, like the selection
        plan's)."""
        return (self.spec, self.cl_scale, self.admit0, self.sched,
                self.keep, self.epochs, self.cause, self.readmits)

    def readmit_lists(self) -> dict:
        """``{boundary: [vehicle, ...]}`` for the engines' readmit fold."""
        return {b: list(vs) for b, vs in self.readmits}

    def tables(self, rounds: int) -> dict:
        """Fixed-shape padded fault tables: shapes depend only on
        ``(rounds, K)``, never on the seed, so per-world fault plans stack
        along a leading world axis (the FLT001 cross-seed shape probe pins
        this)."""
        K = len(self.cl_scale)
        readmit = np.zeros((rounds, K), bool)
        for b, vs in self.readmits:
            if b < rounds:
                readmit[b, list(vs)] = True
        return {
            "cl_scale": np.asarray(self.cl_scale, np.float64),
            "admit0": np.asarray(self.admit0, bool),
            "sched": np.asarray(self.sched, bool),
            "keep": np.asarray(self.keep, bool),
            "epochs": np.asarray(self.epochs, np.int32),
            "cause": np.asarray(self.cause, np.int8),
            "readmit": readmit,
        }

    def counts_table(self, l_iters: int) -> np.ndarray:
        """i32[rounds, 4] per-pop counter increments —
        (dropped, blackout, partial, discarded)."""
        cause = np.asarray(self.cause)
        eps = np.asarray(self.epochs)
        keep = np.asarray(self.keep)
        return np.stack([cause == 1, cause == 2, eps < l_iters, ~keep],
                        axis=1).astype(np.int32)

    def counts(self, l_iters: int) -> dict:
        tot = self.counts_table(l_iters).sum(axis=0)
        return {"dropped_uploads": int(tot[0]),
                "blackout_rounds": int(tot[1]),
                "partial_rounds": int(tot[2]),
                "discarded_uploads": int(tot[3])}

    def summary(self, l_iters: int) -> dict:
        """The ``SimResult.extras['faults']`` payload — identical across
        engines by construction (conformance asserts it), plain
        JSON-serializable types only."""
        return {
            "spec": dataclasses.asdict(self.spec),
            "counts": self.counts(l_iters),
            "admit0": [bool(x) for x in self.admit0],
            "sched": [bool(x) for x in self.sched],
            "keep": [bool(x) for x in self.keep],
            "epochs": [int(x) for x in self.epochs],
            "cause": [int(x) for x in self.cause],
            "readmits": [(int(b), [int(v) for v in vs])
                         for b, vs in self.readmits],
            "n_stragglers": int(sum(1 for s in self.cl_scale if s != 1.0)),
        }


class FaultState:
    """Live fault driver over one simulation timeline (f64 host numpy).

    ``recheck_every`` overrides the spec's sweep cadence (the corridor
    engines pass their reconcile period, mirroring selection's
    ``resel_every`` override)."""

    def __init__(self, spec: FaultSpec, p, seed: int, rounds: int,
                 l_iters: int, recheck_every: Optional[int] = None):
        self.spec = spec.validate()
        K = p.K
        self.K = K
        self.rounds = rounds
        self.l_iters = l_iters
        self.recheck = (recheck_every if recheck_every is not None
                        else spec.recheck_every)
        rng0 = np.random.default_rng([int(seed), _SALT, 0])
        slow = rng0.random(K) < spec.straggler_frac
        self.cl_scale = np.where(slow, float(spec.straggler_mult), 1.0)
        self._rng = [np.random.default_rng([int(seed), _SALT, 1, v])
                     for v in range(K)]
        self._dark = np.zeros(K, bool)
        self._t_rec = np.zeros(K)
        self._ep = np.full(K, l_iters, np.int64)
        self._dl = np.full(K, -1, np.int64)       # last (re-)schedule round
        # per-pop decision records
        self.admit0 = np.ones(K, bool)
        self._sched = np.ones(rounds, bool)
        self._keep = np.ones(rounds, bool)
        self._eps = np.full(rounds, l_iters, np.int64)
        self._cause = np.zeros(rounds, np.int64)
        self._readmits: list = []

    # -- draws --------------------------------------------------------------
    def _assign_ep(self, v: int, u) -> None:
        n = self.l_iters
        if self.spec.p_partial and u[3] < self.spec.p_partial:
            n = 1 + int(u[4] * self.l_iters)
        self._ep[v] = min(max(n, 1), self.l_iters)

    # -- timeline hooks ------------------------------------------------------
    def gate(self, v: int, t: float, r: int, pending: int) -> bool:
        """One schedule attempt for vehicle ``v`` at time ``t`` (pop round
        ``r``; ``-1`` = initial admission).  ``pending`` is the number of
        other in-flight uploads — zero forbids suppression (force-live).
        Consumes one draw block; returns whether the schedule happens."""
        sp = self.spec
        u = self._rng[v].random(5)
        cause = 0
        if sp.p_blackout and u[0] < sp.p_blackout:
            cause = 2
            t_rec = t + sp.blackout_mean * float(-np.log1p(-u[1]))
        elif sp.p_dropout and u[2] < sp.p_dropout:
            cause, t_rec = 1, t
        if cause and pending <= 0:
            cause = 0                        # force-live: never stall
        if cause:
            self._dark[v] = True
            self._t_rec[v] = t_rec
            if r < 0:
                self.admit0[v] = False
            else:
                self._sched[r] = False
                self._cause[r] = cause
            return False
        self._assign_ep(v, u)
        self._dl[v] = r
        return True

    def on_pop(self, v: int, r: int) -> tuple:
        """Pop ``r`` consumed vehicle ``v``'s upload: the staleness-cap
        verdict and the cycle's epoch count."""
        stale = r - int(self._dl[v])
        keep = (self.spec.staleness_cap is None
                or stale <= self.spec.staleness_cap)
        self._keep[r] = keep
        self._eps[r] = self._ep[v]
        return keep, int(self._ep[v])

    def is_dark(self, v: int) -> bool:
        return bool(self._dark[v])

    def epoch_of(self, v: int) -> int:
        """Epoch count of vehicle ``v``'s in-flight cycle (assigned at its
        schedule; valid until the pop's gate draws the next cycle — one
        in-flight upload per vehicle, so this is unambiguous)."""
        return int(self._ep[v])

    def note_readmit(self, v: int, r: int) -> None:
        """A selection boundary re-admitted live vehicle ``v`` at pop
        ``r`` — a fresh cycle needs a fresh draw block."""
        u = self._rng[v].random(5)
        self._assign_ep(v, u)
        self._dl[v] = r

    def recoveries(self, total: int, t: float, sel_mask) -> list:
        """Re-admission sweep after consumed arrival ``total`` (1-based):
        dark vehicles whose recovery time has passed (and whom selection
        currently admits) re-enter at ``t``."""
        if (not self.recheck or total % self.recheck != 0
                or total >= self.rounds):
            return []
        out = [int(v) for v in np.flatnonzero(self._dark)
               if self._t_rec[v] <= t
               and (sel_mask is None or sel_mask[v])]
        for v in out:
            self._dark[v] = False
            u = self._rng[v].random(5)
            self._assign_ep(v, u)
            self._dl[v] = total - 1
        if out:
            self._readmits.append((total, tuple(out)))
        return out

    def force_initial(self, v: int) -> None:
        """Initial admission left zero vehicles live: force ``v`` in
        (its draws were already consumed, determinism unaffected)."""
        self._dark[v] = False
        self.admit0[v] = True

    # -- residue -------------------------------------------------------------
    def plan(self) -> FaultPlan:
        return FaultPlan(
            spec=self.spec,
            cl_scale=tuple(float(x) for x in self.cl_scale),
            admit0=tuple(bool(x) for x in self.admit0),
            sched=tuple(bool(x) for x in self._sched),
            keep=tuple(bool(x) for x in self._keep),
            epochs=tuple(int(x) for x in self._eps),
            cause=tuple(int(x) for x in self._cause),
            readmits=tuple(self._readmits))


# ---------------------------------------------------------------------------
# composition with selection — one shared arrival step for every driver
# ---------------------------------------------------------------------------
def initial_vehicles(sel, flt, K: int) -> list:
    """Vehicles to schedule at t=0 under both admission layers: the
    selection mask first, then the availability gate (index-ascending).
    Never returns an empty list."""
    base = (list(range(K)) if sel is None else sel.initial_vehicles())
    if flt is None:
        return base
    out = []
    for v in base:
        if flt.gate(v, 0.0, -1, pending=K):
            out.append(v)
        elif sel is not None:
            sel.in_flight[v] = False
    if not out and base:
        v = base[0]
        flt.force_initial(v)
        if sel is not None:
            sel.in_flight[v] = True
        out = [v]
    return out


def arrival_step(sel, flt, *, r: int, vehicle: int, time: float,
                 upload_delay: float, train_delay: float, pending: int,
                 schedule, readmit=None) -> None:
    """The selection+fault re-scheduling composition for one consumed
    arrival.  The caller pops, calls ``flt.on_pop(vehicle, r)`` for the
    staleness verdict, aggregates, then calls this.

    ``schedule(v)`` re-enters vehicle ``v``'s next cycle at ``time``;
    ``readmit(v)`` (default ``schedule``) additionally does the caller's
    boundary bookkeeping (the planners' ``last_pop[v] = r``).  ``pending``
    is the in-flight upload count *after* this pop."""
    if readmit is None:
        readmit = schedule
    resched = True if sel is None else sel.on_arrival(
        vehicle, upload_delay, train_delay)
    if resched and flt is not None:
        resched = flt.gate(vehicle, time, r, pending)
        if not resched and sel is not None:
            sel.in_flight[vehicle] = False
    if resched:
        schedule(vehicle)
    if sel is not None:
        for v in sel.maybe_reselect(r + 1, time):
            if flt is not None and flt.is_dark(v):
                # still dark: stays parked until a recovery sweep
                sel.in_flight[v] = False
                continue
            if flt is not None:
                flt.note_readmit(v, r)
            readmit(v)
    if flt is not None:
        for v in flt.recoveries(r + 1, time,
                                None if sel is None else sel.mask):
            if sel is not None:
                sel.in_flight[v] = True
            readmit(v)


# ---------------------------------------------------------------------------
# engine folds (static, host-side — consumed before the device loop)
# ---------------------------------------------------------------------------
def fold_admission(adm_tab, flt_plan, veh) -> np.ndarray:
    """AND the fault plan's per-pop suppression column into the [M, K]
    admission table at ``[r, veh[r]]`` (``veh[r]`` is static, so only the
    popped vehicle's entry ever matters)."""
    adm = np.array(adm_tab, bool, copy=True)
    sched = np.asarray(flt_plan.sched, bool)
    rs = np.flatnonzero(~sched)
    adm[rs, np.asarray(veh)[rs]] = False
    return adm


def fold_readmits(sel_plan, flt_plan) -> dict:
    """Merge selection re-admissions and fault recovery sweeps into one
    ``{boundary: [vehicle, ...]}`` map for the engines' readmit fold."""
    out: dict = {}
    if sel_plan is not None:
        for b, newly, _ in sel_plan.boundaries:
            if newly:
                out[b] = list(newly)
    if flt_plan is not None:
        for b, vs in flt_plan.readmits:
            out.setdefault(b, [])
            out[b] = sorted(set(out[b]) | set(vs))
    return out


def check_faults_reconcile(spec, mode: str) -> None:
    """Shared corridor-engine guard (the faults dual of
    ``check_reconcile_mode``): availability faults + EMA reconcile cannot
    coexist — a recovery re-admission download must be RSU-independent,
    which only the fedavg reconcile provides (DESIGN.md §16)."""
    spec = resolve_faults(spec)
    if spec is not None and spec.timeline_active and mode == "ema":
        raise ValueError(
            "fault injection with reconcile_mode='ema' is unsupported: "
            "EMA keeps distinct post-reconcile cohorts, so a recovery "
            "re-admission download is RSU-dependent and the one-row-per-"
            "round snapshot ring cannot represent it (DESIGN.md §16) — "
            "use 'fedavg'")


def make_fault_state(faults, p, seed: int, rounds: int, l_iters: int,
                     recheck_every: Optional[int] = None
                     ) -> Optional[FaultState]:
    """Normalize the engines' ``faults`` argument: every falsy/no-op
    spelling stays ``None`` (the path without faults, zero fault
    machinery), a profile name or :class:`FaultSpec` becomes a live
    driver."""
    spec = resolve_faults(faults)
    if spec is None:
        return None
    return FaultState(spec, p, seed, rounds, l_iters,
                      recheck_every=recheck_every)
