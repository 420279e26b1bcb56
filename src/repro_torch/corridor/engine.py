"""Device corridor engine (``engine="corridor"``): the round loop of
``repro.corridor.engine``'s packed flat program and, with ``flat=False``,
of its pytree program, run eagerly on the card.

- **Per-RSU slot queue ``f32[R, K]``**, held as its flat ``[R*K]`` view.
  Vehicle i's one in-flight upload occupies slot ``(j, i)``, j the RSU
  serving it at *arrival* time (positions are pure in t).  A pop is an
  ``argmin`` over the ``R*K`` column; the re-schedule writes ``+inf`` at
  ``(j, i)`` and then the new arrival time at ``(j_new, i)``, so a handover
  is this slot migration.  Indices stay one-element device tensors.
- **Cohort stack ``f32[R, P]``**: one contiguous row per RSU, written in
  place at every chain end and every reconcile.
- **Snapshot ring, one row per round where a later wave reads it.**
  ``ring[r+1]`` is the post-round-r row of the cohort round r's upload
  landed on (the one its re-download reads); ``ring[0]`` is the common
  init.  A ring row is never a view of the stack: chain outputs are new
  tensors from ``ring_agg``, reconciled rows are copies.
- **Segments split at eval and reconcile rounds** inside each wave.  A
  segment's pops give its trace columns and ``(c, d)`` pairs; then one
  ``ring_agg`` chain per chunk of :func:`rsu_chain_groups` streams each
  RSU's uploads into its cohort row.
- **The cloud tier at a reconcile round b**: FedAvg adopts the stack mean,
  EMA moves every row ``tau`` toward it (one ``weighted_agg`` launch on the
  ``[R, P]`` leaf under ``use_kernel``); ring row b becomes the reconciled
  row of ``up_rsu[b-1]``, since that re-download follows the reconcile.
- **Eval** reads the consensus (the stack mean) kept at each eval round.
- **Selection** is the fleet engine's fold: the ``[M, K]`` admission table
  sends a parked vehicle to ``+inf`` in every RSU row, the re-admissions of
  boundary b land (after the reconcile at b) in the row of the RSU serving
  each vehicle at its next arrival, and the eps-bandit's f32 accumulators
  meet the same divergence guard.
- **Faults** are the fleet engine's fold too: suppressions in the
  admission table (all-True ``[M, K]`` without selection), recovery sweeps
  with the re-admissions of their reconcile boundary, the keep fold on the
  per-RSU chains' coefficients and the partial trainer in the waves.
  Timeline faults under the EMA reconcile raise, as selection does.
- **Telemetry** is the fleet engine's too, per RSU: the histogram row of
  the RSU an upload landed on, the occupancy of each RSU row, and the
  handover flag of each admitted re-schedule counted at its source RSU.

The pytree program (``flat=False``, :func:`_run_pytree`) runs the same
queue, plan, segments and folds with the cohort stack a dict of ``[R,
...]`` leaves, each pop's upload mixed into its RSU's row on its own (the
fleet engine's ``aggregation.arrival_mix``: per leaf, or K2 with its
scalars on the card under ``use_kernel``) and a ring of every post-round
model.  Under a mesh with an ``"rsu"`` axis (``launch/mesh.py``,
``repro``'s ``shard_map`` over ``"rsu"``) it runs sharded: each rank holds
``R / n`` cohort rows and merges the pops that land on them, the queue
runs alike on every rank, and the ranks meet once a segment (the ring rows
a later wave reads) and at each reconcile and eval (a pmean of the rows'
means).

Wave-hoisted training is the fleet engine's (``core/jit_engine.py``).
Times on the device are f32; the f64 host plan (``corridor/plan.py``)
fixes pop order, serving RSUs, waves and minibatches, and afterwards the
device trace is checked against it: any divergence raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.channel import ChannelParams, CorridorMobility
from repro_torch.core.aggregation import arrival_mix, chain_coeffs
from repro_torch.core.client import VehicleData
from repro_torch.core.flat import ParamLayout
from repro_torch.core.jit_engine import (_SlotQueue, _stage_arrays,
                                         _train_wave, check_bandit,
                                         device_report, eval_rounds_of,
                                         keep_coeffs, metrics_channels,
                                         metrics_setup, readmit_points,
                                         upload_indices)
from repro_torch.core.mafl import SimResult, evaluate
from repro_torch.core.server import DEFAULT_FEDASYNC_MIX, RoundRecord
from repro_torch.corridor.plan import (CorridorPlan, plan_corridor,
                                       rsu_chain_groups)
from repro_torch.device import resolve_device
from repro_torch.faults import check_faults_reconcile
from repro_torch.kernels.weighted_agg import ops as agg_ops
from repro_torch.launch.mesh import (Axis, check_mesh_device, mesh_axis,
                                     pmean_tree, share_rows)
from repro_torch.selection import check_reconcile_mode, scenario_spec
from repro_torch.telemetry import PhaseTimers
from repro_torch.telemetry import device as tel_dev
from repro_torch.telemetry.spec import resolve_metrics

_SUPPORTED_SCHEMES = ("mafl", "afl", "fedasync")
_RSU_AXIS = "rsu"


def _rsu_axis(mesh, n_rsus: int):
    """The mesh's ``"rsu"`` axis when it shards the cohort stack, else None
    (no mesh, no such axis, or one of size 1: the unsharded program).  An
    axis that cannot tile the corridor raises: the caller asked for RSU
    sharding, and running replicated instead would misstate its cost."""
    rsu = mesh_axis(mesh, _RSU_AXIS)
    if rsu is None or rsu.size == 1:
        return None
    if n_rsus % rsu.size:
        raise ValueError(
            f"mesh '{_RSU_AXIS}' axis of size {rsu.size} cannot shard "
            f"{n_rsus} RSU cohorts (n_rsus must be divisible)")
    return rsu


def needed_rounds(plan: CorridorPlan) -> set:
    """Ring rows a later wave reads: the payload rounds.  Evals read the
    consensus, never the ring."""
    d = plan.dl_round
    needed = set()
    for T, _s, _e in plan.waves:
        needed |= {int(d[t]) + 1 for t in T if d[t] >= 0}
    return needed


def reconcile_rounds(rounds: int, reconcile_every: int) -> set:
    return set(range(reconcile_every, rounds + 1, reconcile_every))


def corridor_schedule(plan: CorridorPlan, eval_rounds: Sequence[int],
                      reconcile_every: int) -> list:
    """The engine's loop as host data: per wave ``(T, [(a, b, groups),
    ...])``, its segments ``[a, b)`` split at the eval, reconcile and
    re-admission rounds and each segment's :func:`rsu_chain_groups`.  One
    ``ring_agg`` launch per chunk.  Selection re-scores and fault
    recovery sweeps run only at reconcile boundaries, so their
    re-admissions add no split."""
    needed = needed_rounds(plan)
    stops = (set(eval_rounds) | set(readmit_points(plan))
             | reconcile_rounds(len(plan.veh), reconcile_every))
    out = []
    for T, s, e in plan.waves:
        segs, a = [], s
        for b in sorted({x for x in stops if s < x <= e} | {e}):
            if b > a:
                segs.append((a, b, rsu_chain_groups(plan, a, b, needed)))
            a = b
        out.append((T, segs))
    return out


def chain_launches(plan: CorridorPlan, eval_rounds: Sequence[int],
                   reconcile_every: int) -> int:
    """``ring_agg`` launches of one run: the chunks of every segment."""
    return sum(len(chunks)
               for _, segs in corridor_schedule(plan, eval_rounds,
                                                reconcile_every)
               for _, _, groups in segs for _, chunks in groups)


class _CorridorQueue(_SlotQueue):
    """The ``[R, K]`` slot queue and the Eq. 3-6 re-scheduler with the
    corridor geometry: span wrap, serving cell, distance to that cell's
    centre.  The constants are rounded to f32 as ``repro`` builds them
    (``centers`` in f64 from the f32 ``span`` and ``cell``, then cast)."""

    def __init__(self, p: ChannelParams, plan: CorridorPlan, gains, x0,
                 device):
        super().__init__(p, plan, gains, x0, device)
        R = plan.n_rsus
        self.R = R
        span = np.float32(2.0 * p.coverage * R)
        cell = np.float32(2.0 * p.coverage)
        self.span = float(span)
        self.half_span = float(span) / 2.0          # exact: f32(span) / 2
        # a device scalar: the card divides by a host scalar as a multiply
        # by its reciprocal, which may move a vehicle on a cell edge
        self.cell = torch.tensor(float(cell), dtype=torch.float32,
                                 device=device)
        self.centers = torch.from_numpy(
            (-float(span) / 2 + (np.arange(R) + 0.5) * float(cell))
            .astype(np.float32)).to(device)
        qt = np.full((R, p.K), np.inf, np.float32)
        qt[plan.row0, np.arange(p.K)] = plan.q0["time"]
        self.qt = torch.from_numpy(qt.reshape(-1)).to(device)

    def wrap(self, x):
        """Corridor wrap of a raw position (floored modulo, as jnp.mod)."""
        return torch.remainder(x + self.half_span, self.span) - self.half_span

    def serving(self, x):
        """The RSU whose cell holds corridor position ``x`` (int64)."""
        j = torch.floor((x + self.half_span) / self.cell).to(torch.int32)
        return j.clamp_(0, self.R - 1).long()

    def upload_delay(self, idx, t_up):
        """Eq. 3-6 with the corridor geometry for vehicles ``idx``
        uploading at ``t_up`` (both ``[n]`` device tensors)."""
        # int32 cast truncates toward zero, as astype(int32) does
        slot = t_up.to(torch.int32).clamp_(0, self.n_slots - 1)
        gain = self.gains.index_select(0, slot.long() * self.K + idx)
        x_up = self.wrap(self.x0.index_select(0, idx) + self.v * t_up)
        dc = x_up - self.centers.index_select(0, self.serving(x_up))
        dist = torch.sqrt(dc * dc + self.dy2H2)                 # Eq. 4
        snr = self.pm * gain * dist ** (-self.alpha) / self.sigma2
        rate = self.bw * torch.log2(1.0 + snr)                  # Eq. 5
        return self.bits / torch.clamp_min(rate, 1e-12)         # Eq. 6

    def readmit(self, idx, t_b):
        """Re-admit the parked vehicles ``idx`` at the boundary time
        ``t_b``: each slot lands in the row of the RSU serving its vehicle
        at the new arrival time (every row of a parked vehicle is +inf)."""
        t_up = t_b + self.qcl.index_select(0, idx)
        cu_new = self.upload_delay(idx, t_up)
        t_new = t_up + cu_new
        j_new = self.serving(self.wrap(self.x0.index_select(0, idx)
                                       + self.v * t_new))
        self.qt.index_copy_(0, j_new * self.K + idx, t_new)
        self.qdl.index_copy_(0, idx, t_b.expand_as(cu_new))
        self.qcu.index_copy_(0, idx, cu_new)

    def pop(self, mafl: bool, r: int):
        """Pop ``r``: take the earliest slot of the ``R*K`` column,
        re-schedule its vehicle (download now, train C_l, upload C_u)
        unless selection parks it, and migrate the slot to the row of the
        RSU serving the vehicle at its next arrival.  Returns one-element
        tensors: (vehicle, RSU, time, C_u, C_l, download time, delay
        weight); with ``occupancy`` also the live slots of each RSU row
        before the pop writes (``[1, R]``) and the handover flag (the
        re-schedule lands on another RSU; never for a parked vehicle)."""
        flat = torch.argmin(self.qt, dim=0, keepdim=True)
        occ = (torch.isfinite(self.qt.view(self.R, self.K)).sum(1)[None]
               if self.occupancy else None)
        j = torch.div(flat, self.K, rounding_mode="floor")
        i = flat - j * self.K
        t = self.qt.index_select(0, flat)
        cu = self.qcu.index_select(0, i)
        cl = self.qcl.index_select(0, i)
        dl_t = self.qdl.index_select(0, i)
        if mafl:                                                # Eqs. 7, 9
            weight = self.gamma ** (cu - 1.0) * self.zeta ** (cl - 1.0)
        else:
            weight = torch.ones_like(t)
        t_up = t + cl
        cu_new = self.upload_delay(i, t_up)
        t_new = t_up + cu_new
        j_new = self.serving(self.wrap(self.x0.index_select(0, i)
                                       + self.v * t_new))
        # a parked vehicle lands as +inf, so it is +inf in every row
        t_new = self.admit(r, i, t_new, cu, cl, weight, mafl)
        # leave row j, land in row j_new: the second write wins when equal
        self.qt.index_copy_(0, flat, self.inf)
        self.qt.index_copy_(0, j_new * self.K + i, t_new)
        self.qdl.index_copy_(0, i, t)
        self.qcu.index_copy_(0, i, cu_new)
        if occ is None:
            return i, j, t, cu, cl, dl_t, weight
        handover = j_new != j
        if self.adm is not None:
            handover &= self.adm[r].index_select(0, i)
        return i, j, t, cu, cl, dl_t, weight, occ, handover


def _loop_indices(schedule: list, readmit_at: dict) -> list:
    """Every index list the loop reads, in loop order: per wave its rows,
    then each segment's chain rounds, then the vehicles re-admitted at the
    segment's end."""
    lists = []
    for T, segs in schedule:
        lists.append(T)
        for _, b, groups in segs:
            lists.extend(chunk for _, chunks in groups for chunk in chunks)
            if b in readmit_at:
                lists.append(readmit_at[b])
    return lists


def _pop_segment(queue: _CorridorQueue, a: int, b: int, *, mafl: bool,
                 mst=None, fault_tab=None, on_pop=None):
    """Pops ``a..b-1`` of the ``[R, K]`` slot queue.  With metrics on,
    ``mst`` (``telemetry.device.corridor_state``) folds each pop, with row
    ``r`` of the fault counts table ``fault_tab`` where one is armed.
    ``on_pop(r, pop)`` (the pytree program's merge) runs after each pop.
    Nothing here reads a device value on the host.  Returns the segment's
    trace columns: seven, and with metrics the occupancy, the handover
    flag and the pop wait."""
    pops = []
    for r in range(a, b):
        pop = queue.pop(mafl, r)
        if mst is not None:
            pop += (tel_dev.corridor_pop(
                mst, t=pop[2], dl_t=pop[5], j=pop[1], handover=pop[8],
                fault_row=None if fault_tab is None else fault_tab[r]),)
        if on_pop is not None:
            on_pop(r, pop)
        pops.append(pop)
    return tuple(torch.cat(c) for c in zip(*pops))


def _chain_segment(queue: _CorridorQueue, G, locals_buf, ring: dict,
                   a: int, b: int, groups: list, chunk_idx, needed: set,
                   store, *, scheme: str, interpretation: str, beta: float,
                   fedasync_mix: float, mst=None, fault_tab=None):
    """The flat program's segment: pops ``a..b-1`` (:func:`_pop_segment`),
    their chain coefficients, and one ``ring_agg`` chain per chunk on each
    active RSU's row of ``G`` (written in place at the chain's end).  A
    chunk ending at a round in ``needed`` stores its output (a new tensor)
    as that ring row.  ``chunk_idx`` yields each chunk's rounds as a device
    tensor.  A cap-discarded pop stays in its chunk as a no-op
    (``keep_coeffs``).  Returns the segment's trace columns."""
    cols = _pop_segment(queue, a, b, mafl=scheme == "mafl", mst=mst,
                        fault_tab=fault_tab)
    _, _, t_c, _, _, dlt_c, w_c = cols[:7]
    cc, dd = chain_coeffs(scheme, interpretation, beta, w_c, t=t_c,
                          dl_t=dlt_c, fedasync_mix=fedasync_mix)
    cc, dd = keep_coeffs(queue, cc, dd, a, b)
    coeffs = torch.stack([cc, dd], dim=1)
    for j, chunks in groups:
        g = G[j]
        for chunk in chunks:
            idx = next(chunk_idx)
            g = agg_ops.ring_agg(g, locals_buf.index_select(0, idx),
                                 coeffs.index_select(0, idx - a))
            if chunk[-1] + 1 in needed:
                ring[chunk[-1] + 1] = store(g)
        G[j].copy_(g)
    return cols


def _stack_mean(G: dict, rsu: Optional[Axis] = None) -> dict:
    """The consensus of a cohort stack (a dict of ``[R, ...]`` leaves): the
    mean of its rows per leaf; under an ``"rsu"`` axis the mean of this
    rank's rows, then the pmean over the axis (``repro``'s order)."""
    cons = {k: x.mean(dim=0) for k, x in G.items()}
    return cons if rsu is None else pmean_tree(cons, rsu)


def _reconcile(G: dict, tau: float, use_kernel: bool,
               rsu: Optional[Axis] = None) -> dict:
    """The cloud tier on a cohort stack, a dict of ``[R, ...]`` leaves
    (the flat program's one ``[R, P]`` leaf, the pytree program's param
    dict, or this rank's rows of it under ``rsu``): every row moves ``tau``
    toward :func:`_stack_mean`, leaf by leaf (``tau = 1``, FedAvg: adopts
    it).  EMA under ``use_kernel`` is one ``weighted_agg`` merge of the
    whole stack against the materialised broadcast of the mean (the kernel
    takes contiguous leaves only).  Returns a new stack."""
    cons = _stack_mean(G, rsu)
    if tau == 1.0:
        return {k: c.expand_as(G[k]).contiguous() for k, c in cons.items()}
    # repro's f32 scalars: tau rounded to f32, 1 - tau in f32
    take = np.float32(tau)
    keep = float(np.float32(1.0) - take)
    if use_kernel:
        return agg_ops.weighted_agg_tree(
            G, {k: c.expand_as(G[k]).contiguous() for k, c in cons.items()},
            keep, 1.0)
    return {k: x * keep + cons[k] * float(take) for k, x in G.items()}


def _run_program(plan: CorridorPlan, queue: _CorridorQueue,
                 layout: ParamLayout, w0, imgs, labs, lr: float, *,
                 scheme: str, interpretation: str, beta: float,
                 fedasync_mix: float, ring_dtype: str, eval_rounds: tuple,
                 reconcile_every: int, tau: float, use_kernel: bool,
                 record_cohorts: bool, metrics=None, l_iters: int = 1,
                 data: Optional[Axis] = None):
    """The flat program: waves, segments and reconciles in plan order, each
    wave split over the mesh axis ``data`` where it divides
    (``jit_engine._train_wave``).  Returns the final ``[R, P]`` stack, the
    consensus rows of the eval rounds, the stack copies of the eval rounds
    (``record_cohorts``), the trace columns and, with ``metrics`` (a
    resolved ``MetricsSpec``), the device channels (else None)."""
    M = len(plan.veh)
    R = plan.n_rsus
    d = plan.dl_round
    device = imgs.device
    bf16 = ring_dtype == "bf16"
    store_dtype = torch.bfloat16 if bf16 else torch.float32
    # chain outputs are new tensors, stored as they are in f32
    store = ((lambda x: x.to(torch.bfloat16)) if bf16 else (lambda x: x))
    mst = fault_tab = ring_stats = None
    if metrics is not None:
        mst, fault_tab, ring_stats, store = metrics_setup(
            metrics, plan, l_iters, bf16, store, device,
            tel_dev.corridor_state)
        queue.occupancy = True
    needed = needed_rounds(plan)
    reconciles = reconcile_rounds(M, reconcile_every)
    schedule = corridor_schedule(plan, eval_rounds, reconcile_every)
    readmit_at = readmit_points(plan)
    indices = iter(upload_indices(_loop_indices(schedule, readmit_at),
                                  device))

    w = layout.pack(w0)
    G = w.repeat(R, 1)                          # f32[R, P] cohort stack
    locals_buf = torch.zeros((M, layout.P), dtype=store_dtype, device=device)
    ring = {0: store(w)}
    cons, cohorts, traces = [], [], []
    for T, segs in schedule:
        T_dev = next(indices)
        if len(T):
            loc = _train_wave(ring, d[np.asarray(T, np.int64)] + 1, T_dev,
                              imgs, labs, lr, queue.epochs,
                              unpack=layout.unpack, data=data)
            locals_buf.index_copy_(0, T_dev,
                                   layout.pack(loc, dtype=store_dtype))
        for a, b, groups in segs:
            traces.append(_chain_segment(
                queue, G, locals_buf, ring, a, b, groups, indices, needed,
                store, scheme=scheme, interpretation=interpretation,
                beta=beta, fedasync_mix=fedasync_mix, mst=mst,
                fault_tab=fault_tab))
            if b in reconciles:
                G = _reconcile({"G": G}, tau, use_kernel)["G"]
                if b in needed:
                    # the boundary's re-download follows the reconcile: a
                    # copy of the reconciled row its upload landed on
                    row = G[int(plan.up_rsu[b - 1])]
                    ring[b] = row.to(store_dtype, copy=True)
                    if ring_stats is not None:
                        ring_stats.count(ring[b])
            if b in readmit_at:
                # after the reconcile: a re-admitted (or recovered) vehicle
                # downloads ring[b], at pop b-1's time
                queue.readmit(next(indices), traces[-1][2][-1:])
            if b in eval_rounds:
                cons.append(G.mean(dim=0))
                if record_cohorts:
                    cohorts.append(G.clone())
    trace = tuple(torch.cat([tr[k] for tr in traces])
                  for k in range(len(traces[0])))
    channels = None
    if mst is not None:
        trace, (occ, handover, gap) = trace[:7], trace[7:]
        channels = metrics_channels(mst, ring_stats, occ, gap)
        channels["handover"] = handover
    return G, cons, cohorts, trace, channels


def _share_ring(ring: dict, rounds: list, up_rsu: np.ndarray, off: int,
                Rl: int, rsu: Axis, like: dict) -> None:
    """Ring rows ``rounds`` (post-round models, keyed by round) to every
    rank of ``rsu``, each from the rank holding the cohort its pop landed
    on (``up_rsu[round - 1]`` in ``[off, off + Rl)``), in one collective.
    ``like`` gives the leaves' shapes and dtypes."""
    if not rounds:
        return
    mine = {p: {k: v[None] for k, v in ring[x].items()}
            for p, x in enumerate(rounds) if 0 <= up_rsu[x - 1] - off < Rl}
    rows = share_rows(mine, len(rounds), like, rsu)
    for p, x in enumerate(rounds):
        ring[x] = {k: v[p] for k, v in rows.items()}


def _run_pytree(plan: CorridorPlan, queue: _CorridorQueue, w0, imgs, labs,
                lr: float, *, scheme: str, interpretation: str, beta: float,
                fedasync_mix: float, eval_rounds: tuple,
                reconcile_every: int, tau: float, use_kernel: bool,
                record_cohorts: bool, metrics=None, l_iters: int = 1,
                rsu: Optional[Axis] = None, data: Optional[Axis] = None):
    """The pytree program (``flat=False``): the cohort stack is a dict of
    ``[R, ...]`` leaves.  Each pop reads the row of the RSU it landed on
    (``index_select`` on the device index), mixes its upload into it
    (:func:`aggregation.arrival_mix`, the fleet engine's definition: per
    leaf, or K2's device form under ``use_kernel``), keeps the row where
    the staleness cap discards the pop, and writes it back in place
    (``index_copy_``).  The ring keeps every post-round model: ``ring[r+1]``
    is pop ``r``'s new row, a new tensor that no later write touches, and
    at a reconcile round ``b`` a copy of the reconciled row of
    ``up_rsu[b-1]``.  Segments split at the eval, reconcile and
    re-admission rounds, as the flat program's; waves split over the mesh
    axis ``data`` where it divides (``jit_engine._train_wave``).

    Under an ``"rsu"`` axis ``rsu`` (``repro``'s ``shard_map`` over it,
    ``_rsu_axis``) this rank holds rows ``[off, off + R/n)`` of the stack.
    Every rank runs the same pops; the rank holding a pop's RSU (the
    plan's ``up_rsu``, which the trace is checked against after the run)
    merges it.  The ring rows a later wave reads reach every rank once a
    segment (:func:`_share_ring`, after the segment's reconcile); the
    reconcile and the consensus are the mean of the local rows then a
    pmean over the axis; the returned stack and the ``record_cohorts``
    copies are gathered whole.

    Returns the final stack, the consensus models of the eval rounds, the
    stack copies of the eval rounds (``record_cohorts``), the trace columns
    and the device channels (or None)."""
    M = len(plan.veh)
    R = plan.n_rsus
    d = plan.dl_round
    device = imgs.device
    n = 1 if rsu is None else rsu.size
    Rl, off = R // n, (0 if rsu is None else rsu.index * (R // n))
    mst = fault_tab = None
    if metrics is not None:
        mst, fault_tab, _, _ = metrics_setup(
            metrics, plan, l_iters, False, None, device,
            tel_dev.corridor_state)
        queue.occupancy = True
    reconciles = reconcile_rounds(M, reconcile_every)
    needed = needed_rounds(plan)
    # the flat program's segments; their chain groups go unused here
    schedule = corridor_schedule(plan, eval_rounds, reconcile_every)
    readmit_at = readmit_points(plan)
    idx = upload_indices([T for T, _ in schedule]
                         + [readmit_at[b] for b in sorted(readmit_at)]
                         + [range(Rl)], device)
    wave_idx = idx[:len(schedule)]
    readmits = dict(zip(sorted(readmit_at), idx[len(schedule):-1]))
    local_rows = idx[-1]

    G = {k: x.expand((Rl,) + tuple(x.shape)).contiguous()
         for k, x in w0.items()}
    uploads = {k: torch.zeros((M,) + tuple(x.shape), dtype=x.dtype,
                              device=device) for k, x in w0.items()}
    ring = {0: dict(w0)}

    def merge(r: int, pop):
        if rsu is None:
            j = pop[1]
        else:
            jl = int(plan.up_rsu[r]) - off
            if not 0 <= jl < Rl:
                return                      # another rank's cohort
            j = local_rows[jl:jl + 1]
        row = {k: x.index_select(0, j) for k, x in G.items()}
        new = arrival_mix(
            row, {k: B[r:r + 1] for k, B in uploads.items()}, pop[6],
            scheme=scheme, interpretation=interpretation, beta=beta,
            t=pop[2], dl_t=pop[5], fedasync_mix=fedasync_mix,
            use_kernel=use_kernel,
            keep=None if queue.keep is None else queue.keep[r])
        for k, x in G.items():
            x.index_copy_(0, j, new[k])
        ring[r + 1] = {k: v[0] for k, v in new.items()}

    cons, cohorts, traces = [], [], []
    for (T, segs), T_dev in zip(schedule, wave_idx):
        if len(T):
            loc = _train_wave(ring, d[np.asarray(T, np.int64)] + 1, T_dev,
                              imgs, labs, lr, queue.epochs, data=data)
            for k, B in uploads.items():
                B.index_copy_(0, T_dev, loc[k])
        for a, b, _ in segs:
            traces.append(_pop_segment(
                queue, a, b, mafl=scheme == "mafl", mst=mst,
                fault_tab=fault_tab, on_pop=merge))
            if b in reconciles:
                G = _reconcile(G, tau, use_kernel, rsu)
                # the boundary's re-download follows the reconcile: a copy
                # of the reconciled row its upload landed on (G is written
                # in place later), on the rank that holds it
                j = int(plan.up_rsu[b - 1]) - off
                if 0 <= j < Rl:
                    ring[b] = {k: x[j].clone() for k, x in G.items()}
            if rsu is not None:
                _share_ring(ring, [x for x in range(a + 1, b + 1)
                                   if x in needed], plan.up_rsu, off, Rl,
                            rsu, w0)
            if b in readmit_at:
                queue.readmit(readmits[b], traces[-1][2][-1:])
            if b in eval_rounds:
                cons.append(_stack_mean(G, rsu))
                if record_cohorts:
                    cohorts.append({k: x.clone() for k, x in G.items()}
                                   if rsu is None
                                   else share_rows({off: G}, R, w0, rsu))
    trace = tuple(torch.cat([tr[k] for tr in traces])
                  for k in range(len(traces[0])))
    channels = None
    if mst is not None:
        trace, (occ, handover, gap) = trace[:7], trace[7:]
        channels = metrics_channels(mst, None, occ, gap)
        channels["handover"] = handover
    if rsu is not None:
        G = share_rows({off: G}, R, w0, rsu)
    return G, cons, cohorts, trace, channels


def _check_corridor_args(scheme, mode, ring_dtype, flat):
    if scheme not in _SUPPORTED_SCHEMES:
        raise ValueError(
            f"engine='corridor' supports schemes {_SUPPORTED_SCHEMES}, not "
            f"{scheme!r} (fedbuff keeps host-side buffer state — use "
            "engine='serial')")
    if mode not in ("fedavg", "ema"):
        raise ValueError(f"unknown reconcile_mode {mode!r}; "
                         "expected 'fedavg' or 'ema'")
    if ring_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown ring_dtype {ring_dtype!r}; "
                         "expected 'f32' or 'bf16'")
    if ring_dtype == "bf16" and flat is False:
        raise ValueError(_BF16_FLAT)


_BF16_FLAT = ("ring_dtype='bf16' requires the flat fast path (unsharded "
              "corridor): only the packed ring stores bf16 snapshots around "
              "the f32 stack")


def _check_sharded_args(ring_dtype, flat) -> None:
    """The refusals of an ``"rsu"``-sharded run, ``repro``'s: the sharded
    stack keeps the pytree layout, so neither the flat program nor the
    bf16 ring runs under it."""
    if flat:
        raise ValueError(
            "flat fast path does not run under an 'rsu'-sharded mesh — the "
            "sharded cohort stack keeps the pytree layout (pass flat=False "
            "or drop the mesh)")
    if ring_dtype == "bf16":
        raise ValueError(_BF16_FLAT)


def run_corridor_simulation(
    sc,
    vehicles_data: Sequence[VehicleData],
    test_images: np.ndarray,
    test_labels: np.ndarray,
    p: Optional[ChannelParams] = None,
    *,
    seed: int = 0,
    eval_every: int = 10,
    interpretation: str = "mixing",
    use_kernel: bool = False,
    progress=None,
    batch_size: int = 128,
    mesh=None,
    record_cohorts: bool = False,
    init_params=None,
    selection=None,
    flat: Optional[bool] = None,
    metrics=None,
    faults=None,
    device=None,
) -> SimResult:
    """Run ``sc.rounds`` corridor arrivals on the device; returns the
    ``SimResult`` the serial handover loop produces (same record fields,
    same eval cadence, per-RSU round numbers, ``rec.rsu`` set).

    ``flat=None`` (unsharded) or ``True`` runs the packed flat program:
    aggregation is always the fused ``ring_agg`` chain (its plain version
    on the CPU).
    ``flat=False`` runs the pytree program: each arrival is merged into its
    cohort row on its own, by per-leaf f32 ops or, under ``use_kernel``,
    by one ``weighted_agg`` launch with its scalars on the card.  On both,
    ``use_kernel`` routes the EMA reconcile through ``weighted_agg``.
    ``sc.ring_dtype="bf16"`` (flat only; with ``flat=False`` it raises
    ``ValueError``) stores ring and upload rows in bf16 around the f32
    stack.  ``result.extras`` holds ``n_rsus``, the
    serving-RSU trace ``up_rsu``, ``eval_rounds``, ``final_cohorts`` (the
    ``[R, ...]`` stack as a param dict) and, with ``record_cohorts``,
    ``cohort_snapshots`` per eval round.  Under ``selection`` (or the
    scenario's policy) ``result.report.selection`` holds the plan's
    ``summary()``; selection re-scores at every reconcile boundary and
    raises ``ValueError`` with the EMA reconcile.  ``faults`` (a profile
    name or ``FaultSpec``) is replayed by the plan with recovery sweeps at
    the reconcile boundaries; ``extras["faults"]`` holds its
    ``summary(sc.l_iters)`` and ``result.report.faults`` its spec and
    counts; faults that suppress re-schedules raise ``ValueError`` with
    the EMA reconcile.  ``progress`` fires after the run, in round order.
    ``device=None`` runs on the card.

    ``metrics="on"`` folds the fleet engine's channels per RSU into the
    event loop on the device (``[R, B]`` histogram, ``[M, R]`` occupancy,
    the handover flag and its per-RSU count, fault counters, ring guard);
    ``result.report`` (engine ``"corridor"``) holds them.  Any falsy value
    runs the loop without telemetry, op for op.

    ``mesh`` (``launch/mesh.py``, on ``device``'s type; every rank of it
    calls this function alike) shards the cohort stack over its ``"rsu"``
    axis, whose size must divide ``n_rsus``, on the pytree program
    (``flat=None`` selects it; ``flat=True`` and the bf16 ring raise
    ``ValueError``), and each wave's training over its ``"data"`` axis
    where the wave's length divides.  An ``"rsu"`` axis of size 1 runs the
    unsharded program.  Every rank returns the same result."""
    scheme = sc.scheme
    mode = getattr(sc, "reconcile_mode", "fedavg")
    spec = selection if selection is not None else scenario_spec(sc)
    check_reconcile_mode(spec, mode)
    check_faults_reconcile(faults, mode)
    ring_dtype = getattr(sc, "ring_dtype", "f32")
    _check_corridor_args(scheme, mode, ring_dtype, flat)
    device = resolve_device(device)
    check_mesh_device(mesh, device)
    rsu = _rsu_axis(mesh, sc.n_rsus)
    if rsu is not None:
        _check_sharded_args(ring_dtype, flat)
    timers = PhaseTimers()
    p = p if p is not None else sc.channel()
    if len(vehicles_data) != p.K:
        raise ValueError(
            f"{len(vehicles_data)} vehicle shards for K={p.K} vehicles")
    M = sc.rounds
    if M < 1:
        raise ValueError("rounds must be >= 1")
    R = sc.n_rsus
    entry = getattr(sc, "corridor_entry", "uniform")
    with timers.phase("plan"):
        plan = plan_corridor(p, R, seed, M, entry=entry, selection=spec,
                             reconcile_every=sc.reconcile_every,
                             faults=faults, l_iters=sc.l_iters)
        met = resolve_metrics(
            metrics, stale=plan.times - plan.download_time,
            times=plan.times, n_rsus=R, ring_guard=(ring_dtype == "bf16"),
            fault_counters=plan.flt is not None)
    with timers.phase("stage"):
        w0, imgs, labs, gains = _stage_arrays(
            vehicles_data, p, plan, l_iters=sc.l_iters, lr=sc.lr, seed=seed,
            init_params=init_params, batch_size=batch_size, device=device)
        x0 = torch.from_numpy(CorridorMobility(p, R, entry=entry).x0
                              .astype(np.float32)).to(device)
        queue = _CorridorQueue(p, plan, gains, x0, device)
    eval_rounds = eval_rounds_of(M, eval_every)
    tau = float(getattr(sc, "reconcile_tau", 0.5)) if mode == "ema" else 1.0
    common = dict(scheme=scheme, interpretation=interpretation, beta=p.beta,
                  fedasync_mix=DEFAULT_FEDASYNC_MIX, eval_rounds=eval_rounds,
                  reconcile_every=sc.reconcile_every, tau=tau,
                  use_kernel=use_kernel, record_cohorts=record_cohorts,
                  metrics=met, l_iters=sc.l_iters,
                  data=mesh_axis(mesh, "data"))
    with timers.phase("run"):
        if flat is False or rsu is not None:
            G, cons, cohorts, trace, met_dev = _run_pytree(
                plan, queue, w0, imgs, labs, sc.lr, rsu=rsu, **common)
            unpack = dict                # already param dicts: a new dict
        else:
            layout = ParamLayout.from_tree(w0)
            G, cons, cohorts, trace, met_dev = _run_program(
                plan, queue, layout, w0, imgs, labs, sc.lr,
                ring_dtype=ring_dtype, **common)
            unpack = layout.unpack
        # reading the trace waits for the card: the run ends here
        t_veh, t_rsu, t_time, t_cu, t_cl, _t_dlt, t_w = (x.cpu().numpy()
                                                         for x in trace)

    # divergence guards: minibatches and the cohort/ring pairing were
    # planned on the host, so a device pop order or serving cell that
    # disagrees fails loudly instead of mis-pairing them
    if not np.array_equal(t_veh, plan.veh):
        bad = int(np.argmax(t_veh != plan.veh))
        raise RuntimeError(
            "corridor engine: device pop order diverged from the host dry "
            f"run at round {bad} (device vehicle {int(t_veh[bad])}, host "
            f"{int(plan.veh[bad])}) — f32 time ties are not expected")
    if not np.array_equal(t_rsu, plan.up_rsu):
        bad = int(np.argmax(t_rsu != plan.up_rsu))
        raise RuntimeError(
            "corridor engine: device serving-RSU assignment diverged from "
            f"the host dry run at round {bad} (device RSU {int(t_rsu[bad])},"
            f" host {int(plan.up_rsu[bad])}) — an f32 boundary flip is not "
            "expected")
    if not np.allclose(t_time, plan.times, rtol=1e-4, atol=1e-3):
        bad = int(np.argmax(~np.isclose(t_time, plan.times,
                                        rtol=1e-4, atol=1e-3)))
        raise RuntimeError(
            "corridor engine: device event times diverged from the host "
            f"dry run at round {bad}: {t_time[bad]} vs {plan.times[bad]}")
    check_bandit(queue, plan, "corridor engine")
    if ring_dtype == "bf16" and not bool(torch.isfinite(G).all()):
        raise RuntimeError(
            "corridor engine: non-finite cohort stack under "
            "ring_dtype='bf16' — the quantized snapshot ring diverged "
            "(rerun with ring_dtype='f32' to bisect)")

    result = SimResult(scheme=f"{scheme}+corridor", rounds=[],
                       acc_history=[], loss_history=[])
    test_images = torch.as_tensor(test_images, device=device)
    test_labels = torch.as_tensor(test_labels, device=device)
    per_rsu_round = np.zeros(R, np.int64)
    eval_idx = {rr: k for k, rr in enumerate(eval_rounds)}
    with timers.phase("eval"):
        for r in range(M):
            j = int(t_rsu[r])
            per_rsu_round[j] += 1
            rec = RoundRecord(round=int(per_rsu_round[j]),
                              time=float(t_time[r]), vehicle=int(t_veh[r]),
                              upload_delay=float(t_cu[r]),
                              train_delay=float(t_cl[r]),
                              weight=float(t_w[r]), rsu=j)
            rr = r + 1
            if rr in eval_idx:
                acc, loss = evaluate(unpack(cons[eval_idx[rr]]),
                                     test_images, test_labels,
                                     device=device)
                rec.accuracy, rec.loss = acc, loss
                result.acc_history.append((rr, acc))
                result.loss_history.append((rr, loss))
                if progress:
                    progress(rr, acc)
            result.rounds.append(rec)
    result.final_params = unpack(cons[eval_idx[M]])
    result.extras = {
        "n_rsus": R,
        "up_rsu": t_rsu,
        "eval_rounds": list(eval_rounds),
        "final_cohorts": unpack(G),
    }
    if record_cohorts:
        result.extras["cohort_snapshots"] = [unpack(c) for c in cohorts]
    if plan.flt is not None:
        result.extras["faults"] = plan.flt.summary(sc.l_iters)
    result.report = device_report(
        engine="corridor", scheme=f"{scheme}+corridor", rounds=M, seed=seed,
        met=met, met_dev=met_dev, plan=plan, queue=queue, p=p,
        l_iters=sc.l_iters, cu=t_cu, cl=t_cl, timers=timers, device=device)
    return result
