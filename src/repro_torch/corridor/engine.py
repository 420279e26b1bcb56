"""Device corridor engine (``engine="corridor"``): the round loop of
``repro.corridor.engine``'s packed flat program, run eagerly on the card.

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
from repro_torch.core.aggregation import chain_coeffs
from repro_torch.core.client import VehicleData
from repro_torch.core.flat import ParamLayout
from repro_torch.core.jit_engine import (_SlotQueue, _stage_arrays,
                                         _train_wave, check_bandit,
                                         eval_rounds_of, keep_coeffs,
                                         readmit_points, upload_indices)
from repro_torch.core.mafl import SimResult, evaluate, unported
from repro_torch.core.server import DEFAULT_FEDASYNC_MIX, RoundRecord
from repro_torch.corridor.plan import (CorridorPlan, plan_corridor,
                                       rsu_chain_groups)
from repro_torch.device import resolve_device
from repro_torch.faults import check_faults_reconcile
from repro_torch.kernels.weighted_agg import ops as agg_ops
from repro_torch.selection import check_reconcile_mode, scenario_spec

_SUPPORTED_SCHEMES = ("mafl", "afl", "fedasync")


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
        weight)."""
        flat = torch.argmin(self.qt, dim=0, keepdim=True)
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
        return i, j, t, cu, cl, dl_t, weight


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


def _chain_segment(queue: _CorridorQueue, G, locals_buf, ring: dict,
                   a: int, b: int, groups: list, chunk_idx, needed: set,
                   store, *, scheme: str, interpretation: str, beta: float,
                   fedasync_mix: float):
    """Pops ``a..b-1``, their chain coefficients, and one ``ring_agg``
    chain per chunk on each active RSU's row of ``G`` (written in place at
    the chain's end).  A chunk ending at a round in ``needed`` stores its
    output (a new tensor) as that ring row.  ``chunk_idx`` yields each
    chunk's rounds as a device tensor.  A cap-discarded pop stays in its
    chunk as a no-op (``keep_coeffs``).  Nothing here reads a device value
    on the host.  Returns the segment's seven trace columns."""
    pops = [queue.pop(scheme == "mafl", r) for r in range(a, b)]
    cols = tuple(torch.cat(c) for c in zip(*pops))
    _, _, t_c, _, _, dlt_c, w_c = cols
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


def _reconcile(G, tau: float, use_kernel: bool):
    """The cloud tier on the ``[R, P]`` stack: every row moves ``tau``
    toward the stack mean (``tau = 1``, FedAvg: adopts it).  EMA under
    ``use_kernel`` is one ``weighted_agg`` launch on the whole stack
    against the materialised broadcast of the mean (the kernel takes
    contiguous leaves only).  Returns a new stack."""
    cons = G.mean(dim=0)
    if tau == 1.0:
        return cons.expand_as(G).contiguous()
    # repro's f32 scalars: tau rounded to f32, 1 - tau in f32
    take = np.float32(tau)
    keep = float(np.float32(1.0) - take)
    if use_kernel:
        return agg_ops.weighted_agg_tree(
            {"G": G}, {"G": cons.expand_as(G).contiguous()}, keep,
            1.0)["G"]
    return G * keep + cons * float(take)


def _run_program(plan: CorridorPlan, queue: _CorridorQueue,
                 layout: ParamLayout, w0, imgs, labs, lr: float, *,
                 scheme: str, interpretation: str, beta: float,
                 fedasync_mix: float, ring_dtype: str, eval_rounds: tuple,
                 reconcile_every: int, tau: float, use_kernel: bool,
                 record_cohorts: bool):
    """The flat program: waves, segments and reconciles in plan order.
    Returns the final ``[R, P]`` stack, the consensus rows of the eval
    rounds, the stack copies of the eval rounds (``record_cohorts``) and
    the trace columns."""
    M = len(plan.veh)
    R = plan.n_rsus
    d = plan.dl_round
    device = imgs.device
    bf16 = ring_dtype == "bf16"
    store_dtype = torch.bfloat16 if bf16 else torch.float32
    # chain outputs are new tensors, stored as they are in f32
    store = ((lambda x: x.to(torch.bfloat16)) if bf16 else (lambda x: x))
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
            _train_wave(layout, ring, locals_buf,
                        d[np.asarray(T, np.int64)] + 1, T_dev, imgs, labs,
                        lr, queue.epochs)
        for a, b, groups in segs:
            traces.append(_chain_segment(
                queue, G, locals_buf, ring, a, b, groups, indices, needed,
                store, scheme=scheme, interpretation=interpretation,
                beta=beta, fedasync_mix=fedasync_mix))
            if b in reconciles:
                G = _reconcile(G, tau, use_kernel)
                if b in needed:
                    # the boundary's re-download follows the reconcile: a
                    # copy of the reconciled row its upload landed on
                    row = G[int(plan.up_rsu[b - 1])]
                    ring[b] = row.to(store_dtype, copy=True)
            if b in readmit_at:
                # after the reconcile: a re-admitted (or recovered) vehicle
                # downloads ring[b], at pop b-1's time
                queue.readmit(next(indices), traces[-1][2][-1:])
            if b in eval_rounds:
                cons.append(G.mean(dim=0))
                if record_cohorts:
                    cohorts.append(G.clone())
    trace = tuple(torch.cat([tr[k] for tr in traces]) for k in range(7))
    return G, cons, cohorts, trace


def _check_corridor_args(scheme, mode, ring_dtype, flat, mesh, metrics):
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
    if metrics not in (None, "off", False):
        raise unported("run metrics", "telemetry (item 10)")
    if mesh is not None:
        raise unported("the 'rsu'-sharded corridor (mesh)",
                       "distribution (item 13)")
    if flat is False:
        raise unported("engine='corridor' with flat=False (the pytree "
                       "program)", "pytree corridor program (item 15)")


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

    Aggregation is always the fused ``ring_agg`` chain (its plain version
    on the CPU); ``use_kernel`` routes the EMA reconcile through
    ``weighted_agg``.  ``sc.ring_dtype="bf16"`` stores ring and upload rows
    in bf16 around the f32 stack.  ``result.extras`` holds ``n_rsus``, the
    serving-RSU trace ``up_rsu``, ``eval_rounds``, ``final_cohorts`` (the
    ``[R, ...]`` stack as a param dict) and, with ``record_cohorts``,
    ``cohort_snapshots`` per eval round, and under ``selection`` (or the
    scenario's policy) ``selection``, the plan's ``summary()``.
    Selection re-scores at every reconcile boundary and raises
    ``ValueError`` with the EMA reconcile.  ``faults`` (a profile name or
    ``FaultSpec``) is replayed by the plan with recovery sweeps at the
    reconcile boundaries, and ``extras["faults"]`` holds its
    ``summary(sc.l_iters)``; faults that suppress re-schedules raise
    ``ValueError`` with the EMA reconcile.  ``progress`` fires after the
    run, in round order.  ``device=None`` runs on the card.

    Not ported yet, and raising: ``flat=False``, ``mesh`` and ``metrics``
    other than None/"off"."""
    scheme = sc.scheme
    mode = getattr(sc, "reconcile_mode", "fedavg")
    spec = selection if selection is not None else scenario_spec(sc)
    check_reconcile_mode(spec, mode)
    check_faults_reconcile(faults, mode)
    ring_dtype = getattr(sc, "ring_dtype", "f32")
    _check_corridor_args(scheme, mode, ring_dtype, flat, mesh, metrics)
    device = resolve_device(device)
    p = p if p is not None else sc.channel()
    if len(vehicles_data) != p.K:
        raise ValueError(
            f"{len(vehicles_data)} vehicle shards for K={p.K} vehicles")
    M = sc.rounds
    if M < 1:
        raise ValueError("rounds must be >= 1")
    R = sc.n_rsus
    entry = getattr(sc, "corridor_entry", "uniform")
    plan = plan_corridor(p, R, seed, M, entry=entry, selection=spec,
                         reconcile_every=sc.reconcile_every,
                         faults=faults, l_iters=sc.l_iters)
    w0, imgs, labs, gains = _stage_arrays(
        vehicles_data, p, plan, l_iters=sc.l_iters, lr=sc.lr, seed=seed,
        init_params=init_params, batch_size=batch_size, device=device)
    x0 = torch.from_numpy(CorridorMobility(p, R, entry=entry).x0
                          .astype(np.float32)).to(device)
    queue = _CorridorQueue(p, plan, gains, x0, device)
    layout = ParamLayout.from_tree(w0)
    eval_rounds = eval_rounds_of(M, eval_every)
    tau = float(getattr(sc, "reconcile_tau", 0.5)) if mode == "ema" else 1.0
    G, cons, cohorts, trace = _run_program(
        plan, queue, layout, w0, imgs, labs, sc.lr, scheme=scheme,
        interpretation=interpretation, beta=p.beta,
        fedasync_mix=DEFAULT_FEDASYNC_MIX, ring_dtype=ring_dtype,
        eval_rounds=eval_rounds, reconcile_every=sc.reconcile_every,
        tau=tau, use_kernel=use_kernel, record_cohorts=record_cohorts)
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
            acc, loss = evaluate(layout.unpack(cons[eval_idx[rr]]),
                                 test_images, test_labels, device=device)
            rec.accuracy, rec.loss = acc, loss
            result.acc_history.append((rr, acc))
            result.loss_history.append((rr, loss))
            if progress:
                progress(rr, acc)
        result.rounds.append(rec)
    result.final_params = layout.unpack(cons[eval_idx[M]])
    result.extras = {
        "n_rsus": R,
        "up_rsu": t_rsu,
        "eval_rounds": list(eval_rounds),
        "final_cohorts": layout.unpack(G),
    }
    if record_cohorts:
        result.extras["cohort_snapshots"] = [layout.unpack(c)
                                             for c in cohorts]
    if plan.sel is not None:
        result.extras["selection"] = plan.sel.summary()
    if plan.flt is not None:
        result.extras["faults"] = plan.flt.summary(sc.l_iters)
    return result
