"""Multi-world sweep engine (``engine="vmap"``, repro's DESIGN.md §15).

Every curve the paper reports is a grid of independent worlds (the Fig. 5
beta ablation, the seed averaging behind every curve, selection-policy
comparisons) that differ only in scalars (beta, seed, channel constants) or
plan data (admission tables).  Run one by one, each world keeps the card
mostly idle: a pop is a handful of one-element launches.  This engine runs
W worlds through the fleet engine's loop (``core/jit_engine.py``) with a
leading world axis, so one pop, one ``ring_agg`` chain and, for worlds
that share a timeline, one training call serve them all:

- **World axis on the flat buffers.**  The W models are one f32 ``[W, P]``
  master, the uploads one ``[W, M, P]`` buffer (f32 or the bf16 ring), the
  slot queues ``[W, K]`` columns and the gain tables one ``[W, S_max, K]``
  table, zero-padded as ``repro`` pads them (:func:`stack_gain_tables`).
  A pop is ``argmin`` over each world's row; reads and writes go through
  flat ``w * K + i`` indices that stay on the device, so the loop never
  waits for the card.
- **The union plan.**  Every world's f64 plan (``plan_fleet``) fixes its
  pops and waves.  A ``ring_agg`` chain ends at the union of every world's
  stored rounds and of the wave starts where any world trains
  (:func:`chain_ends`); a world's re-admissions are written between its
  two pops wherever they fall.  Splitting a chain is exact (the kernel's
  step rounds each product and the sum on its own, in upload order), so
  each world's chain result is its solo run's bit for bit, and one launch
  serves all W worlds.
- **Scalars as the solo engine rounds them.**  A channel scalar equal
  across the batch stays the solo engine's Python f32 constant; one that
  varies becomes an f32 ``[W, 1]`` column of the same f32 values, used in
  the same expressions.  The path-loss exponent ``alpha`` must be uniform,
  as in ``repro``.  Elementwise f32 functions on the card do not depend on
  the tensor's shape, so a world's times are its solo run's bit for bit;
  on the CPU that holds for fewer than 16 worlds (PyTorch's vectorised
  ``pow``/``log2`` take over from 16 elements on).
- **Training by timeline group** (``repro``'s grouping key): a world alone
  in its group trains through the solo ``_train_wave``, so its params are
  its solo run's bit for bit; worlds that share a timeline (one seed at
  several betas) train as one call over their stacked ``[nG * |T|]``
  payload rows with the group's minibatches repeated, written into
  ``locals_buf`` in one ``index_copy_``.  Batched convolutions sum in
  another order than the shared-payload ones, so such a world stays within
  an f32 band of its solo run, not bitwise.
- **Selection** is the ``[W, M, K]`` admission table (all-True for a world
  without a policy: ``where(True, x, inf) == x``), re-admissions are
  written per world between two pops, and eps-bandit keeps ``[W, K]``
  reward accumulators, each checked against its world's host replay.

Per world, as ``repro``: the pop order must equal the f64 plan, the times
agree within rtol 1e-4 / atol 1e-3, the bandit accumulators the replay,
and under the bf16 ring the master stays finite; else ``RuntimeError``.
The entry points are :class:`repro_torch.core.scenarios.SweepSpec` /
``run_sweep`` and ``run_scenario(..., engine="vmap")`` (a W = 1 batch).
No metrics, faults, multi-RSU worlds or fedbuff, and they raise with
``repro``'s text.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from repro_torch.channel import Mobility, slot_gain_table
from repro_torch.core import client as client_mod
from repro_torch.core.aggregation import chain_coeffs
from repro_torch.core.flat import ParamLayout
from repro_torch.core.jit_engine import (_SUPPORTED_SCHEMES, _train_wave,
                                         check_bandit, eval_rounds_of,
                                         needed_rounds, plan_fleet,
                                         readmit_points, stage_minibatches,
                                         upload_indices)
from repro_torch.core.mafl import SimResult, evaluate
from repro_torch.core.server import DEFAULT_FEDASYNC_MIX, RoundRecord
from repro_torch.device import resolve_device
from repro_torch.faults import scenario_faults
from repro_torch.kernels.weighted_agg import ops as agg_ops
from repro_torch.models.cnn import init_cnn
from repro_torch.telemetry import PhaseTimers, RunReport, memory_stats
from repro_torch.telemetry.report import wave_stats
from repro_torch.telemetry.spec import metrics_requested


def stack_plan_tables(tables: Sequence[dict]) -> dict:
    """Stack per-world plan tables along a leading world axis.

    Every world must emit the same keys with identical ``(shape, dtype)``
    — the PLN003 invariant; a mismatch raises with the offending field
    instead of silently broadcasting."""
    if not tables:
        raise ValueError("stack_plan_tables: empty world batch")
    keys = list(tables[0])
    for i, t in enumerate(tables[1:], 1):
        if list(t) != keys:
            raise ValueError(
                f"plan tables not stackable: world 0 has fields {keys}, "
                f"world {i} has {list(t)} — planner emissions must be "
                "field-stable across worlds (rule PLN003)")
    out = {}
    for k in keys:
        arrs = [np.asarray(t[k]) for t in tables]
        base = (arrs[0].shape, arrs[0].dtype)
        for i, a in enumerate(arrs[1:], 1):
            if (a.shape, a.dtype) != base:
                raise ValueError(
                    f"plan table {k!r} not stackable: world 0 is {base}, "
                    f"world {i} is {(a.shape, a.dtype)} — planner shapes "
                    "must depend only on (M, K) (rule PLN003)")
        out[k] = np.stack(arrs)
    return out


def stack_gain_tables(ps, seeds, n_slots_list) -> np.ndarray:
    """``f32[W, S_max, K]`` slot-gain tables, zero-padded to the batch's
    tallest table — padded rows are unreachable (the Eq. 3 slot clip is
    bounded by each world's own ``n_slots``)."""
    S = max(int(n) for n in n_slots_list)
    K = ps[0].K
    out = np.zeros((len(ps), S, K), np.float32)
    for w, (p, seed, ns) in enumerate(zip(ps, seeds, n_slots_list)):
        out[w, :int(ns)] = np.asarray(slot_gain_table(p, seed, int(ns)),
                                      np.float32)
    return out


def _world_scalars(p, plan) -> dict:
    """The per-world ``ChannelParams`` scalars that enter the loop's f32
    arithmetic (and the gain-table height), as ``repro`` lists them."""
    return {
        "beta": float(p.beta), "gamma": float(p.gamma),
        "zeta": float(p.zeta), "v": float(p.v),
        "coverage": float(p.coverage),
        "dy2H2": float(p.d_y ** 2 + p.H ** 2),
        "p_m": float(p.p_m), "sigma2": float(p.sigma2),
        "B": float(p.B), "model_bits": float(p.model_bits),
        "n_slots": int(plan.n_slots),
    }


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the solo engine rounds its constants."""
    return float(np.float32(x))


def _loop_scalars(scal: list, device) -> dict:
    """The loop's constants under the solo engine's names: a Python f32
    float (an int for ``nmax``, the last slot) where every world agrees,
    else a ``[W, 1]`` column of the same f32 values (int32 for ``nmax``).
    A varied ``sigma2`` also carries its f32 reciprocal (``inv_sigma2``,
    see :func:`_div_sigma2`)."""
    names = {"beta": "beta", "gamma": "gamma", "zeta": "zeta", "v": "v",
             "cov": "coverage", "dy2H2": "dy2H2", "pm": "p_m",
             "sigma2": "sigma2", "bw": "B", "bits": "model_bits"}
    out = {}
    for name, key in names.items():
        vals = [_f32(s[key]) for s in scal]
        out[name] = (vals[0] if len(set(s[key] for s in scal)) == 1
                     else torch.tensor(vals, dtype=torch.float32,
                                       device=device).view(-1, 1))
    if isinstance(out["sigma2"], torch.Tensor):
        out["inv_sigma2"] = torch.tensor(
            [float(np.float32(1.0) / np.float32(s["sigma2"])) for s in scal],
            dtype=torch.float32, device=device).view(-1, 1)
    nmax = [s["n_slots"] - 1 for s in scal]
    out["nmax"] = (nmax[0] if len(set(nmax)) == 1
                   else torch.tensor(nmax, dtype=torch.int32,
                                     device=device).view(-1, 1))
    return out


def _div_sigma2(x, S: dict):
    """``x / sigma2`` as the solo engine computes it with ``sigma2`` a
    Python float: PyTorch divides by a host scalar on the CPU and
    multiplies by its f32 reciprocal on the card, so a varied ``sigma2``
    column does the same."""
    if not isinstance(S["sigma2"], torch.Tensor):
        return x / S["sigma2"]
    if x.is_cuda:
        return x * S["inv_sigma2"]
    return x / S["sigma2"]


class _SweepQueue:
    """The slot queues of W worlds (``[W, K]`` columns) and the Eq. 3-6
    re-scheduler: ``jit_engine._SlotQueue`` with a world axis, op for op.

    A pop returns ``[W, 1]`` columns, one pop per world.  ``S`` holds the
    loop's constants (:func:`_loop_scalars`), ``world_S[w]`` world ``w``'s
    own Python floats, which its re-admissions use, as its solo run does.
    Under an active selection plan in any world the queue holds the
    admission table round-major as ``[M, W * K]`` (``adm``; all-True rows
    for a world without a policy) and, when any world runs eps-bandit,
    ``[W, K]`` f32 reward accumulators ``rs``/``rc``."""

    def __init__(self, ps, plans, tabs: dict, gains, x0, S: dict,
                 world_S: list, device):
        W, K = len(ps), ps[0].K
        self.K = K
        self.gains = gains.reshape(-1)              # [W * S_max * K]
        self.x0 = x0.reshape(-1)                    # [W * K]
        self.S, self.world_S = S, world_S
        self.alpha = _f32(ps[0].alpha)              # uniform (validated)
        self.gain_rows = gains.shape[1] * K         # world stride of gains
        worlds = torch.arange(W, device=device).view(-1, 1)
        self.row = worlds * K                       # [W, 1] world offsets
        self.gain_row = worlds * self.gain_rows

        def col(x):
            return torch.from_numpy(
                np.asarray(x, np.float64).astype(np.float32)).to(device)
        self.qt = col(tabs["q0_time"])
        self.qdl = col(tabs["q0_download_time"])
        self.qcu = col(tabs["q0_upload_delay"])
        self.qcl = col(tabs["q0_train_delay"])
        self.inf = torch.full((1,), np.inf, dtype=torch.float32,
                              device=device)
        self.adm = self.rs = self.rc = None
        M = tabs["veh"].shape[1]
        sel_on = [plan.sel is not None and not plan.sel.is_noop
                  for plan in plans]
        if any(sel_on):
            adm = np.stack([plan.sel.tables(M)["mask"] if on
                            else np.ones((M, K), bool)
                            for plan, on in zip(plans, sel_on)])
            self.adm = torch.from_numpy(np.ascontiguousarray(
                adm.transpose(1, 0, 2).reshape(M, W * K))).to(device)
        if any(on and plan.sel.spec.policy == "eps-bandit"
               for plan, on in zip(plans, sel_on)):
            self.rs = torch.zeros((W, K), dtype=torch.float32, device=device)
            self.rc = torch.zeros_like(self.rs)

    def upload_delay(self, idx, fi, t_up, S: dict, gain_base):
        """Eq. 3-6 for vehicles ``idx`` (flat queue indices ``fi``)
        uploading at ``t_up``, with the constants ``S`` and the gain
        table's world offsets ``gain_base`` (a ``[W, 1]`` column or one
        world's int): ``_SlotQueue.upload_delay``'s expressions."""
        # int32 cast truncates toward zero, as astype(int32) does
        slot = t_up.to(torch.int32).clamp_(min=0)
        slot = (slot.clamp_(max=S["nmax"]) if isinstance(S["nmax"], int)
                else torch.minimum(slot, S["nmax"]))
        gain = self.gains.index_select(
            0, (gain_base + slot.long() * self.K + idx).view(-1)
        ).view_as(t_up)
        dx = self.x0.index_select(0, fi.view(-1)).view_as(t_up) \
            + S["v"] * t_up                                     # Eq. 3
        # floored modulo (jnp.mod), not fmod: dx may be negative
        dx = torch.remainder(dx + S["cov"], 2.0 * S["cov"]) - S["cov"]
        dist = torch.sqrt(dx * dx + S["dy2H2"])                 # Eq. 4
        snr = _div_sigma2(S["pm"] * gain * dist ** (-self.alpha), S)
        rate = S["bw"] * torch.log2(1.0 + snr)                  # Eq. 5
        # the solo's `bits / x`, which PyTorch computes as reciprocal * bits
        return torch.reciprocal(torch.clamp_min(rate, 1e-12)) * S["bits"]

    def pop(self, mafl: bool, r: int):
        """Pop ``r`` of every world: take each world's earliest slot and
        re-schedule its vehicle unless selection parks it.  Returns the
        trace columns (vehicle, time, C_u, C_l, download time, delay
        weight), each ``[W, 1]``."""
        S = self.S
        i = torch.argmin(self.qt, dim=1, keepdim=True)          # [W, 1]
        fi = (i + self.row).view(-1)
        t = self.qt.view(-1).index_select(0, fi).view_as(i)
        cu = self.qcu.view(-1).index_select(0, fi).view_as(t)
        cl = self.qcl.view(-1).index_select(0, fi).view_as(t)
        dl_t = self.qdl.view(-1).index_select(0, fi).view_as(t)
        if mafl:                                                # Eqs. 7, 9
            weight = S["gamma"] ** (cu - 1.0) * S["zeta"] ** (cl - 1.0)
        else:
            weight = torch.ones_like(t)
        t_up = t + cl
        cu_new = self.upload_delay(i, fi, t_up, S, self.gain_row)
        t_new = t_up + cu_new
        if self.rs is not None:
            rew = (weight if mafl else
                   S["gamma"] ** (cu - 1.0) * S["zeta"] ** (cl - 1.0))
            self.rs.view(-1).index_add_(0, fi, rew.view(-1))
            self.rc.view(-1).index_add_(0, fi, torch.ones_like(fi,
                                        dtype=torch.float32))
        if self.adm is not None:
            t_new = torch.where(
                self.adm[r].index_select(0, fi).view_as(t_new), t_new,
                self.inf)
        self.qt.view(-1).index_copy_(0, fi, t_new.view(-1))
        self.qdl.view(-1).index_copy_(0, fi, t.view(-1))
        self.qcu.view(-1).index_copy_(0, fi, cu_new.view(-1))
        return i, t, cu, cl, dl_t, weight

    def readmit(self, w: int, idx, fi, t_b):
        """Re-admit world ``w``'s parked vehicles ``idx`` (flat queue
        indices ``fi``) at its boundary time ``t_b`` (a one-element
        tensor), with that world's own constants: its solo re-admission."""
        t_up = t_b + self.qcl.view(-1).index_select(0, fi)
        cu_new = self.upload_delay(idx, fi, t_up, self.world_S[w],
                                   w * self.gain_rows)
        self.qt.view(-1).index_copy_(0, fi, t_up + cu_new)
        self.qdl.view(-1).index_copy_(0, fi, t_b.expand_as(cu_new))
        self.qcu.view(-1).index_copy_(0, fi, cu_new)


def chain_ends(plans, eval_rounds) -> list:
    """Ends of the sweep's ``ring_agg`` chains, one launch each for all
    worlds: every round any world stores (its ``needed`` rounds), every
    wave start at which any world trains, and M."""
    M = len(plans[0].veh)
    ends = {M}
    for plan in plans:
        ends |= needed_rounds(plan, eval_rounds)
        ends |= {s for T, s, _e in plan.waves if len(T) and s > 0}
    return sorted(ends)


def _train_group(layout: ParamLayout, snaps: dict, locals_buf,
                 G: list, G_dev, pay_rounds: np.ndarray, T_dev, rows_dev,
                 imgs, labs, lr: float):
    """Train the wave ``T_dev`` of the shared-timeline group ``G`` (two or
    more worlds, one minibatch stack) as one call: the payload rows
    ``snaps[pay_rounds][G]`` stacked world-major as ``[nG * |T|]`` params,
    the group's minibatches repeated nG times, the uploads written into
    ``locals_buf`` (viewed ``[W * M, P]``) at ``rows_dev`` (``w * M + t``)
    in one ``index_copy_``."""
    nG, nT = len(G), len(pay_rounds)
    rows = torch.stack([snaps[int(pr)].index_select(0, G_dev)
                        for pr in pay_rounds], dim=1)       # [nG, |T|, P]
    pay = layout.unpack(rows.reshape(nG * nT, -1))
    im, lab = imgs.index_select(0, T_dev), labs.index_select(0, T_dev)
    im = im.expand(nG, *im.shape).reshape(nG * nT, *im.shape[1:])
    lab = lab.expand(nG, *lab.shape).reshape(nG * nT, *lab.shape[1:])
    loc, _ = client_mod._local_scan_vmap(pay, im, lab, lr)
    locals_buf.view(-1, locals_buf.shape[-1]).index_copy_(
        0, rows_dev, layout.pack(loc, dtype=locals_buf.dtype))


def _event_segment(queue: _SweepQueue, g, locals_buf, a: int, b: int,
                   readmit_at: dict, *, scheme: str, interpretation: str,
                   beta, fedasync_mix: float):
    """Pops ``a..b-1`` of every world, their chain coefficients, and the
    one ``ring_agg`` chain of all worlds over ``locals_buf[:, a:b]`` (a
    view).  ``readmit_at[r]`` lists the ``(world, vehicles, queue slots)``
    re-admitted between pops ``r-1`` and ``r``, at that world's pop
    ``r-1`` time.  Nothing here reads a device value on the host.  Returns
    the new ``[W, P]`` master and the segment's six trace columns
    (``[W, b-a]`` each)."""
    pops = []
    for r in range(a, b):
        pop = queue.pop(scheme == "mafl", r)
        pops.append(pop)
        for w, vs_dev, fi_dev in readmit_at.get(r + 1, ()):
            queue.readmit(w, vs_dev, fi_dev, pop[1][w])
    cols = tuple(torch.cat(c, dim=1) for c in zip(*pops))
    _, t_c, _, _, dlt_c, w_c = cols
    cc, dd = chain_coeffs(scheme, interpretation, beta, w_c, t=t_c,
                          dl_t=dlt_c, fedasync_mix=fedasync_mix)
    g = agg_ops.ring_agg(g, locals_buf[:, a:b],
                         torch.stack([cc, dd], dim=2))
    return g, cols


def _run_program(plans: list, groups: list, queue: _SweepQueue,
                 layout: ParamLayout, g, batches: list, lrs: list, *,
                 scheme: str, interpretation: str, beta,
                 fedasync_mix: float, ring_dtype: str, eval_rounds: tuple):
    """The W-world program: per union chain, the waves that start there,
    the pops of every world (re-admissions between two pops), their chain
    coefficients and one ``ring_agg`` chain over ``[W, P]``.  ``g`` is the
    f32 ``[W, P]`` master, ``batches[gi]`` group ``gi``'s minibatch
    stacks, ``beta`` a float or a ``[W, 1]`` column.  Returns the final
    master, the stored ``[W, P]`` rows and the trace columns
    (``[W, M]`` each)."""
    W, M = len(plans), len(plans[0].veh)
    device = g.device
    bf16 = ring_dtype == "bf16"
    store_dtype = torch.bfloat16 if bf16 else torch.float32
    # a stored row is a new tensor (bf16) or g itself (f32): g is never
    # written in place, so sharing it by reference is safe
    store = ((lambda x: x.to(torch.bfloat16)) if bf16 else (lambda x: x))
    ends = chain_ends(plans, eval_rounds)
    needed = set().union(*(needed_rounds(plan, eval_rounds)
                           for plan in plans))

    # host plan data of the loop, copied to the device in one transfer:
    # each group's wave rows (and its w * M + t upload rows), each world's
    # re-admitted vehicles (and their w * K + i queue slots)
    waves = []                  # (start, gi, T, pay_rounds)
    for gi, G in enumerate(groups):
        d = plans[G[0]].dl_round
        for T, s, _e in plans[G[0]].waves:
            if len(T):
                T = np.asarray(T, np.int64)
                waves.append((s, gi, T, d[T] + 1))
    readmits = []               # (boundary, w, vehicles)
    for w, plan in enumerate(plans):
        for b, vs in sorted(readmit_points(plan).items()):
            readmits.append((b, w, np.asarray(vs, np.int64)))
    lists = [T for _, _, T, _ in waves]
    lists += [np.concatenate([w * M + T for w in groups[gi]])
              for _, gi, T, _ in waves]
    lists += [vs for _, _, vs in readmits]
    lists += [w * queue.K + vs for _, w, vs in readmits]
    lists += [np.asarray(G, np.int64) for G in groups]
    idx = upload_indices(lists, device)
    n, r_ = len(waves), len(readmits)
    train_at: dict = {}
    for (s, gi, T, pay), T_dev, rows_dev in zip(waves, idx[:n],
                                                idx[n:2 * n]):
        train_at.setdefault(s, []).append((gi, pay, T_dev, rows_dev))
    readmit_at: dict = {}
    for (b, w, _), vs_dev, fi_dev in zip(readmits, idx[2 * n:2 * n + r_],
                                         idx[2 * n + r_:2 * n + 2 * r_]):
        readmit_at.setdefault(b, []).append((w, vs_dev, fi_dev))
    group_dev = idx[2 * n + 2 * r_:]

    locals_buf = torch.zeros((W, M, layout.P), dtype=store_dtype,
                             device=device)
    snaps = {0: store(g)}
    traces = []
    a = 0
    for b in ends:
        for gi, pay, T_dev, rows_dev in train_at.get(a, ()):
            G = groups[gi]
            if len(G) == 1:
                # a world alone in its timeline: the solo wave trainer
                w = G[0]
                rows = {int(pr): snaps[int(pr)][w] for pr in set(pay)}
                loc = _train_wave(rows, pay, T_dev, batches[gi][0],
                                  batches[gi][1], lrs[gi],
                                  unpack=layout.unpack)
                locals_buf[w].index_copy_(
                    0, T_dev, layout.pack(loc, dtype=store_dtype))
            else:
                _train_group(layout, snaps, locals_buf, G, group_dev[gi],
                             pay, T_dev, rows_dev, batches[gi][0],
                             batches[gi][1], lrs[gi])
        g, cols = _event_segment(
            queue, g, locals_buf, a, b, readmit_at, scheme=scheme,
            interpretation=interpretation, beta=beta,
            fedasync_mix=fedasync_mix)
        if b in needed:
            snaps[b] = store(g)
        traces.append(cols)
        a = b
    trace = tuple(torch.cat([tr[k] for tr in traces], dim=1)
                  for k in range(6))
    return g, snaps, trace


def _check_worlds(worlds) -> list:
    """``repro``'s batch validation (``ValueError`` with its text); returns
    the worlds' ``ChannelParams``."""
    scs = [sc for sc, _seed in worlds]
    sc0 = scs[0]
    for field, label in (("n_rsus", "topology"), ("K", "fleet size"),
                         ("rounds", "rounds"), ("scheme", "scheme"),
                         ("ring_dtype", "ring_dtype")):
        vals = {getattr(sc, field) for sc in scs}
        if len(vals) > 1:
            raise ValueError(
                f"engine='vmap' needs a uniform {label} across the world "
                f"batch (got {field}={sorted(map(str, vals))}): these set "
                "the compiled program's shapes/structure — split the sweep")
    if sc0.n_rsus > 1:
        raise ValueError(
            "engine='vmap' is single-RSU only: corridor worlds carry "
            "per-RSU cohort rows the [W, P] world axis does not model "
            "(DESIGN.md §15) — use engine='corridor' per world")
    if sc0.scheme not in _SUPPORTED_SCHEMES:
        raise ValueError(
            f"engine='vmap' supports schemes {_SUPPORTED_SCHEMES}, not "
            f"{sc0.scheme!r} (fedbuff keeps host-side buffer state)")
    if any(scenario_faults(sc) is not None for sc in scs):
        raise ValueError(
            "engine='vmap' does not support fault injection yet: the "
            "fault folds (admission, staleness-cap, partial epochs) are "
            "per-world program structure the [W, P] world axis does not "
            "model (DESIGN.md §15/§16) — run the world solo with "
            "engine='jit', faults=...")
    if sc0.ring_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown ring_dtype {sc0.ring_dtype!r}")
    ps = [sc.channel() for sc in scs]
    if len({float(p.alpha) for p in ps}) > 1:
        raise ValueError(
            "engine='vmap' needs a uniform path-loss exponent alpha: it "
            "is a pow exponent XLA special-cases when constant, so a "
            "traced per-world alpha would change the solo worlds' codegen "
            "(DESIGN.md §15) — sweep it serially")
    return ps


def timeline_groups(worlds, ps, plans, built, batch_size: int) -> list:
    """Worlds whose training can share one call, by ``repro``'s grouping
    key: everything the minibatch stacks and the wave payload indices
    depend on (the data world, the seed, the pop and wave structure, lr).
    Returns the groups as lists of world indices, in first-seen order."""
    group_of: dict = {}
    groups: list = []
    for w, (sc, seed) in enumerate(worlds):
        fleet_batch = min(batch_size, min(d.size for d in built[w][0]))
        key = (seed, sc.n_train, sc.n_test, sc.noise, sc.scale,
               sc.dirichlet_alpha, sc.max_per_vehicle, ps[w].K,
               ps[w].platoon, sc.l_iters, sc.lr, fleet_batch,
               plans[w].waves, tuple(plans[w].veh.tolist()),
               tuple(plans[w].dl_round.tolist()))
        if key in group_of:
            groups[group_of[key]].append(w)
        else:
            group_of[key] = len(groups)
            groups.append([w])
    return groups


def run_simulation_vmap(worlds, *, eval_every: int = 10,
                        batch_size: int = 128, progress=None, metrics=None,
                        init_params=None, device=None) -> list:
    """Run ``W = len(worlds)`` independent single-RSU worlds as one batch
    on ``device`` (``None`` -> the card); ``worlds`` is a sequence of
    ``(Scenario, seed)`` pairs (:func:`repro_torch.core.scenarios.
    run_sweep` builds them).  Returns one ``SimResult`` per world, in
    order, each carrying an ``engine="vmap"`` RunReport whose channels
    name its ``world_index``, ``n_worlds`` and timeline ``group``.

    Uniform across the batch (validated, with ``repro``'s errors): ``K``,
    ``rounds``, ``scheme``, ``ring_dtype``, topology (single-RSU), and the
    path-loss exponent ``alpha``.  Free to vary per world: seed, any linear
    channel scalar, ``lr``, ``l_iters``, data fields, and the selection
    spec.  ``init_params`` is an optional per-world list of param dicts
    (else each world takes the port's torch init for its seed, as the solo
    engine does).  ``progress`` fires after the run as
    ``progress(world_index, round, acc)``."""
    if metrics_requested(metrics):
        raise ValueError(
            "engine='vmap' does not collect device telemetry yet: the "
            "metrics accumulators are per-world scan state the sweep tier "
            "does not carry (DESIGN.md §15) — run the world solo with "
            "engine='jit', metrics='on'")
    worlds = list(worlds)
    if not worlds:
        raise ValueError("run_simulation_vmap: empty world batch")
    ps = _check_worlds(worlds)
    device = resolve_device(device)
    from repro_torch.core.scenarios import build_world
    W = len(worlds)
    scs = [sc for sc, _seed in worlds]
    seeds = [int(seed) for _sc, seed in worlds]
    sc0 = scs[0]
    M, K = sc0.rounds, sc0.K

    timers = PhaseTimers()
    _t0 = time.perf_counter()
    built = [build_world(sc, seed=seed) for sc, seed in worlds]
    with timers.phase("plan"):
        plans = [plan_fleet(p, seed, M, sc.selection_spec(),
                            l_iters=sc.l_iters)
                 for sc, seed, p in zip(scs, seeds, ps)]
        tabs = stack_plan_tables([plan.tables() for plan in plans])
    groups = timeline_groups(worlds, ps, plans, built, batch_size)

    with timers.phase("stage"):
        # one minibatch stack per group: members share data and pop order
        batches = [stage_minibatches(
            built[G[0]][0], plans[G[0]], l_iters=scs[G[0]].l_iters,
            lr=scs[G[0]].lr, seed=seeds[G[0]], batch_size=batch_size,
            device=device) for G in groups]
        w0s = (list(init_params) if init_params is not None else
               [init_cnn(torch.Generator().manual_seed(seed), device=device)
                for seed in seeds])
        layout = ParamLayout.from_tree(w0s[0])
        g = torch.stack([layout.pack(w0) for w0 in w0s])   # f32 [W, P]
        gains = torch.from_numpy(stack_gain_tables(
            ps, seeds, [plan.n_slots for plan in plans])).to(device)
        x0 = torch.from_numpy(np.stack(
            [Mobility(p).x0 for p in ps]).astype(np.float32)).to(device)
        scal = [_world_scalars(p, plan) for p, plan in zip(ps, plans)]
        S = _loop_scalars(scal, device)
        world_S = [_loop_scalars([s], device) for s in scal]
        queue = _SweepQueue(ps, plans, tabs, gains, x0, S, world_S, device)
    eval_rounds = eval_rounds_of(M, eval_every)

    with timers.phase("run"):
        g, snaps, trace = _run_program(
            plans, groups, queue, layout, g, batches,
            [scs[G[0]].lr for G in groups], scheme=sc0.scheme,
            interpretation="mixing", beta=S["beta"],
            fedasync_mix=DEFAULT_FEDASYNC_MIX, ring_dtype=sc0.ring_dtype,
            eval_rounds=eval_rounds)
        # reading the trace waits for the card: the run ends here
        t_veh, t_time, t_cu, t_cl, _t_dlt, t_w = (x.cpu().numpy()
                                                  for x in trace)

    results = []
    with timers.phase("eval"):
        for w, (sc, seed) in enumerate(worlds):
            _check_world(w, t_veh[w], t_time[w], tabs, queue, plans[w],
                         g[w], sc0.ring_dtype)
            results.append(_world_result(
                w, sc.scheme, layout, g[w], snaps, eval_rounds, built[w],
                t_veh[w], t_time[w], t_cu[w], t_cl[w], t_w[w], progress,
                device))
    timers.add("total", time.perf_counter() - _t0)
    # shared phase timers: one plan/stage/run/eval cost for the whole batch
    # — every world's report carries the same snapshot plus its world index
    group_of = {w: gi for gi, G in enumerate(groups) for w in G}
    for w, ((sc, seed), result) in enumerate(zip(worlds, results)):
        plan = plans[w]
        result.report = RunReport(
            engine="vmap", scheme=sc.scheme, rounds=M, seed=seed,
            metrics_on=False, spec=None, phases=timers.snapshot(),
            memory=memory_stats(device),
            selection=None if plan.sel is None else plan.sel.summary(),
            waves=wave_stats(plan.waves, K),
            channels={"world_index": w, "n_worlds": W,
                      "group": group_of[w]})
    return results


def _check_world(w: int, veh: np.ndarray, times: np.ndarray, tabs: dict,
                 queue: _SweepQueue, plan, g_w, ring_dtype: str) -> None:
    """World ``w``'s divergence guards, as ``repro``'s: the pop order equal
    to the f64 plan, the times within rtol 1e-4 / atol 1e-3, the bandit's
    accumulators the host replay's, a finite master under the bf16 ring.
    Raises ``RuntimeError``."""
    if not np.array_equal(veh, tabs["veh"][w]):
        bad = int(np.argmax(veh != tabs["veh"][w]))
        raise RuntimeError(
            f"vmap engine: world {w} device pop order diverged from the "
            f"host dry run at round {bad} (device vehicle {int(veh[bad])}, "
            f"host {int(tabs['veh'][w][bad])})")
    if not np.allclose(times, tabs["times"][w], rtol=1e-4, atol=1e-3):
        bad = int(np.argmax(~np.isclose(times, tabs["times"][w], rtol=1e-4,
                                        atol=1e-3)))
        raise RuntimeError(
            f"vmap engine: world {w} device event times diverged from the "
            f"host dry run at round {bad}: {times[bad]} vs "
            f"{tabs['times'][w][bad]}")
    if (plan.sel is not None and not plan.sel.is_noop
            and plan.sel.spec.policy == "eps-bandit"):
        check_bandit(SimpleNamespace(rs=queue.rs[w], rc=queue.rc[w]), plan,
                     f"vmap engine: world {w}")
    if ring_dtype == "bf16" and not bool(torch.isfinite(g_w).all()):
        raise RuntimeError(
            f"vmap engine: world {w} non-finite master weights under "
            "ring_dtype='bf16' — rerun with 'f32' to bisect")


def _world_result(w: int, scheme: str, layout: ParamLayout, g_w,
                  snaps: dict, eval_rounds: tuple, built, veh, times, cu,
                  cl, weight, progress, device) -> SimResult:
    """World ``w``'s ``SimResult``: its records, and its evals of the
    stored rows at ``eval_rounds``."""
    result = SimResult(scheme=scheme, rounds=[], acc_history=[],
                       loss_history=[], final_params=layout.unpack(g_w))
    te_i = torch.as_tensor(built[1], device=device)
    te_l = torch.as_tensor(built[2], device=device)
    for r in range(len(veh)):
        rec = RoundRecord(round=r + 1, time=float(times[r]),
                          vehicle=int(veh[r]), upload_delay=float(cu[r]),
                          train_delay=float(cl[r]), weight=float(weight[r]))
        rr = r + 1
        if rr in eval_rounds:
            acc, loss = evaluate(layout.unpack(snaps[rr][w]), te_i, te_l,
                                 device=device)
            rec.accuracy, rec.loss = acc, loss
            result.acc_history.append((rr, acc))
            result.loss_history.append((rr, loss))
            if progress:
                progress(w, rr, acc)
        result.rounds.append(rec)
    return result
