"""Host selection replay and the static plan the device engines fold in:
``repro.selection.runtime`` for the port.

:class:`SelectionState` defines the selection semantics.  The serial
engines drive one live; the f64 planners (the batched engine's consumed-set
dry run, ``core.jit_engine.plan_fleet``, ``corridor.plan.plan_corridor``)
replay an identical instance over the identical timeline, so every engine
makes the same admission decisions.  The rules:

- **The mask applies at (re-)schedule time.**  A vehicle not admitted when
  its upload is consumed is *parked*: aggregated one last time, then never
  re-scheduled, so it holds no queue slot and trains in no wave.
- **Epoch boundaries re-score.**  Every ``resel_every`` consumed arrivals
  (corridor worlds: every reconcile boundary) the policy re-decides at the
  boundary arrival's time; the boundary arrival re-schedules under the
  *old* mask, and newly admitted parked vehicles download the boundary
  round's model and re-enter the timeline at that instant.
- **At least one vehicle stays admitted**: the lowest-indexed in-coverage
  vehicle is force-admitted if a policy returns none.

Features are computed in numpy f64 exactly as ``repro`` computes them: a
tie in ``lexsort`` or a step of the budget loop turns on the last bit.
:class:`SelectionPlan` is the replay's static residue: the initial mask,
the per-boundary masks and re-admissions, and (bandit) the expected final
reward accumulators the device engines' divergence guards compare with.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.channel import ChannelParams, CorridorMobility
from repro_torch.channel.rate import shannon_rate
from repro_torch.selection.policy import (BanditState, SelectionContext,
                                          SelectionSpec, make_policy)


@dataclass(frozen=True)
class SelectionPlan:
    """Everything static the device engines need about admission.

    ``boundaries`` holds one entry per selection epoch boundary:
    ``(b, newly, mask)`` — after consumed arrival ``b`` (1-based) the
    admission mask becomes ``mask`` and the parked vehicles in ``newly``
    are scheduled at the boundary timestamp.  ``admit0`` is the t=0 mask.
    """
    spec: SelectionSpec
    admit0: tuple               # bool*K
    boundaries: tuple           # ((b, newly tuple, mask tuple), ...)

    @property
    def is_noop(self) -> bool:
        """No admission op can ever fire: all masks all-ones, no
        re-admissions, no carried state — the engines run their path
        without selection."""
        return (self.spec.policy != "eps-bandit" and all(self.admit0)
                and all(not n and all(m) for _, n, m in self.boundaries))

    def mask_for_round(self, r: int) -> np.ndarray:
        """Admission mask in effect for (0-based) pop ``r`` — the decision
        at boundary ``b`` governs re-schedules of pops ``r >= b``."""
        mask = self.admit0
        for b, _, m in self.boundaries:
            if b <= r:
                mask = m
            else:
                break
        return np.asarray(mask, bool)

    def signature(self) -> tuple:
        """Hashable identity of the plan."""
        return (self.spec, self.admit0, self.boundaries)

    def tables(self, rounds: int) -> dict:
        """Fixed-shape admission tables: the ragged ``boundaries`` tuple
        re-encoded as ``[rounds, K]`` bool arrays.  ``mask[r]`` gates the
        re-schedule of pop ``r`` (exactly :meth:`mask_for_round`; the
        device engines upload it once), ``readmit[b, v]`` marks vehicle
        ``v`` re-admitted at boundary ``b``.  Shapes depend only on
        ``(rounds, K)``, never on the seed."""
        K = len(self.admit0)
        mask = np.stack([self.mask_for_round(r) for r in range(rounds)])
        readmit = np.zeros((rounds, K), bool)
        for b, newly, _ in self.boundaries:
            if b < rounds:
                readmit[b, list(newly)] = True
        return {"mask": mask, "readmit": readmit}

    def summary(self) -> dict:
        """The ``SimResult.extras['selection']`` payload — identical
        across engines by construction (conformance asserts it), plain
        JSON-serializable types only."""
        import dataclasses
        return {
            "policy": self.spec.policy,
            "spec": dataclasses.asdict(self.spec),
            "admit0": list(self.admit0),
            "decisions": [(b, list(n), list(m))
                          for b, n, m in self.boundaries],
            "n_admitted_final": int(sum(self.mask_for_round(10 ** 9))),
        }


class SelectionState:
    """Live selection state over one simulation timeline (f64).

    ``mobility`` is the world's :class:`Mobility` or
    :class:`CorridorMobility`; ``resel_every`` overrides the spec's epoch
    (the corridor engines pass their reconcile period).  It is
    deliberately cheap — decisions are O(K log K) numpy at epoch
    boundaries only."""

    def __init__(self, spec: SelectionSpec, p: ChannelParams, mobility,
                 seed: int, rounds: int,
                 resel_every: Optional[int] = None):
        self.spec = spec.validate()
        self.policy = make_policy(spec)
        self.p = p
        self.mobility = mobility
        self.n_rsus = getattr(mobility, "n_rsus", 1)
        self.seed = seed
        self.rounds = rounds
        self.resel_every = (resel_every if resel_every is not None
                            else spec.resel_every)
        if spec.policy == "eps-bandit" and not self.resel_every:
            raise ValueError(
                "eps-bandit needs a re-selection epoch: set resel_every "
                "(single-RSU) or run it on a corridor scenario (re-scores "
                "at every reconcile boundary)")
        K = p.K
        self.K = K
        idx = np.arange(1, K + 1)                     # 1-based (Table I)
        self._data = np.array([p.data_count(i) for i in idx], float)
        self._compute = np.array([p.delta(i) for i in idx], float)
        self.state = self.policy.init_state(K)
        self.in_flight = np.zeros(K, bool)
        self._epoch = 0
        self._decisions: list = []
        self.mask = self._decide(0.0)
        self.admit0 = self.mask.copy()

    # -- feature extraction (timeline-pure) --------------------------------
    def _ctx(self, t: float) -> SelectionContext:
        p = self.p
        arange = np.arange(self.K)
        mob = self.mobility
        residence = np.asarray(mob.next_boundary_crossing(arange, t)) - t
        if isinstance(mob, CorridorMobility):
            serving = np.asarray(mob.serving_rsu(arange, t), np.int64)
        else:
            serving = np.zeros(self.K, np.int64)
        dist = np.asarray(mob.distances(t))
        # estimated upload airtime at mean channel gain (E|g|^2 = 1);
        # shannon_rate is Eq. 5 (vector-safe), the division is Eq. 6
        # (rate.upload_delay's scalar max() doesn't broadcast)
        rate = shannon_rate(p, 1.0, dist)
        upload_cost = p.model_bits / np.maximum(rate, 1e-12)
        return SelectionContext(
            t=t, data=self._data, compute=self._compute,
            residence=residence, upload_cost=upload_cost,
            in_coverage=np.ones(self.K, bool), serving=serving,
            n_rsus=self.n_rsus,
            rng=np.random.default_rng([self.seed, self._epoch]))

    def _decide(self, t: float) -> np.ndarray:
        ctx = self._ctx(t)
        mask = np.asarray(self.policy.mask(ctx, self.state), bool)
        if not mask.any():                      # never stall the queue:
            # force-admit the lowest-indexed in-coverage vehicle
            cov = np.flatnonzero(ctx.in_coverage)
            mask[int(cov[0]) if len(cov) else 0] = True
        self._epoch += 1
        return mask

    # -- timeline hooks ----------------------------------------------------
    def initial_vehicles(self) -> list[int]:
        """Vehicles to schedule at t=0 (index-ascending)."""
        out = [int(v) for v in np.flatnonzero(self.admit0)]
        self.in_flight[out] = True
        return out

    def on_arrival(self, vehicle: int, upload_delay: float,
                   train_delay: float) -> bool:
        """One consumed upload: fold the bandit reward and report whether
        the vehicle re-schedules (current mask) or parks."""
        if isinstance(self.state, BanditState):
            rew = (self.p.gamma ** (upload_delay - 1.0)
                   * self.p.zeta ** (train_delay - 1.0))    # Eqs. 7, 9
            self.policy.observe(self.state, vehicle, rew)
        self.in_flight[vehicle] = False
        if self.mask[vehicle]:
            self.in_flight[vehicle] = True
            return True
        return False

    def maybe_reselect(self, total: int, t: float) -> list[int]:
        """Epoch boundary after consumed arrival ``total`` (1-based):
        re-decide and return the parked vehicles to schedule at ``t``."""
        if (not self.resel_every or total % self.resel_every != 0
                or total >= self.rounds):
            return []
        self.mask = self._decide(t)
        newly = [int(v) for v in np.flatnonzero(self.mask
                                                & ~self.in_flight)]
        self.in_flight[newly] = True
        self._decisions.append(
            (total, tuple(newly), tuple(bool(x) for x in self.mask)))
        return newly

    # -- residue -----------------------------------------------------------
    def plan(self) -> SelectionPlan:
        return SelectionPlan(
            spec=self.spec,
            admit0=tuple(bool(x) for x in self.admit0),
            boundaries=tuple(self._decisions))

    def bandit_expectation(self):
        """(rew_sum, rew_cnt) f64 the device guard compares, or None."""
        if isinstance(self.state, BanditState):
            return (self.state.rew_sum.copy(), self.state.rew_cnt.copy())
        return None


def check_reconcile_mode(spec, mode: str) -> None:
    """Shared corridor-engine guard: selection + EMA reconcile cannot
    coexist (both the device engine and the serial reference call this, so
    they always accept exactly the same scenario set).  ``spec`` is the
    engines' raw ``selection`` argument — None, a policy-name string, or a
    :class:`SelectionSpec`."""
    if isinstance(spec, str):
        spec = SelectionSpec(policy=spec).validate()
    if spec is not None and not spec.is_noop and mode == "ema":
        raise ValueError(
            "vehicle selection with reconcile_mode='ema' is unsupported: "
            "EMA keeps distinct post-reconcile cohorts, so a re-admission "
            "download is RSU-dependent and the one-row-per-round snapshot "
            "ring cannot represent it (DESIGN.md §11) — use 'fedavg'")


def scenario_spec(sc) -> Optional[SelectionSpec]:
    """Build a :class:`SelectionSpec` from Scenario-style fields
    (``selection``, ``selection_k``, ``selection_budget``,
    ``selection_eps``, ``resel_every``) — None when the scenario carries no
    selection policy."""
    name = getattr(sc, "selection", None)
    if not name:
        return None
    return SelectionSpec(
        policy=name, k=getattr(sc, "selection_k", None),
        budget=getattr(sc, "selection_budget", None),
        eps=getattr(sc, "selection_eps", 0.1),
        resel_every=getattr(sc, "resel_every", None)).validate()


def make_selection_state(selection, p: ChannelParams, mobility, seed: int,
                         rounds: int,
                         resel_every: Optional[int] = None
                         ) -> Optional[SelectionState]:
    """Normalize the engines' ``selection`` argument: None stays None
    (legacy path, zero selection machinery), a policy-name string becomes a
    default spec, a :class:`SelectionSpec` is used as-is."""
    if selection is None:
        return None
    spec = (SelectionSpec(policy=selection)
            if isinstance(selection, str) else selection)
    return SelectionState(spec, p, mobility, seed, rounds,
                          resel_every=resel_every)
