"""Vehicle-selection policies: ``repro.selection.policy`` for the port.

Four admission rules over per-vehicle features at one decision instant:

- ``admit-all``     — the paper's baseline, a no-op.
- ``weighted-topk`` — score = normalised data amount x compute capability x
                      predicted residence time, top ``k`` per RSU.
- ``budget``        — admit cheapest estimated upload airtime first until
                      the per-RSU budget (seconds per cycle) is spent.
- ``eps-bandit``    — epsilon-greedy over each vehicle's mean delay-weight
                      reward, re-drawn every selection epoch.

Every input is timeline-pure (Table-I constants, mobility, the delay
weight), so decisions are host numpy f64.  They decide which vehicle is
admitted, so the tie-breaks (``np.lexsort``), the budget loop and the
bandit's draws from ``np.random.default_rng([seed, epoch])`` are kept
exactly as in ``repro``: the port admits the same vehicles bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

POLICIES = ("admit-all", "weighted-topk", "budget", "eps-bandit")


@dataclass(frozen=True)
class SelectionSpec:
    """Hashable policy selector + parameters (rides in program-cache keys).

    ``k`` is the per-RSU admission cap (weighted-topk / eps-bandit);
    ``budget`` the per-RSU upload-airtime budget in seconds (budget policy);
    ``eps`` the bandit exploration probability; ``resel_every`` the
    re-selection epoch in rounds (single-RSU worlds; corridor worlds
    re-score at every reconcile boundary instead)."""
    policy: str = "admit-all"
    k: Optional[int] = None
    budget: Optional[float] = None
    eps: float = 0.1
    resel_every: Optional[int] = None

    @property
    def is_noop(self) -> bool:
        """True when admission can never differ from the paper baseline —
        the engines then compile the exact legacy program (bitwise golden
        guarantee)."""
        return self.policy == "admit-all"

    def validate(self) -> "SelectionSpec":
        if self.policy not in POLICIES:
            raise ValueError(f"unknown selection policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if self.policy in ("weighted-topk", "eps-bandit") and \
                (self.k is None or self.k < 1):
            raise ValueError(f"policy {self.policy!r} needs k >= 1")
        if self.policy == "budget" and \
                (self.budget is None or self.budget <= 0):
            raise ValueError("policy 'budget' needs a positive upload-slot "
                             "budget (seconds of airtime per cycle)")
        if self.policy == "eps-bandit" and not (0.0 <= self.eps <= 1.0):
            raise ValueError("eps must be in [0, 1]")
        return self


@dataclass
class SelectionContext:
    """Per-vehicle features at one decision instant — everything a policy
    may read.  All arrays are length K; ``rng`` is the decision-epoch
    generator (seeded from (seed, epoch), so decisions are deterministic
    under a fixed seed)."""
    t: float
    data: np.ndarray          # f64[K] D_i, images carried (Table I)
    compute: np.ndarray       # f64[K] delta_i, CPU cycles/s (Table I)
    residence: np.ndarray     # f64[K] predicted seconds to next boundary
    upload_cost: np.ndarray   # f64[K] estimated upload seconds (mean gain)
    in_coverage: np.ndarray   # bool[K]
    serving: np.ndarray       # i64[K] serving RSU index (0 when single-RSU)
    n_rsus: int
    rng: np.random.Generator

    @property
    def K(self) -> int:
        return len(self.data)

    def groups(self):
        """Yield ``(rsu_index, member_index_array)`` over in-coverage
        vehicles, RSU-ascending — the deterministic iteration order every
        per-RSU policy uses."""
        cov = np.flatnonzero(self.in_coverage)
        for j in range(self.n_rsus):
            yield j, cov[self.serving[cov] == j]


def _norm(x: np.ndarray) -> np.ndarray:
    m = float(np.max(x)) if len(x) else 0.0
    return x / m if m > 0 else np.ones_like(x)


@dataclass
class BanditState:
    """Per-vehicle reward accumulators, carried through the device scan
    (f32 there; f64 here on the host — the divergence guard compares)."""
    rew_sum: np.ndarray       # f64[K]
    rew_cnt: np.ndarray       # f64[K]

    @classmethod
    def zeros(cls, K: int) -> "BanditState":
        return cls(np.zeros(K), np.zeros(K))


class SelectionPolicy:
    """Pure decision rule: features -> admission mask.  Stateless except
    for the bandit, whose accumulators the engines carry."""

    name = "?"

    def init_state(self, K: int):
        return None

    def observe(self, state, vehicle: int, reward: float):
        """Fold one consumed arrival's reward (bandit only)."""
        return state

    def mask(self, ctx: SelectionContext, state) -> np.ndarray:
        raise NotImplementedError


class AdmitAll(SelectionPolicy):
    name = "admit-all"

    def mask(self, ctx, state):
        return ctx.in_coverage.copy()


class WeightedTopK(SelectionPolicy):
    """arXiv:2304.02832's ingredients: score each vehicle by normalized
    data amount x compute capability x predicted residence time, admit the
    top ``k`` per RSU."""

    name = "weighted-topk"

    def __init__(self, k: int):
        self.k = k

    def scores(self, ctx) -> np.ndarray:
        return (_norm(ctx.data) * _norm(ctx.compute)
                * _norm(ctx.residence))

    def mask(self, ctx, state):
        score = self.scores(ctx)
        out = np.zeros(ctx.K, bool)
        for _, g in ctx.groups():
            if len(g):
                # descending score, index-ascending tie-break
                order = g[np.lexsort((g, -score[g]))]
                out[order[:self.k]] = True
        return out


class BudgetPolicy(SelectionPolicy):
    """arXiv:2210.15496's binding constraint: admission under a per-RSU
    resource budget.  Each vehicle's cost is its estimated upload airtime
    at the decision instant (mean channel gain); vehicles are admitted
    cheapest-first until the budget is exhausted."""

    name = "budget"

    def __init__(self, budget: float):
        self.budget = budget

    def mask(self, ctx, state):
        cost = ctx.upload_cost
        out = np.zeros(ctx.K, bool)
        for _, g in ctx.groups():
            order = g[np.lexsort((g, cost[g]))]
            spent = 0.0
            for v in order:
                if spent + cost[v] > self.budget:
                    break
                out[v] = True
                spent += cost[v]
        return out


class EpsBandit(SelectionPolicy):
    """Epsilon-greedy over per-vehicle historical mean contribution:
    with probability ``eps`` the epoch explores (uniform k-subset per RSU),
    otherwise it exploits the top ``k`` by mean reward, with never-tried
    vehicles optimistically preferred."""

    name = "eps-bandit"

    def __init__(self, k: int, eps: float):
        self.k = k
        self.eps = eps

    def init_state(self, K: int):
        return BanditState.zeros(K)

    def observe(self, state: BanditState, vehicle: int, reward: float):
        state.rew_sum[vehicle] += reward
        state.rew_cnt[vehicle] += 1.0
        return state

    def mask(self, ctx, state: BanditState):
        out = np.zeros(ctx.K, bool)
        explore = bool(ctx.rng.random() < self.eps)
        mean = np.where(state.rew_cnt > 0,
                        state.rew_sum / np.maximum(state.rew_cnt, 1.0),
                        np.inf)                         # optimistic init
        for _, g in ctx.groups():
            if not len(g):
                continue
            if explore:
                out[ctx.rng.permutation(g)[:self.k]] = True
            else:
                order = g[np.lexsort((g, -mean[g]))]
                out[order[:self.k]] = True
        return out


def make_policy(spec: SelectionSpec) -> SelectionPolicy:
    spec.validate()
    if spec.policy == "admit-all":
        return AdmitAll()
    if spec.policy == "weighted-topk":
        return WeightedTopK(spec.k)
    if spec.policy == "budget":
        return BudgetPolicy(spec.budget)
    return EpsBandit(spec.k, spec.eps)
