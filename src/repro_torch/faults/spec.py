"""Fault-injection configuration: ``repro.faults.spec`` for the port
(DESIGN.md §16).

A :class:`FaultSpec` describes the stochastic client-state processes the
host f64 planner samples into static per-round fault tables:

- **availability** — a Gilbert-Elliott on/off process evaluated at upload-
  cycle granularity: at each (re-)schedule attempt a live vehicle enters a
  blackout with probability ``p_blackout`` and stays dark for an
  exponential off-duration of mean ``blackout_mean`` seconds (the RSU's
  periodic re-admission sweep brings it back, see runtime);
- **mid-training dropout** — with probability ``p_dropout`` per cycle the
  upload never arrives: the slot is reclaimed and the vehicle is eligible
  for re-admission at the next sweep;
- **partial computation** — with probability ``p_partial`` per cycle the
  vehicle finishes only ``n_ep < l_iters`` local SGD steps inside its
  unchanged time budget (deadline semantics: the timeline is untouched,
  only the local update truncates);
- **straggler inflation** — a fixed fraction ``straggler_frac`` of the
  fleet computes ``straggler_mult`` x slower: the per-vehicle constant
  multiplier scales the Eq. 8 training delay everywhere it feeds the
  Eq. 3-6 event times;
- **staleness-cap discard** — graceful degradation at the RSU: an upload
  whose model is older than ``staleness_cap`` consumed rounds is
  discarded (the arrival still counts, the model update is skipped).

All probabilities are per upload cycle.  ``recheck_every`` is the fleet
engines' re-admission sweep cadence in consumed rounds (corridor worlds
re-admit at reconcile boundaries instead, mirroring selection).

The capability properties (``timeline_active`` / ``has_partial`` /
``has_cap``) are *spec-level* — independent of the seed — so which fault
tables an engine builds is the same for every seed (rule FLT001's shape
probe).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FaultSpec:
    """Stochastic client-state processes, sampled per upload cycle."""
    p_dropout: float = 0.0
    p_blackout: float = 0.0
    blackout_mean: float = 0.0          # seconds (exponential off-duration)
    p_partial: float = 0.0
    straggler_frac: float = 0.0
    straggler_mult: float = 1.0
    staleness_cap: Optional[int] = None  # consumed rounds; None = keep all
    recheck_every: int = 8               # fleet re-admission sweep cadence

    def validate(self) -> "FaultSpec":
        for f in ("p_dropout", "p_blackout", "p_partial", "straggler_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{f}={v} must be in [0, 1]")
        if self.p_blackout and self.blackout_mean <= 0.0:
            raise ValueError("p_blackout > 0 needs blackout_mean > 0")
        if self.straggler_mult < 1.0:
            raise ValueError("straggler_mult < 1 would *deflate* compute "
                             "time; use a fresh ChannelParams instead")
        if self.staleness_cap is not None and self.staleness_cap < 1:
            raise ValueError("staleness_cap must be >= 1 round")
        if self.recheck_every < 0:
            raise ValueError("recheck_every must be >= 0 (0 disables "
                             "re-admission sweeps)")
        return self

    # -- spec-level capabilities (seed-independent, FLT001 shape probe) ----
    @property
    def is_noop(self) -> bool:
        """No fault process can ever fire — the engines must run their
        exact path without faults (rule FLT001)."""
        return (self.p_dropout == 0.0 and self.p_blackout == 0.0
                and self.p_partial == 0.0
                and (self.straggler_frac == 0.0
                     or self.straggler_mult == 1.0)
                and self.staleness_cap is None)

    @property
    def timeline_active(self) -> bool:
        """Dropout/blackout can suppress re-schedules (the device engines
        need the admission table)."""
        return self.p_dropout > 0.0 or self.p_blackout > 0.0

    @property
    def has_partial(self) -> bool:
        return self.p_partial > 0.0

    @property
    def has_cap(self) -> bool:
        return self.staleness_cap is not None


# -- named profiles (Scenario.faults) ---------------------------------------
PROFILES: dict[str, FaultSpec] = {
    # churn-heavy fleet: vehicles drop uploads and go dark sporadically,
    # stale survivors are discarded at 12 rounds
    "flaky": FaultSpec(p_dropout=0.08, p_blackout=0.04, blackout_mean=30.0,
                       staleness_cap=12),
    # coverage dead zones: long blackouts dominate (rush-hour corridor),
    # uploads themselves are reliable while covered
    "deadzone": FaultSpec(p_blackout=0.10, blackout_mean=60.0,
                          staleness_cap=16),
    # compute-constrained fleet: a third of the vehicles are 4x slower and
    # half the cycles finish only part of their local epochs
    "throttled": FaultSpec(p_partial=0.5, straggler_frac=0.3,
                           straggler_mult=4.0, staleness_cap=8),
}


def named_profile(name: str) -> FaultSpec:
    try:
        return PROFILES[name]
    except KeyError:
        known = ", ".join(sorted(PROFILES))
        raise KeyError(
            f"unknown fault profile {name!r}; known: {known}") from None


def resolve_faults(faults) -> Optional[FaultSpec]:
    """Normalize the engines' ``faults`` argument before any engine reads
    it: every falsy or no-op spelling collapses to ``None``, so a
    faults-off run takes the path without faults and is bitwise the run
    without the argument (rule FLT001)."""
    if faults is None or faults is False or faults in ("off", "none", ""):
        return None
    spec = named_profile(faults) if isinstance(faults, str) else faults
    if not isinstance(spec, FaultSpec):
        raise TypeError(f"faults must be None, a profile name, or a "
                        f"FaultSpec, not {type(faults).__name__}")
    spec = spec.validate()
    return None if spec.is_noop else spec


def faults_requested(faults) -> bool:
    return resolve_faults(faults) is not None


def scenario_faults(sc) -> Optional[FaultSpec]:
    """Build the :class:`FaultSpec` from Scenario-style fields (``faults``
    profile name + ``faults_overrides`` replace-pairs) — None when the
    scenario carries no fault model."""
    name = getattr(sc, "faults", None)
    if not name:
        return None
    spec = named_profile(name) if isinstance(name, str) else name
    overrides = dict(getattr(sc, "faults_overrides", ()) or ())
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return resolve_faults(spec)
