"""Fault injection for the port: seeded stochastic client-state processes
(dropout, blackout, partial computation, stragglers, staleness-cap
discard) decided on the host in f64 and folded into every engine, plus
the helpers that compose them with selection on the event timeline
(``repro.faults``, DESIGN.md §16)."""
from repro_torch.faults.replay import (replay_corridor_faults,
                                       replay_fleet_faults)
from repro_torch.faults.runtime import (FaultPlan, FaultState, arrival_step,
                                        check_faults_reconcile,
                                        fold_admission, fold_readmits,
                                        initial_vehicles, make_fault_state)
from repro_torch.faults.spec import (PROFILES, FaultSpec, faults_requested,
                                     named_profile, resolve_faults,
                                     scenario_faults)

__all__ = [
    "FaultPlan", "FaultSpec", "FaultState", "PROFILES", "arrival_step",
    "check_faults_reconcile", "faults_requested", "fold_admission",
    "fold_readmits", "initial_vehicles", "make_fault_state",
    "named_profile", "replay_corridor_faults", "replay_fleet_faults",
    "resolve_faults", "scenario_faults",
]
