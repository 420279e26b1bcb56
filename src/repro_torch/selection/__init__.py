"""Vehicle selection for the port: admission policies every engine
consumes, decided on the host in f64 and folded into the device engines as
an admission table."""
from repro_torch.selection.policy import (POLICIES, AdmitAll, BanditState,
                                          BudgetPolicy, EpsBandit,
                                          SelectionContext, SelectionPolicy,
                                          SelectionSpec, WeightedTopK,
                                          make_policy)
from repro_torch.selection.runtime import (SelectionPlan, SelectionState,
                                           check_reconcile_mode,
                                           make_selection_state,
                                           scenario_spec)

__all__ = ["POLICIES", "AdmitAll", "BanditState", "BudgetPolicy",
           "EpsBandit", "SelectionContext", "SelectionPolicy",
           "SelectionSpec", "WeightedTopK", "make_policy", "SelectionPlan",
           "SelectionState", "make_selection_state", "scenario_spec",
           "check_reconcile_mode"]
