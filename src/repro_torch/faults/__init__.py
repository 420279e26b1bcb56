"""How admission layers compose with the event timeline: the helpers every
engine drives selection through (``repro.faults``'s composition helpers;
the fault models themselves are not ported yet)."""
from repro_torch.faults.runtime import (arrival_step, fold_readmits,
                                        initial_vehicles)

__all__ = ["arrival_step", "fold_readmits", "initial_vehicles"]
