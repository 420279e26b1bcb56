"""The multi-RSU highway corridor: R RSU cohorts with handover and a
periodic cloud-tier reconcile (FedAvg or EMA), the port of
``repro.corridor``.

``run_corridor_simulation`` is the device engine (``engine="corridor"``):
an ``f32[R, K]`` slot queue, wave-hoisted training and per-RSU
``ring_agg`` chains over the packed ``[R, P]`` cohort stack.
``run_handover_simulation`` is the serial handover loop it is held
against; ``plan_corridor`` is the f64 host dry run both share.
"""
from repro_torch.corridor.plan import CorridorPlan, plan_corridor
from repro_torch.corridor.engine import run_corridor_simulation
from repro_torch.corridor.reference import run_handover_simulation

__all__ = ["CorridorPlan", "plan_corridor", "run_corridor_simulation",
           "run_handover_simulation"]
