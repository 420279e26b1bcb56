"""A deliberately bad planner module: imports engine internals and torch
(PLN001) and drops the f64 host timeline to f32 mid-plan (PLN002).  The
torch transcription of ``repro/check/fixtures/bad_planner.py``; the test
feeds this source to the boundary checker under a planner path."""
from __future__ import annotations

import numpy as np

from repro_torch.core.jit_engine import _run_program  # PLN001: engine import
import torch                                         # PLN001: torch in planner


def plan_badly(times):
    t32 = times.astype(np.float32)                  # PLN002: precision drop
    order = np.argsort(t32)
    return order, np.asarray(t32, dtype="float32")  # PLN002 again
