"""A deliberately leaky device-loop function: every class of host/device
boundary violation the BND rules cover, each on its own line so the test
can pin rule ids to line numbers.  The torch transcription of
``repro/check/fixtures/leaky_engine.py``; handing ``leaky_step`` to
``torch.func.vmap`` is what marks it device loop, as ``jax.jit`` does
there.  ``repro``'s donated-buffer line (BND005) has no counterpart."""
from __future__ import annotations

import numpy as np
import torch


def leaky_step(qt, w, n: int):
    if qt.sum() > 0:                     # BND002: Python branch on tensor
        w = w * 0.5
    i = int(torch.argmin(qt))            # BND003: host scalar pull
    t = qt[0].item()                     # BND003: host scalar pull
    mean = np.mean(w)                    # BND001: np.* on a tensor
    w64 = w.to(torch.float64)            # BND004: f64 in device-loop code
    for row in w:                        # BND002: Python for over tensor
        t = t + float(row.sum())         # BND003 (inside the loop)
    return w64 * mean + i + t + n


leaky_batched = torch.func.vmap(leaky_step, in_dims=(0, 0, None))
