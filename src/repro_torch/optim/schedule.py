"""Learning-rate schedules, the counterpart of ``repro.optim.schedule``:
functions of the 0-d int32 step tensor returning a 0-d float32 tensor on
its device (no host read)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_decay(lr: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        frac = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        return floor + (lr - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         floor: float = 0.0):
    """``lr * step / warmup`` while ``step < warmup``, then a cosine decay
    over the remaining ``total_steps - warmup`` steps."""
    cos = cosine_decay(lr, max(total_steps - warmup, 1), floor)

    def fn(step):
        warm = lr * step.float() / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return fn
