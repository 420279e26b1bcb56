"""Optimizers over ``{name: tensor}`` param dicts, the counterpart of
``repro.optim.optimizers`` (optax-style pure transforms).

``init(params)`` returns the state, ``update(grads, state, params)`` the
updates and the next state; ``apply_updates`` adds them.  The step counter
is a 0-d int32 tensor on the params' device and never leaves it: a
schedule reads it there.  Moments and updates are float32 whatever the
param dtype, as in ``repro``.

The paper's local update is plain SGD (Eq. 2): ``launch.steps.
make_train_step`` applies it itself and calls none of these, as
``repro``'s does; momentum and Adam serve a caller's own training loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple]   # (grads, state, params)


def _step0(params: dict) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(lr: float | Callable) -> Optimizer:
    """Eq. (2): w <- w - eta * grad.  ``lr`` a float (the update in the
    gradient's dtype) or a schedule of the step (the update in float32)."""
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params):
        eta = lr(state["step"]) if callable(lr) else lr
        upd = {k: -eta * (g.float() if callable(lr) else g)
               for k, g in grads.items()}
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum_sgd(lr: float | Callable, mu: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params)}

    def update(grads, state, params):
        eta = lr(state["step"]) if callable(lr) else lr
        m = {k: mu * mm + grads[k].float() for k, mm in state["m"].items()}
        upd = {k: -eta * mm for k, mm in m.items()}
        return upd, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with ``repro``'s ``b2 = 0.95``, the bias corrections in float32
    from the device step, and decoupled ``weight_decay``."""
    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        m = {k: b1 * mm + (1 - b1) * grads[k].float()
             for k, mm in state["m"].items()}
        v = {k: b2 * vv + (1 - b2) * torch.square(grads[k].float())
             for k, vv in state["v"].items()}
        s = step.float()
        bc1 = 1 - torch.pow(b1, s)
        bc2 = 1 - torch.pow(b2, s)
        upd = {}
        for k, mm in m.items():
            u = -(eta * (mm / bc1) / (torch.sqrt(v[k] / bc2) + eps))
            if weight_decay:
                u = u - eta * weight_decay * params[k].float()
            upd[k] = u
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    """Each param plus its update in float32, cast back to its dtype."""
    return {k: (p.float() + updates[k]).to(p.dtype)
            for k, p in params.items()}


def global_norm(tree: dict) -> torch.Tensor:
    """The float32 L2 norm over every leaf, a 0-d tensor on the device."""
    total = 0
    for leaf in tree.values():
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total))


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))``, norm); a
    16-bit gradient comes back float32, as ``repro``'s does."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            for k, g in grads.items()}, norm


__all__ = ["Optimizer", "sgd", "momentum_sgd", "adam", "apply_updates",
           "global_norm", "clip_by_global_norm"]
