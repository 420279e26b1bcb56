"""Vehicle-side local training (Algorithm 1, "Vehicle Update").

A client owns a private data shard and runs ``l`` SGD iterations (Eq. 2) from
the downloaded global model.  The ``l`` iterations are a Python loop of
functional steps (``torch.func.grad_and_value``); ``local_update_many``
additionally trains a chunk of vehicles as one batched step through
``torch.func.vmap`` of the same loop, so a wave of pending uploads trains
with one set of launches per chunk.

Minibatches are drawn with host numpy RNG in exactly ``repro.core.client``'s
order, so both packages train on identical batches.

``make_lm_local_step`` is the local SGD step of a transformer client, over
a ``{name: tensor}`` param dict with the loss through K3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cross_entropy.ops import lm_loss
from repro_torch.models.cnn import sgd_train_step
from repro_torch.models.transformer import value_and_grad


@dataclass
class VehicleData:
    """Private shard of vehicle i (1-based index per the paper)."""
    index: int
    images: np.ndarray      # [D_i, 28, 28, 1]
    labels: np.ndarray      # [D_i]

    @property
    def size(self) -> int:
        return len(self.labels)


def _local_scan(params, images, labels, lr):
    """l SGD iterations (Eq. 2).  images [l, b, 28, 28, 1]; returns the
    updated params and the loss of the last step."""
    loss = None
    for t in range(images.shape[0]):
        params, loss = sgd_train_step(params, images[t], labels[t], lr)
    return params, loss


# vehicle-batched path: vmap the identical loop over stacked (params, data)
_local_scan_vmap = torch.func.vmap(_local_scan, in_dims=(0, 0, 0, None))
# shared-payload wave (the fleet engine): one params dict broadcast to every
# vehicle's data, so the first step's forward convolutions keep unbatched
# filters and run as one large batch instead of grouped convolutions
_local_scan_shared = torch.func.vmap(_local_scan, in_dims=(None, 0, 0, None))


def _local_scan_partial(params, images, labels, lr, n_ep):
    """Partial computation (faults, DESIGN.md §16): the same ``l`` steps,
    but only the first ``n_ep`` (an int tensor) apply — deadline
    semantics, so every gradient is still computed on the same minibatches
    and steps ``>= n_ep`` leave the params as they are.  Returns the
    updated params and the loss of the last live step.  At ``n_ep == l``
    it is bitwise :func:`_local_scan`; that loop stays separate so the
    path without faults is untouched."""
    last = None
    for t in range(images.shape[0]):
        new, loss = sgd_train_step(params, images[t], labels[t], lr)
        live = t < n_ep
        params = {k: torch.where(live, new[k], w) for k, w in params.items()}
        last = torch.where(live, loss,
                           torch.zeros_like(loss) if last is None else last)
    return params, last


# the partial scan's vmaps: per-row params, and a payload shared by the
# whole wave (the fleet engine's initial-download waves)
_local_scan_partial_vmap = torch.func.vmap(_local_scan_partial,
                                           in_dims=(0, 0, 0, None, 0))
_local_scan_partial_shared = torch.func.vmap(_local_scan_partial,
                                             in_dims=(None, 0, 0, None, 0))


def _batch_tensors(images: np.ndarray, labels: np.ndarray, device):
    return (torch.from_numpy(np.ascontiguousarray(images)).to(device),
            torch.from_numpy(labels.astype(np.int64)).to(device))


class Vehicle:
    """One FL client.  ``local_update`` = l iterations of Eq. (1)+(2)."""

    def __init__(self, data: VehicleData, lr: float = 0.01,
                 batch_size: int = 128, seed: int = 0, device=None):
        self.data = data
        self.lr = lr
        self.device = resolve_device(device)
        # The paper's Eq. (1) sums the loss over all D_i data each iteration;
        # minibatch SGD (batch_size<=D_i) is the documented deviation
        # (DESIGN.md §6) that preserves Eq. (2).
        self.batch_size = min(batch_size, data.size)
        self.rng = np.random.default_rng(seed + data.index)

    def sample_batches(self, l_iters: int):
        """Draw the l minibatches for one local update (host RNG).

        Drawn in the same per-iteration order as ``repro``, so a vehicle's
        RNG stream advances identically regardless of which engine (serial
        or vehicle-batched) consumes the batches."""
        sel = np.stack([self.rng.choice(self.data.size, self.batch_size,
                                        replace=False)
                        for _ in range(l_iters)])
        return self.data.images[sel], self.data.labels[sel]

    def local_update(self, global_params, l_iters: int, n_ep=None):
        """``n_ep`` truncates the update to the first n_ep of the l_iters
        steps (partial computation, faults); the minibatches of all
        l_iters steps are drawn regardless, so the RNG stream stays aligned
        with the run without faults."""
        imgs, labs = _batch_tensors(*self.sample_batches(l_iters),
                                    self.device)
        if n_ep is None:
            params, loss = _local_scan(global_params, imgs, labs, self.lr)
        else:
            params, loss = _local_scan_partial(
                global_params, imgs, labs, self.lr,
                torch.tensor(n_ep, device=self.device))
        return params, float(loss)


def local_update_many(payloads: Sequence, batches: Sequence, lr: float,
                      chunk: int = 16, n_eps: Sequence | None = None):
    """Train a wave of vehicles.

    ``payloads``: per-vehicle global-model snapshots (param dicts on one
    device); ``batches``: matching numpy ``[l, b, ...]`` minibatch pairs,
    all the same shape.  Full ``chunk``-sized slices of the wave stack
    their params and train as one vmapped step; the remainder trains one
    event at a time through the serial loop — the same split as
    ``repro.core.client.local_update_many``.  Returns the list of updated
    param dicts and the final losses.

    ``n_eps`` (faults, partial computation): matching per-vehicle epoch
    counts; when given, every update runs the masked partial scan (a
    count equal to l_iters is bitwise the full update)."""
    outs, losses = [], []
    n = len(payloads)
    if n == 0:
        return outs, losses
    device = next(iter(payloads[0].values())).device
    full = (n // chunk) * chunk if chunk > 1 else 0
    for s in range(0, full, chunk):
        pay = payloads[s:s + chunk]
        stacked = {k: torch.stack([p[k] for p in pay]) for k in pay[0]}
        imgs, labs = _batch_tensors(
            np.stack([b[0] for b in batches[s:s + chunk]]),
            np.stack([b[1] for b in batches[s:s + chunk]]), device)
        if n_eps is None:
            out, ls = _local_scan_vmap(stacked, imgs, labs, lr)
        else:
            eps = torch.tensor(n_eps[s:s + chunk], device=device)
            out, ls = _local_scan_partial_vmap(stacked, imgs, labs, lr, eps)
        outs.extend({k: v[i] for k, v in out.items()} for i in range(chunk))
        losses.extend(ls.tolist())
    for i in range(full, n):
        imgs, labs = _batch_tensors(batches[i][0], batches[i][1], device)
        if n_eps is None:
            params, loss = _local_scan(payloads[i], imgs, labs, lr)
        else:
            params, loss = _local_scan_partial(
                payloads[i], imgs, labs, lr,
                torch.tensor(n_eps[i], device=device))
        outs.append(params)
        losses.append(float(loss))
    return outs, losses


def make_lm_local_step(cfg, forward_fn):
    """Local SGD step factory for transformer clients:
    ``step(params, tokens, lr) -> (params, loss)`` with ``forward_fn(cfg,
    params, inputs) -> (logits, aux)`` (e.g. ``transformer.apply_params``
    of a model) and the mean next-token loss through K3."""

    def loss_fn(p, tokens):
        logits, aux = forward_fn(cfg, p, tokens[:, :-1])
        return lm_loss(logits, tokens[:, 1:]) + aux

    vg = value_and_grad(loss_fn)

    def step(params, tokens, lr):
        loss, grads = vg(params, tokens)
        return {k: w - lr * grads[k] for k, w in params.items()}, loss

    return step
