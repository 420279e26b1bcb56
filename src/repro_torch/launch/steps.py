"""Prefill and serve steps, the counterparts of ``make_prefill_step`` and
``make_serve_step`` in ``repro.launch.steps``.  ``make_train_step`` and
``make_mafl_step`` come with transformer training (ROADMAP queue 1, item
12)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(model, batch):
        logits, cache = T.prefill(cfg, model, batch["tokens"],
                                  batch.get("patch_embeds"))
        return logits[:, -1:, :], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """ONE new token against a pre-filled cache, written in place."""

    def serve_step(model, token, cache, pos):
        logits, cache = T.decode_step(cfg, model, token, cache, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, cache

    return serve_step
