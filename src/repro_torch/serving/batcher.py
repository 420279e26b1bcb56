"""Slot-based continuous-batching server for the decode path, the
counterpart of ``repro.serving.batcher``.

A fixed pool of ``n_slots`` cache slots, each slot independently somewhere
in its sequence; one fused decode step advances every slot per tick, with
a position per slot.  New requests claim free slots (their prompt is
prefilled and written into the slot's cache row); finished slots free
immediately — no batch barrier.

The cache lives on the model's device and every step writes it in place.
Each tick reads the slots' next tokens back to the host (the host decides
which requests are done), as ``repro``'s server does.

Per-slot positions rule out ring caches (sliding-window or chunked
attention take one position for the batch, as ``repro`` asserts), and
admission prefills text only, so vision configs, which need patch
embeddings, cannot be served either: both raise ``ValueError`` at
construction rather than mid-run.  Audio configs serve their codes as
token ids.  MoE and MLA configs (deepseek-v2-lite-16b) serve as dense ones
do: the MLA latents are written at each slot's own position by
``attention.mla_decode``, and a ``first_k_dense`` prefix's cache rows are
written beside the stack's.  SSM configs (rwkv6-1.6b, jamba-v0.1-52b)
hold a state per slot with no sequence axis: admission copies the
prompt's final state into the slot's row whole, and each tick advances
every slot's state, free slots too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int32
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Continuous batching over a fixed slot pool."""

    def __init__(self, cfg: ArchConfig, model: T.Transformer,
                 n_slots: int = 4, max_seq: int = 128,
                 eos_id: Optional[int] = None):
        rings = sorted({kind for kind, _ in attn.ring_specs(cfg)})
        if rings:
            raise ValueError(f"{cfg.name}: {rings} ring caches take one "
                             f"position for the batch; BatchedServer "
                             f"decodes each slot at its own")
        if cfg.frontend == "vision" and cfg.n_frontend_tokens:
            raise ValueError(f"{cfg.name}: BatchedServer prefills text "
                             f"only; a vision config needs patch embeddings")
        self.cfg = cfg
        self.model = model
        self.device = model.embed.table.device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache = T.init_cache(cfg, n_slots, max_seq,
                                  model.embed.table.dtype, self.device)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.queue: list[Request] = []
        self._rid = 0
        self._prefill = make_prefill_step(cfg)
        self._step = make_serve_step(cfg)
        self._last_tokens = np.zeros((n_slots, 1), np.int32)

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int) -> Request:
        req = Request(self._rid, np.asarray(prompt, np.int32), max_new)
        self._rid += 1
        self.queue.append(req)
        return req

    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def pending(self) -> int:
        return len(self.queue)

    # -- engine ---------------------------------------------------------------
    def _admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            P = len(req.prompt)
            if P > self.max_seq:
                raise ValueError(f"request {req.rid}: prompt of {P} tokens "
                                 f"exceeds max_seq={self.max_seq}")
            tokens = torch.from_numpy(req.prompt[None]).to(self.device)
            logits, cache = self._prefill(self.model, {"tokens": tokens})
            # the slot's whole cache row (the values of repro's
            # grow-then-set): a sequence leaf's prompt entries and zeros
            # past them, a state leaf (SSM mixers, the channel-mix shift)
            # copied whole; stack leaves carry the period axis first,
            # prefix leaves (first_k_dense) none
            for j, sub in enumerate(self.cfg.sublayers()):
                self._write_row(sub, cache["stack"][f"sub{j}"],
                                self.cache["stack"][f"sub{j}"], slot, P, 1)
            for i, layer in enumerate(cache.get("prefix", ())):
                self._write_row(self.cfg.prefix_sublayer(), layer,
                                self.cache["prefix"][i], slot, P, 0)
            # repro-check: waive[BND003] one sync per admit, as in repro
            first = int(torch.argmax(logits[0, -1]))
            req.out.append(first)
            self.slot_req[slot] = req
            self.slot_pos[slot] = P
            self._last_tokens[slot, 0] = first

    @staticmethod
    def _write_row(sub, new, cache, slot, P, lead):
        """Write a prefill's one-sequence cache ``new`` of one sublayer
        into row ``slot`` of ``cache`` (``lead`` axes before the batch)."""
        for group, leaves in new.items():
            for leaf, c in leaves.items():
                row = cache[group][leaf].select(lead, slot)
                one = c.select(lead, 0)
                if T.is_state(sub, group):
                    row.copy_(one)
                    continue
                seq = (slice(None),) * lead
                row[seq + (slice(0, P),)] = one
                row[seq + (slice(P, None),)] = 0

    def tick(self):
        """One decode step for every slot (free slots ride along)."""
        self._admit()
        if self.active() == 0:
            return
        pos = torch.from_numpy(self.slot_pos.astype(np.int32)).to(
            self.device)
        tokens = torch.from_numpy(self._last_tokens).to(self.device)
        next_tokens, self.cache = self._step(self.model, tokens, self.cache,
                                             pos)
        # repro-check: waive[BND003] one sync per tick by design, as in repro
        next_np = next_tokens[:, 0].cpu().numpy()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(next_np[slot])
            req.out.append(tok)
            self.slot_pos[slot] += 1
            self._last_tokens[slot, 0] = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if len(req.out) >= req.max_new or hit_eos or \
                    self.slot_pos[slot] >= self.max_seq - 1:
                req.done = True
                self.slot_req[slot] = None       # slot freed immediately

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or self.active()) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks
