"""Rank bodies of ``tests/test_torch_shard_steps.py``: the transformer on
DTensor parameters over a (2, 2) ``("data", "model")`` mesh of four gloo
ranks (``_torch_dist.start``).  This module imports neither jax nor
``repro``: the ranks run the port alone, and each returns numpy."""
from __future__ import annotations

import numpy as np
import torch

from _torch_dist import numpy_tree

ARCHS = ("smollm-360m", "deepseek-v2-lite-16b")
LR, STEPS, BATCH, SEQ = 0.1, 2, 4, 8
# llama3-405b's grouping, narrow: 32 query heads over 2 kv heads (G 16)
G16 = dict(n_heads=32, n_kv_heads=2, head_dim=64)
PROMPT, TICKS = 8, 4


def train_cfg(arch):
    """The reduced arch with 2 microbatches (the sharded run adds
    ``shard_activations``)."""
    from repro_torch.configs import get_config
    return get_config(arch).reduced().variant(microbatches=2)


def g16_cfg():
    from repro_torch.configs import get_config
    return get_config("llama3-405b").reduced().variant(**G16)


def init(cfg):
    """The port's seeded init on the CPU (the same on every rank)."""
    from repro_torch.models import transformer as T
    return T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def train(cfg, model, batch, steps=STEPS, grad_specs=None):
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    step = S.make_train_step(cfg, lr=LR, grad_specs=grad_specs)
    params = T.param_dict(model)
    for _ in range(steps):
        params, _ = step(model, params, batch)
    return params


def serve(cfg, model, prompt):
    """Prefill ``prompt``, then ``TICKS`` greedy decode ticks; the logits
    of each call."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor as dt

    def full(x):
        return x.full_tensor() if dt.is_dtensor(x) else x
    logits, cache = T.prefill(cfg, model, prompt)
    cache = T.grow_cache(cfg, cache, prompt.shape[0], PROMPT + TICKS)
    out = [full(logits)]
    tok = out[-1][:, -1:].argmax(-1)
    for i in range(TICKS):
        logits, cache = T.decode_step(cfg, model, tok, cache, PROMPT + i)
        out.append(full(logits))
        tok = out[-1].argmax(-1)
    return [x.detach().numpy().copy() for x in out]


def shard_body(rank, world):
    """On the (2, 2) mesh: each rank's local block of a spec'd array; the
    sharded train steps (``shard_activations``, ``grad_specs``, FSDP, 2
    microbatches) of both archs, gathered; the G 16 prefill and decode
    ticks on DTensor parameters and caches."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import dtensor as dt
    from repro_torch.sharding.specs import (batch_spec, param_specs,
                                            placements)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"coords": tuple(mesh.get_coordinate())}
    grid = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in ((("data", "model"), None), ("data", "model"),
                 ("model", "data"), (None, "model")):
        out["block", spec] = dt.shard(
            mesh, grid, placements(mesh, spec)).to_local().numpy().copy()
    for arch in ARCHS:
        cfg = train_cfg(arch).variant(shard_activations=True)
        specs = param_specs(cfg, mesh, fsdp=True)
        model = dt.shard_module(init(cfg), mesh, specs)
        batch = {"tokens": dt.shard(
            mesh, torch.from_numpy(tokens(cfg, (BATCH, SEQ + 1), 1)),
            placements(mesh, batch_spec(mesh, BATCH) + (None,)))}
        params = train(cfg, model, batch, grad_specs=specs)
        out[arch, "placements kept"] = all(
            list(p.placements) == list(placements(mesh, specs[k]))
            for k, p in params.items())
        out[arch] = numpy_tree({k: p.full_tensor()
                                for k, p in params.items()})
    cfg = g16_cfg()
    model = dt.shard_module(init(cfg), mesh,
                            param_specs(cfg, mesh, fsdp=True))
    prompt = dt.shard(mesh, torch.from_numpy(tokens(cfg, (BATCH, PROMPT), 2)),
                      placements(mesh, batch_spec(mesh, BATCH) + (None,)))
    out["g16"] = serve(cfg, model, prompt)
    return out
