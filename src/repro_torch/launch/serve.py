"""Serving entry point: prefill a batch of prompts, then decode tokens
greedily against the KV cache — the counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve           # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \
        --reduced --device cpu

Weights, prompts and a vision config's patch embeddings (the frontend
stub's) are drawn from ``torch.Generator``s seeded by ``--seed``; they are
not ``repro``'s ``jax.random`` draws.  With a vision config the patch
embeddings come first, so the cache holds ``max_seq`` plus the frontend
tokens and decode positions start after them.  ``generate`` is the loop,
for a caller that brings its own model (any dtype) and prompts.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.frontends import VisionFrontendStub


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, model, prompts, gen, frontend_embeds=None):
    """Prefill ``prompts [B, P]`` (after ``frontend_embeds``, for a vision
    config), then ``gen - 1`` greedy decode steps at scalar positions, the
    cache in the model's dtype.  Returns (tokens [B, gen], prefill
    seconds, decode seconds), each time to the device's finish.

    A prompt shorter than a ring's width leaves that ring padded to the
    width (``attention.to_decode_layout``), so the cache holds at least
    every ring: ``max_seq`` is the longer of the sequence and the widest
    ring."""
    device = prompts.device
    B, P = prompts.shape
    offset = cfg.n_frontend_tokens if frontend_embeds is not None else 0
    max_seq = max([P + gen + offset,
                   *(width for _, width in attn.ring_specs(cfg))])
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, model, prompts, frontend_embeds)
    cache = T.grow_cache(cfg, cache, B, max_seq, model.embed.table.dtype)
    token = torch.argmax(logits[:, -1:, :], -1).to(torch.int32)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [token]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = T.decode_step(cfg, model, token, cache,
                                      offset + P + i)
        token = torch.argmax(logits, -1).to(torch.int32)
        out.append(token)
    _sync(device)
    return torch.cat(out, dim=1), prefill_s, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(args.seed),
                          device=device)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1),
        dtype=torch.int32).to(device)
    fe = None
    if cfg.frontend == "vision":
        fe = VisionFrontendStub(cfg)(
            torch.Generator().manual_seed(args.seed + 2), args.batch,
            device=device)

    toks, prefill_s, dt = generate(cfg, model, prompts, args.gen, fe)
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_s:.2f}s")
    print(f"decoded {args.gen - 1} steps x {args.batch} seqs in {dt:.2f}s "
          f"({(args.gen - 1) * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
