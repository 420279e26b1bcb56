"""Serving entry point: prefill a batch of prompts, then decode tokens
greedily against the KV cache — the counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve           # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Weights and prompts are drawn from ``torch.Generator``s seeded by
``--seed``; they are not ``repro``'s ``jax.random`` draws.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    max_seq = args.prompt_len + args.gen
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1),
        dtype=torch.int32).to(device)

    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, model, prompts)
    cache = T.grow_cache(cfg, cache, args.batch, max_seq)
    _sync(device)
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{time.perf_counter() - t0:.2f}s")

    token = torch.argmax(logits[:, -1:, :], -1).to(torch.int32)
    out = [token]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = T.decode_step(cfg, model, token, cache,
                                      args.prompt_len + i)
        token = torch.argmax(logits, -1).to(torch.int32)
        out.append(token)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    print(f"decoded {args.gen - 1} steps x {args.batch} seqs in {dt:.2f}s "
          f"({(args.gen - 1) * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
