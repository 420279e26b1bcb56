"""End-to-end MAFL training of transformer clients, the counterpart of
``repro.launch.train``.

Runs the paper's Algorithm 1 with a transformer LM as every vehicle's
model: K vehicles hold private token shards, train locally with plain SGD
(Eq. 2) on the next-token loss (Eq. 1, through K3), and the RSU merges each
upload with the MAFL weights (Eqs. 7-11; through K2 under
``--use-kernel``).  Shards, held-out set, timeline and minibatch draws are
``repro``'s numpy draws; the weights are the port's torch init, drawn from
``--seed`` (``run_training`` takes any initial model, e.g. ``repro``'s).

    PYTHONPATH=src python -m repro_torch.launch.train --use-kernel   # card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --reduced --device cpu --rounds 3
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.channel import (ChannelParams, Mobility, RayleighAR1,
                                 shannon_rate, training_delay, upload_delay)
from repro_torch.checkpointing import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.core.aggregation import afl_update, mafl_update
from repro_torch.core.events import EventQueue
from repro_torch.core.weights import combined_weight
from repro_torch.data import synth_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels.cross_entropy.ops import lm_loss
from repro_torch.models import transformer as T


def lm_loss_fn(cfg, model):
    """``loss(params, tokens)``: the mean next-token NLL (through K3) of
    ``model`` run with the param dict ``params`` on ``tokens [B, S+1]``."""
    def loss_fn(params, tokens):
        logits, aux = T.apply_params(cfg, model, params, tokens[:, :-1])
        return lm_loss(logits, tokens[:, 1:]) + aux
    return loss_fn


def lm_loss_and_grad(cfg, model):
    """``(params, tokens) -> (loss, grads)`` of ``lm_loss_fn``."""
    return T.value_and_grad(lm_loss_fn(cfg, model))


def _upload(tokens: np.ndarray, device) -> torch.Tensor:
    """A host minibatch on ``device``.  To the card through pinned memory,
    without waiting: a copy from pageable memory would wait for every step
    queued before it."""
    t = torch.from_numpy(tokens)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclass
class TrainRun:
    """What ``run_training`` leaves: the final global model and, per round,
    the uploading vehicle and its last local loss (0-d device tensors: they
    are read only where printed), and the printed held-out losses."""
    params: dict
    vehicles: list
    local_losses: list
    heldout: list            # (round, loss) pairs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the arch family")
    ap.add_argument("--scheme", default="mafl", choices=["mafl", "afl"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--l-iters", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--use-kernel", action="store_true",
                    help="aggregate with the weighted_agg kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def run_training(cfg, model, args, log=print) -> TrainRun:
    """Algorithm 1 from ``model``'s parameters (on its device), with
    ``args`` as ``build_parser`` parses them.  Reads the device only at the
    printed lines, as ``repro`` does."""
    device = model.embed.table.device
    p = ChannelParams()
    global_params = T.param_dict(model)
    vg = lm_loss_and_grad(cfg, model)
    loss_fn = lm_loss_fn(cfg, model)

    # private token shards, sized per the paper's D_i profile
    shards = [synth_tokens(max(8, p.data_count(i + 1) // 500),
                           args.seq_len + 1, cfg.vocab_size, seed=i)
              for i in range(p.K)]
    held_out = torch.from_numpy(synth_tokens(
        32, args.seq_len + 1, cfg.vocab_size, seed=999)).to(device)

    mobility, fading = Mobility(p), RayleighAR1(p, seed=args.seed)
    queue = EventQueue()
    rng = np.random.default_rng(args.seed)
    gains = fading.step()

    def schedule(vehicle, t_dl):
        c_l = training_delay(p, vehicle + 1)
        t_up = t_dl + c_l
        rate = shannon_rate(p, gains[vehicle],
                            mobility.distance(vehicle, t_up))
        c_u = upload_delay(p, rate)
        queue.push(t_up + c_u, vehicle, download_time=t_dl, train_delay=c_l,
                   upload_delay=c_u, payload=global_params)

    for k in range(p.K):
        schedule(k, 0.0)

    log(f"arch={cfg.name} reduced={args.reduced} scheme={args.scheme} "
        f"params={T.param_count(cfg):,}")
    run = TrainRun(params=global_params, vehicles=[], local_losses=[],
                   heldout=[])
    t0 = time.time()
    for r in range(1, args.rounds + 1):
        ev = queue.pop()
        local = ev.payload
        shard = shards[ev.vehicle]
        for _ in range(args.l_iters):
            rows = rng.integers(0, len(shard), args.batch)
            loss, grads = vg(local, _upload(shard[rows], device))
            local = {k: w - args.lr * grads[k] for k, w in local.items()}
        if args.scheme == "mafl":
            w = combined_weight(p, ev.upload_delay, ev.train_delay)
            global_params = mafl_update(global_params, local, p.beta, w,
                                        use_kernel=args.use_kernel)
        else:
            global_params = afl_update(global_params, local, p.beta)
        gains = fading.step()
        schedule(ev.vehicle, ev.time)
        run.vehicles.append(ev.vehicle)
        run.local_losses.append(loss)
        if r % 5 == 0 or r == args.rounds:
            with torch.no_grad():
                val = float(loss_fn(global_params, held_out))
            run.heldout.append((r, val))
            log(f"round {r:3d} vehicle {ev.vehicle} local_loss "
                f"{float(loss):.4f} heldout {val:.4f} "
                f"({time.time() - t0:.0f}s)")
    run.params = global_params
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.rounds,
                               transformer_params_to_numpy(global_params),
                               meta={"arch": cfg.name,
                                     "scheme": args.scheme})
        log("saved", path)
    return run


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(args.seed),
                          device=device)
    return run_training(cfg, model, args).params


if __name__ == "__main__":
    main()
