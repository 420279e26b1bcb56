"""Entry ``lm_train``: episodes of ``launch/train.py:run_training``.

A transformer LM is every vehicle's model: each episode is one whole call
of the loop (shards and held-out rows built, the timeline drawn, ``rounds``
arrivals, each ``l_iters`` local SGD steps on ``batch x seq_len`` rows and
one MAFL merge, the held-out loss every five rounds and after the last).
The mix gives what ``run_training`` takes (``scheme``, ``rounds``,
``l_iters``, ``lr``, ``batch``, ``seq_len``, ``use_kernel``); the rest of
the loop's world is fixed in it, and the reference states it once.  The configuration's file gives the model; the weights are made
on the card from ``--seed`` by the reference's ``make_weights`` and copied
into the program's model once, in set-up; every episode starts from them.
Episode ``i`` draws its timeline and minibatches from ``--seed + i``.
Set-up runs a one-round episode, which meets every shape the window does
(a local step, a merge, a held-out loss).  The comparison re-runs the
window's first episode.
"""
from __future__ import annotations

import argparse

import torch

from portbench.harness.record import Episode

RATES = {"trained_tokens_per_s": "tokens"}
WARMUP_SEED_OFFSET = 1_000_003


def arch(config: dict):
    """The program's ``ArchConfig`` of a Qwen2-style configuration."""
    from repro_torch.configs.base import ArchConfig
    H = config["num_attention_heads"]
    return ArchConfig(
        name=config["name"], family="dense", source=config["source"],
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=H, n_kv_heads=config["num_key_value_heads"],
        head_dim=config["hidden_size"] // H,
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        norm_eps=config["rms_norm_eps"], qkv_bias=config["qkv_bias"],
        rope_theta=config["rope_theta"],
        tie_embeddings=config["tie_word_embeddings"])


# the program's parameter name in a layer -> the reference's leaf
LAYER_NAMES = {"ln1.scale": "attn_norm", "ln2.scale": "mlp_norm",
               "mixer.wq": "q_w", "mixer.wk": "k_w", "mixer.wv": "v_w",
               "mixer.wo": "o_w", "mixer.bq": "q_b", "mixer.bk": "k_b",
               "mixer.bv": "v_b", "mlp.w_gate": "gate_w",
               "mlp.w_up": "up_w", "mlp.w_down": "down_w"}


def reference_name(name: str) -> str:
    """The reference's leaf of the program's parameter ``name``."""
    if name == "embed.table":
        return "embed"
    if name == "final_norm.scale":
        return "final_norm"
    _stack, i, _sub, rest = name.split(".", 3)
    return f"layers.{i}.{LAYER_NAMES[rest]}"


def reference_weights(ref, config: dict, params: dict) -> dict:
    """The program's parameters as the reference's leaves (views)."""
    shapes = ref.shapes(config)
    out = {}
    for k, v in params.items():
        n = reference_name(k)
        out[n] = v.reshape(shapes[n][0])
    return out


class State:
    def __init__(self, cell, seed, device, ref):
        from repro_torch.models import transformer as T
        self.cell, self.seed, self.device, self.ref = cell, seed, device, ref
        self.cfg = arch(cell.config)
        w = self.ref.make_weights(cell.config, seed, device)
        self.model = T.Transformer(self.cfg, torch.float32, device)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(w[reference_name(name)].view(p.shape))
        del w


def _args(traffic: dict, seed: int, rounds: int):
    return argparse.Namespace(
        arch="", reduced=False, scheme=traffic["scheme"], rounds=rounds,
        l_iters=traffic["l_iters"], lr=traffic["lr"], batch=traffic["batch"],
        seq_len=traffic["seq_len"], seed=seed, ckpt_dir=None,
        use_kernel=traffic["use_kernel"], device=None)


def _quiet(*_a, **_k):
    pass


def setup(cell, seed: int, device, ref):
    from repro_torch.launch.train import run_training
    st = State(cell, seed, device, ref)
    run_training(st.cfg, st.model,
                 _args(cell.traffic, seed + WARMUP_SEED_OFFSET, 1), _quiet)
    return st


def episode(st, index: int) -> Episode:
    from repro_torch.launch.train import run_training
    t = st.cell.traffic
    seed = st.seed + index
    run = run_training(st.cfg, st.model, _args(t, seed, t["rounds"]),
                       _quiet)
    steps = t["rounds"] * t["l_iters"]
    return Episode(
        index=index, seed=seed,
        counts={"tokens": steps * t["batch"] * t["seq_len"],
                "steps": steps, "merges": t["rounds"],
                "rows": steps * t["batch"], "evals": len(run.heldout),
                "eval_rows": len(run.heldout) * st.ref.HELDOUT_ROWS},
        output=(seed, run) if index == 0 else None)


def select(st, episodes: list, seed: int) -> list:
    """The window's first episode, in the reference's terms."""
    ep_seed, run = episodes[0].output
    for ep in episodes:
        ep.output = None
    prog = {"vehicles": list(run.vehicles),
            "local_losses": [float(x) for x in run.local_losses],
            "heldout": list(run.heldout),
            "params": reference_weights(st.ref, st.cell.config,
                                        run.params)}
    return [(ep_seed, st.seed, prog)]


def check(cell, kept: list, ref, device) -> list:
    out = []
    for seed, w_seed, prog in kept:
        want = ref.run_episode(cell.config, cell.traffic, seed, w_seed,
                               device)
        out.append(ref.compare(prog, want))
        del want
    return out


def control(cell, seed: int, device, ref) -> list:
    """The reference in TF32 put in the program's place, against the
    reference in float32, on the window's first episode."""
    low = ref.run_episode(cell.config, cell.traffic, seed, seed, device,
                          tf32=True)
    low.pop("init")
    return check(cell, [(seed, seed, low)], ref, device)
