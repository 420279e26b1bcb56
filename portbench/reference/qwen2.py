"""Plain reference of Qwen1.5-0.5B trained per vehicle and merged at the RSU.

The model follows Qwen2's published description: token embedding; per
layer, RMSNorm, q/k/v projections with bias, split-halves rotary
embedding (theta from the config), causal softmax attention over all
heads (as many kv heads as query heads), an output projection without
bias, a residual, RMSNorm, a SwiGLU MLP (``down(silu(gate x) * up x)``)
and a residual; a final RMSNorm and the tied embedding as the LM head.
The loss is the mean next-token cross-entropy.

The federated loop is Algorithm 1 with this model as every vehicle's: K
vehicles hold token shards, train ``l_iters`` plain SGD steps on
minibatches of shard rows from the downloaded global model, and the RSU
mixes each upload in arrival order with the share ``clip((1 - beta)
gamma^(C_u - 1) zeta^(C_l - 1), 0, 1)``; the held-out loss is taken every
:data:`EVAL_EVERY` rounds and after the last.  Channel gains advance one
AR(1) step at the start and after every round.  The loop's world is fixed
(it takes no setting for it): Table I's channel with its K = 10 vehicles
(``_world.Channel``'s defaults), shards sized by the paper's D_i, and the
held-out rows below; the traffic mix gives only what the loop takes.

Plain PyTorch in float32 with TF32 off (the control turns TF32 on), no
kernel, cache or checkpoint; the weights are made here from the seed
(:func:`make_weights`, which the benchmark also hands the program), the
data and the timeline by ``_world.py``'s frozen copies.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import _world as W

# the training loop's fixed world: a held-out loss every EVAL_EVERY rounds
# and after the last, on HELDOUT_ROWS rows drawn from HELDOUT_SEED
EVAL_EVERY = 5
HELDOUT_ROWS = 32
HELDOUT_SEED = 999

LAYER_LEAVES = ("attn_norm", "q_w", "q_b", "k_w", "k_b", "v_w", "v_b",
                "o_w", "mlp_norm", "gate_w", "up_w", "down_w")


def shapes(config: dict) -> dict:
    """Leaf name -> (shape, kind) in the order the weights are drawn."""
    d, V = config["hidden_size"], config["vocab_size"]
    H, Kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd, ff = d // H, config["intermediate_size"]
    out = {"embed": ((V, d), "embed")}
    for i in range(config["num_hidden_layers"]):
        per = {"attn_norm": ((d,), "norm"), "q_w": ((d, H * hd), "w"),
               "q_b": ((H * hd,), "b"), "k_w": ((d, Kv * hd), "w"),
               "k_b": ((Kv * hd,), "b"), "v_w": ((d, Kv * hd), "w"),
               "v_b": ((Kv * hd,), "b"), "o_w": ((H * hd, d), "w"),
               "mlp_norm": ((d,), "norm"), "gate_w": ((d, ff), "w"),
               "up_w": ((d, ff), "w"), "down_w": ((ff, d), "w")}
        out.update({f"layers.{i}.{k}": v for k, v in per.items()})
    out["final_norm"] = ((d,), "norm")
    return out


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """The weights of a run: one normal draw of every element on
    ``device`` from a generator seeded with ``seed``, cut into the leaves
    and scaled by kind (embedding 0.02, a projection 1/sqrt(fan-in), a
    bias 0.02, a norm scale 1 + 0.02 n)."""
    sh = shapes(config)
    total = sum(math.prod(s) for s, _ in sh.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, kind) in sh.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        if kind == "embed" or kind == "b":
            w.mul_(0.02)
        elif kind == "w":
            w.mul_(1.0 / math.sqrt(shape[0]))
        else:
            w.mul_(0.02).add_(1.0)
        out[name] = w
    return out


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def logits(config: dict, w: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]``."""
    B, S = tokens.shape
    d = config["hidden_size"]
    H, Kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd, eps = d // H, config["rms_norm_eps"]
    dev = tokens.device
    inv = 1.0 / (config["rope_theta"]
                 ** (torch.arange(0, hd, 2, device=dev,
                                  dtype=torch.float32) / hd))
    ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    h = w["embed"][tokens]
    for i in range(config["num_hidden_layers"]):
        p = {k: w[f"layers.{i}.{k}"] for k in LAYER_LEAVES}
        x = _rms(h, p["attn_norm"], eps)
        q = (x @ p["q_w"] + p["q_b"]).view(B, S, H, hd)
        k = (x @ p["k_w"] + p["k_b"]).view(B, S, Kv, hd)
        v = (x @ p["v_w"] + p["v_b"]).view(B, S, Kv, hd)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k = k.repeat_interleave(H // Kv, dim=2)
        v = v.repeat_interleave(H // Kv, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        a = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", a, v).reshape(B, S, H * hd)
        h = h + o @ p["o_w"]
        x = _rms(h, p["mlp_norm"], eps)
        h = h + (F.silu(x @ p["gate_w"]) * (x @ p["up_w"])) @ p["down_w"]
    return _rms(h, w["final_norm"], eps) @ w["embed"].t()


def loss(config, w, rows: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``rows [B, S + 1]``."""
    lg = logits(config, w, rows[:, :-1])
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           rows[:, 1:].reshape(-1).long())


def sgd_step(config, w, rows, lr):
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    with torch.enable_grad():
        lo = loss(config, leaves, rows)
    grads = torch.autograd.grad(lo, list(leaves.values()))
    new = {k: (v - lr * g).detach()
           for (k, v), g in zip(leaves.items(), grads)}
    norms = {k: float(torch.linalg.vector_norm(g))
             for k, g in zip(leaves, grads)}
    return new, float(lo.detach()), norms


@torch.no_grad()
def heldout_loss(config, w, rows, block: int = 8) -> float:
    """Mean over equal blocks of rows (the mean over all of them)."""
    parts = [float(loss(config, w, rows[s:s + block]))
             for s in range(0, len(rows), block)]
    return sum(parts) / len(parts)


def run_episode(config: dict, traffic: dict, seed: int, weights_seed: int,
                device, tf32: bool = False) -> dict:
    """One episode of the loop, as the program runs it with ``seed`` from
    the weights made from ``weights_seed``: vehicles in arrival order, each
    round's last local loss, the held-out losses, the final global weights,
    the initial ones, and the first local step's gradient norm of every
    leaf."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _episode(config, traffic, seed, weights_seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _episode(config, traffic, seed, weights_seed, device):
    ch = W.Channel()
    V, S, B = config["vocab_size"], traffic["seq_len"], traffic["batch"]
    shards = [W.synth_tokens(max(8, ch.data_count(i + 1) // 500), S + 1, V,
                             seed=i) for i in range(ch.K)]
    held = torch.from_numpy(W.synth_tokens(HELDOUT_ROWS, S + 1, V,
                                           seed=HELDOUT_SEED)).to(device)
    init = make_weights(config, weights_seed, device)
    fading = W.Fading(ch, seed)
    gains = fading.step()
    queue = W.Uploads()
    rng = np.random.default_rng(seed)
    snapshots, waiting = {0: init}, {0: ch.K}

    def schedule(k, t_dl, snap):
        c_l = ch.training_delay(k + 1)
        t_up = t_dl + c_l
        c_u = ch.upload_delay(gains[k], ch.distance(k, t_up))
        queue.push(time=t_up + c_u, vehicle=k, download_time=t_dl,
                   train_delay=c_l, upload_delay=c_u, snapshot=snap)

    for k in range(ch.K):
        schedule(k, 0.0, 0)
    g, vehicles, losses, held_losses, grad0 = init, [], [], [], None
    R = traffic["rounds"]
    for r in range(1, R + 1):
        ev = queue.pop()
        local = snapshots[ev.snapshot]
        waiting[ev.snapshot] -= 1
        if not waiting[ev.snapshot]:
            del snapshots[ev.snapshot], waiting[ev.snapshot]
        shard = shards[ev.vehicle]
        for _ in range(traffic["l_iters"]):
            rows = rng.integers(0, len(shard), B)
            local, lo, norms = sgd_step(
                config, local, torch.from_numpy(shard[rows]).to(device),
                traffic["lr"])
            grad0 = norms if grad0 is None else grad0
        a = ch.mix(ev.upload_delay, ev.train_delay)
        g = {k: v * (1.0 - a) + local[k] * a for k, v in g.items()}
        del local
        gains = fading.step()
        snapshots[r], waiting[r] = g, 1
        schedule(ev.vehicle, ev.time, r)
        vehicles.append(ev.vehicle)
        losses.append(lo)
        if r % EVAL_EVERY == 0 or r == R:
            held_losses.append((r, heldout_loss(config, g, held)))
    return {"vehicles": vehicles, "local_losses": losses,
            "heldout": held_losses, "params": g, "init": init,
            "grad0": grad0}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct`` for one episode:

    - ``order``: rounds whose uploading vehicle differs, and rounds or
      held-out losses that one side lacks (exact);
    - ``local_loss``: the largest relative gap between a round's last
      local loss and the reference's;
    - ``heldout``: the largest relative gap between the held-out losses;
    - ``change``: the median over the leaves of the gap between the norm
      of the program's change of the global weights over the episode and
      the reference's, relative to the reference's.  Leaves whose first
      gradient in the reference is under a thousandth of the median
      leaf's move by rounding alone and are left out.  The median and not
      the worst leaf: the norm scales (values near 1 that move by 3e-4 in
      an episode) round by 6e-8 at every update, which is 4e-3 of their
      change whatever the program does.
    """
    order = sum(int(a) != int(b)
                for a, b in zip(prog["vehicles"], ref["vehicles"]))
    order += abs(len(prog["vehicles"]) - len(ref["vehicles"]))
    # np.max and not max: a NaN loss must not be passed over
    local = float(np.max([abs(p - r) / abs(r) for p, r in
                          zip(prog["local_losses"], ref["local_losses"])]))
    if [r for r, _ in prog["heldout"]] != [r for r, _ in ref["heldout"]]:
        return {"order": order + 1, "local_loss": local, "heldout": math.inf,
                "change": math.inf}
    held = float(np.max([abs(p - r) / abs(r) for (_, p), (_, r) in
                         zip(prog["heldout"], ref["heldout"])]))
    g_med = float(np.median(list(ref["grad0"].values())))
    rel = []
    for k, g0 in ref["grad0"].items():
        if g0 < 1e-3 * g_med:
            continue
        init = ref["init"][k]
        d_ref = float(torch.linalg.vector_norm(ref["params"][k] - init))
        d_prog = float(torch.linalg.vector_norm(prog["params"][k] - init))
        rel.append(abs(d_prog - d_ref) / d_ref)
    return {"order": order, "local_loss": local, "heldout": held,
            "change": float(np.median(rel))}
