"""Plain reference of the paper's MAFL world with its CNN (Section III-B,
Algorithm 1, Eqs. 1-12), one arrival at a time.

K vehicles under one RSU each download the global model, train ``l`` SGD
steps on a private shard (Eq. 2 on the cross-entropy of Eq. 1), and upload
at ``t_download + C_l + C_u``; the RSU takes uploads in time order and mixes
each into the global model with the share ``alpha = clip((1 - beta)
gamma^(C_u - 1) zeta^(C_l - 1), 0, 1)`` (Eqs. 7-11), then the vehicle
downloads again.  Accuracy (Eq. 12) and the mean loss on the test set are
taken every ``eval_every`` arrivals and after the last.

Plain PyTorch and numpy: the world (data, shards, channel, minibatch
draws, initial weights) is worked out again from the seed by
``_world.py``'s frozen copies, in float32 with TF32 off unless the
control asks for TF32.  Nothing of the program is imported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import _world as W

LEAVES = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "fc1_w", "fc1_b",
          "fc2_w", "fc2_b")


def init_params(config: dict, seed: int, device) -> dict:
    """The weights a world starts from: fan-in scaled normals drawn in
    leaf order from a CPU ``torch.Generator`` seeded with the world's seed,
    zero biases; convolutions HWIO, ``fc1_w`` rows in (h, w, c) order."""
    g = torch.Generator().manual_seed(seed)
    k, (h, _w, c_in) = config["kernel"], config["image"]
    out = {}
    for j, c_out in enumerate(config["conv_channels"], 1):
        w = torch.randn((k, k, c_in, c_out), generator=g)
        out[f"conv{j}_w"] = w / math.sqrt(k * k * c_in)
        out[f"conv{j}_b"] = torch.zeros(c_out)
        h, c_in = h // 2, c_out
    d_in = h * h * c_in
    for j, d_out in enumerate((*config["dense"], config["classes"]), 1):
        out[f"fc{j}_w"] = torch.randn((d_in, d_out), generator=g) / \
            math.sqrt(d_in)
        out[f"fc{j}_b"] = torch.zeros(d_out)
        d_in = d_out
    return {n: out[n].to(device) for n in LEAVES}


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2, stride-2 max pool of NCHW ``x`` whose gradient is shared evenly
    by tied maxima (the max's gradient as the paper's reference code takes
    it; clipped pixels make exact ties common).  ``F.max_pool2d`` would
    hand all of it to one of them, another subgradient."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def forward(p: dict, images: torch.Tensor) -> torch.Tensor:
    """NHWC images ``[B, 28, 28, 1]`` -> logits ``[B, 10]``."""
    x = images.permute(0, 3, 1, 2)
    for j in (1, 2):
        x = F.conv2d(x, p[f"conv{j}_w"].permute(3, 2, 0, 1),
                     p[f"conv{j}_b"], padding=1)
        x = max_pool(F.relu(x))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ p["fc1_w"] + p["fc1_b"])
    return x @ p["fc2_w"] + p["fc2_b"]


def sgd_step(p: dict, images, labels, lr: float):
    """One SGD step: the new weights and each leaf's gradient norm."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    with torch.enable_grad():
        loss = F.cross_entropy(forward(leaves, images), labels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - lr * g).detach()
           for (k, v), g in zip(leaves.items(), grads)}
    return new, {k: float(torch.linalg.vector_norm(g))
                 for k, g in zip(leaves, grads)}


@torch.no_grad()
def evaluate(p: dict, images, labels, block: int = 1000):
    correct, nll = 0.0, 0.0
    for s in range(0, len(labels), block):
        logits = forward(p, images[s:s + block])
        lab = labels[s:s + block]
        correct += float((logits.argmax(-1) == lab).sum())
        nll += float(F.cross_entropy(logits, lab, reduction="sum"))
    return correct / len(labels), nll / len(labels)


def run_world(config: dict, world: dict, seed: int, device, *,
              eval_every: int, beta: float | None = None,
              tf32: bool = False) -> dict:
    """One world, as the program's entry runs it with the same seed:
    returns the arrival order and times, the eval history, the final and
    initial global weights (on ``device``) and the first local step's
    gradient norm of every leaf."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run(config, world, seed, device, eval_every, beta)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _run(config, world, seed, device, eval_every, beta):
    changes = {"K": world["K"]}
    if beta is not None:
        changes["beta"] = beta
    ch = W.channel(config, **changes)
    tr_i, tr_l, te_i, te_l = W.synth_mnist(world["n_train"], world["n_test"],
                                           config["data_seed"],
                                           world["noise"])
    shards = W.split(tr_i, tr_l, ch, seed, world["scale"],
                     world.get("max_per_vehicle"))
    b = W.minibatch(ch, world)
    rngs = [np.random.default_rng(seed + i) for i in range(1, ch.K + 1)]
    te_i = torch.from_numpy(te_i).to(device)
    te_l = torch.from_numpy(te_l.astype(np.int64)).to(device)
    gains = W.SlotGains(W.Fading(ch, seed))
    queue = W.Uploads()
    init = init_params(config, seed, device)
    snapshots = {0: init}
    waiting = {0: ch.K}                 # snapshot -> uploads that hold it

    def schedule(k, t_dl, snap):
        c_l = ch.training_delay(k + 1)
        t_up = t_dl + c_l
        c_u = ch.upload_delay(gains.at(t_up)[k], ch.distance(k, t_up))
        queue.push(time=t_up + c_u, vehicle=k, download_time=t_dl,
                   train_delay=c_l, upload_delay=c_u, snapshot=snap)

    for k in range(ch.K):
        schedule(k, 0.0, 0)
    g, grad0 = init, None
    events, acc, loss = [], [], []
    lr, l_iters = world["lr"], world["l_iters"]
    for r in range(1, world["rounds"] + 1):
        ev = queue.pop()
        local = snapshots[ev.snapshot]
        waiting[ev.snapshot] -= 1
        if not waiting[ev.snapshot]:
            del snapshots[ev.snapshot], waiting[ev.snapshot]
        imgs, labs = shards[ev.vehicle]
        for _ in range(l_iters):
            rows = rngs[ev.vehicle].choice(len(labs), b, replace=False)
            local, norms = sgd_step(
                local, torch.from_numpy(imgs[rows]).to(device),
                torch.from_numpy(labs[rows].astype(np.int64)).to(device),
                lr)
            grad0 = norms if grad0 is None else grad0
        a = ch.mix(ev.upload_delay, ev.train_delay)
        g = {k: v * (1.0 - a) + local[k] * a for k, v in g.items()}
        events.append((ev.vehicle, ev.time))
        if r % eval_every == 0 or r == world["rounds"]:
            ac, lo = evaluate(g, te_i, te_l)
            acc.append((r, ac))
            loss.append((r, lo))
        snapshots[r], waiting[r] = g, 1
        schedule(ev.vehicle, ev.time, r)
    return {"events": events, "acc": acc, "loss": loss, "params": g,
            "init": init, "grad0": grad0}


# how far an arrival time may sit from the float64 plan's: the device
# engines keep times in float32, and the program holds them to this
TIME_RTOL, TIME_ATOL = 1e-4, 1e-3


def compare(pairs: list) -> dict:
    """The numbers that decide ``correct`` for the compared worlds, each a
    ``(program, reference)`` pair of :func:`run_world`-shaped results:

    - ``order``: arrivals whose vehicle differs from the reference's, or
      whose time is off by more than ``TIME_RTOL`` relative plus
      ``TIME_ATOL`` seconds, and arrivals or evals that one side lacks,
      summed over the worlds (exact: the timeline never reads a weight);
    - ``loss``: the median of the relative gaps between the program's and
      the reference's test loss, over every eval of every compared world
      taken together.  The median of them all, and not a world's worst
      eval or a world's median: max pooling shares its gradient among tied
      maxima, and a float32 sum taken in another order (the batched
      engines' grouped convolutions) now and then breaks a tie another
      way.  That moves one local update by up to 1e-2 of its change, and
      in the first K arrivals, which all train from the initial weights,
      it moves the update of every world that shares the timeline alike;
      the gap it leaves lasts through most of a world's evals.  Lower
      precision moves every update of every world;
    - ``change``: the worst world's worst leaf's gap between the norm of
      the program's change of the global weights over the world (final
      less initial) and the reference's, over the reference's norm of
      that leaf or of the median leaf, whichever is larger.  Leaves whose
      first gradient in the reference is under a thousandth of the median
      leaf's would move by rounding alone and are left out (none of this
      CNN's do).  A state that never moves reads 1.
    """
    order, gaps, change = 0, [], []
    for prog, ref in pairs:
        n = min(len(prog["events"]), len(ref["events"]))
        order += abs(len(prog["events"]) - len(ref["events"]))
        for (pv, pt), (rv, rt) in zip(prog["events"][:n], ref["events"][:n]):
            order += int(int(pv) != int(rv)
                         or abs(pt - rt) > TIME_ATOL + TIME_RTOL * abs(rt))
        if [r for r, _ in prog["loss"]] != [r for r, _ in ref["loss"]]:
            return {"order": order + 1, "loss": math.inf,
                    "change": math.inf}
        gaps += [abs(p - r) / abs(r) for (_, p), (_, r) in
                 zip(prog["loss"], ref["loss"])]
        change.append(change_gap(prog["params"], ref))
    # np.max and not max: a NaN must not be passed over
    return {"order": order, "loss": float(np.median(gaps)),
            "change": float(np.max(change))}


def change_gap(params: dict, ref: dict) -> float:
    """The ``change`` number of :func:`compare` for the program's final
    weights ``params``."""
    g_med = float(np.median(list(ref["grad0"].values())))
    d_ref, d_prog = {}, {}
    for k, g0 in ref["grad0"].items():
        if g0 < 1e-3 * g_med:
            continue
        init = ref["init"][k]
        d_ref[k] = float(torch.linalg.vector_norm(ref["params"][k] - init))
        d_prog[k] = float(torch.linalg.vector_norm(
            torch.as_tensor(params[k], device=init.device).reshape(
                init.shape) - init))
    floor = float(np.median(list(d_ref.values())))
    # np.max and not max: a NaN leaf must not be passed over
    return float(np.max([abs(d_prog[k] - d_ref[k]) / max(d_ref[k], floor)
                         for k in d_ref]))
