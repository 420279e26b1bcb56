"""Entry ``scenario``: episodes of ``core/scenarios.py:run_scenario``.

An episode is one whole call, as a researcher runs a world: the world is
built from its seed (data, shards, channel), planned, run on the engine
the mix names and evaluated.  Episode ``i`` runs the world seeded with
``--seed + i``; set-up runs one episode of the same shapes on a seed of its
own, so every kernel and allocation the window meets is warm.

The mix (``traffic/<name>.json``) gives the registered ``scenario``, its
``engine``, ``use_kernel``, ``eval_every`` and the ``world`` it runs, each
field stated in full and handed to the program as overrides, so the world
stays what the file says.  The configuration gives Table I's channel.
"""
from __future__ import annotations

import numpy as np

from portbench.harness.record import Episode
from portbench.reference import _world as W

# end-to-end rate -> the episode count it divides by the window
RATES = {"world_rounds_per_s": "rounds"}
WARMUP_SEED_OFFSET = 1_000_003


class State:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.world = cell.traffic["world"]
        ch = W.channel(cell.config, K=self.world["K"])
        self.batch = W.minibatch(ch, self.world)


def channel_overrides(config: dict, **changes) -> tuple:
    return tuple(sorted({**config["channel"], **changes}.items()))


def setup(cell, seed: int, device, ref=None):
    st = State(cell, seed, device)
    episode(st, -1, warm=True)
    return st


def _call(st, world_seed: int):
    from repro_torch.core.scenarios import run_scenario
    t = st.cell.traffic
    return run_scenario(t["scenario"], seed=world_seed, engine=t["engine"],
                        use_kernel=t["use_kernel"],
                        eval_every=t["eval_every"], device=st.device,
                        channel_overrides=channel_overrides(st.cell.config),
                        **st.world)


def episode(st, index: int, warm: bool = False) -> Episode:
    seed = st.seed + (WARMUP_SEED_OFFSET if warm else index)
    res = _call(st, seed)
    rounds = len(res.rounds)
    return Episode(
        index=index, seed=seed,
        counts={"rounds": rounds, "merges": rounds, "worlds": 1,
                "samples": rounds * st.world["l_iters"] * st.batch},
        phases=dict(res.report.phases), output=[(seed, None, res)])


def plain(res) -> dict:
    """A program result in the reference's terms."""
    return {"events": [(r.vehicle, float(r.time)) for r in res.rounds],
            "acc": list(res.acc_history), "loss": list(res.loss_history),
            "params": res.final_params}


def select(st, episodes: list, seed: int) -> list:
    """The outputs the comparison reads: ``compare.episodes`` episodes of
    the window drawn from the seed, each a list of ``(world seed, beta,
    result)``; the rest is dropped."""
    n = min(st.cell.traffic["compare"]["episodes"], len(episodes))
    rng = np.random.default_rng(seed)
    pick = sorted(rng.choice(len(episodes), n, replace=False))
    kept = []
    for i in pick:
        kept.extend((s, b, plain(r)) for s, b, r in episodes[i].output)
    for ep in episodes:
        ep.output = None
    return kept


def check(cell, kept: list, ref, device) -> list:
    """The numbers of the compared worlds taken together (one item),
    against the reference's run of each world in float32."""
    pairs = []
    for seed, beta, prog in kept:
        want = ref.run_world(cell.config, cell.traffic["world"], seed,
                             device, eval_every=cell.traffic["eval_every"],
                             beta=beta)
        pairs.append((prog, want))
    return [ref.compare(pairs)]


def control(cell, seed: int, device, ref) -> dict:
    """The reference in TF32 put in the program's place, against the
    reference in float32, on the worlds of the window's first
    ``compare.episodes`` episodes."""
    kept = []
    for i in range(cell.traffic["compare"]["episodes"]):
        low = ref.run_world(cell.config, cell.traffic["world"], seed + i,
                            device, eval_every=cell.traffic["eval_every"],
                            tf32=True)
        kept.append((seed + i, None, low))
    return check(cell, kept, ref, device)
