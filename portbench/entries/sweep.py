"""Entry ``sweep``: episodes of ``core/scenarios.py:run_sweep``.

An episode is one whole grid run as one batch of the sweep engine
(``engine="vmap"``): ``len(seeds)`` world seeds times the mix's
``betas``, variant-major, every world built, planned, run and evaluated.
Episode ``i`` uses the world seeds ``--seed + n i + j`` for ``j < n``,
``n`` the number of seeds a grid holds.  Set-up runs one grid of the same
shapes on seeds of its own.  The comparison draws ``compare.episodes``
episodes from the seed, and one world of each world seed in them.
"""
from __future__ import annotations

import numpy as np

from portbench.entries import scenario as S
from portbench.harness.record import Episode

RATES = {"world_rounds_per_s": "rounds"}


def setup(cell, seed: int, device, ref=None):
    st = S.State(cell, seed, device)
    episode(st, -1, warm=True)
    return st


def grid(st, index: int, warm: bool = False):
    """``[(world seed, beta)]`` of episode ``index``, variant-major."""
    t = st.cell.traffic
    n = t["seeds_per_grid"]
    base = st.seed + (S.WARMUP_SEED_OFFSET if warm else n * index)
    return [(base + j, b) for b in t["betas"] for j in range(n)]


def episode(st, index: int, warm: bool = False) -> Episode:
    from repro_torch.core.scenarios import SweepSpec, run_sweep
    t = st.cell.traffic
    worlds = grid(st, index, warm)
    n = t["seeds_per_grid"]
    seeds = tuple(s for s, _ in worlds[:n])
    spec = SweepSpec(
        scenario=t["scenario"], seeds=seeds,
        variants=tuple((("channel_overrides",
                         S.channel_overrides(st.cell.config, beta=b)),)
                       for b in t["betas"]),
        overrides=tuple(st.world.items()), eval_every=t["eval_every"])
    results = run_sweep(spec, engine=t["engine"], device=st.device)
    rounds = sum(len(r.rounds) for r in results)
    return Episode(
        index=index, seed=seeds[0],
        counts={"rounds": rounds, "batch_rounds": len(results[0].rounds),
                "worlds": len(results), "merges": rounds,
                "samples": rounds * st.world["l_iters"] * st.batch},
        phases=dict(results[0].report.phases),
        output=[(s, b, r) for (s, b), r in zip(worlds, results)])


def select(st, episodes: list, seed: int) -> list:
    """``compare.episodes`` episodes drawn from the seed, and in each one
    world of every timeline group (each world seed of the grid, at a beta
    drawn from the seed): worlds that share a timeline share their
    first-round training, so a second world of one group adds little."""
    c = st.cell.traffic["compare"]
    rng = np.random.default_rng(seed)
    n = min(c["episodes"], len(episodes))
    kept = []
    for i in sorted(rng.choice(len(episodes), n, replace=False)):
        kept += pick(st.cell, episodes[i].output, rng)
    for ep in episodes:
        ep.output = None
    return kept


def pick(cell, out: list, rng) -> list:
    """Of one grid's ``[(world seed, beta, result)]``, one world of each
    world seed at a beta drawn by ``rng``, as ``(seed, beta, plain)``."""
    betas = cell.traffic["betas"]
    kept = []
    for s in dict.fromkeys(s for s, _b, _r in out):
        b = betas[int(rng.integers(len(betas)))]
        r = next(r for s2, b2, r in out if s2 == s and b2 == b)
        kept.append((s, b, S.plain(r)))
    return kept


check = S.check


def control(cell, seed: int, device, ref) -> dict:
    """As the scenario entry's, on as many worlds as :func:`select`
    compares, drawn as it draws them, of the window's first
    ``compare.episodes`` grids."""
    t, betas = cell.traffic, cell.traffic["betas"]
    rng = np.random.default_rng(seed)
    kept = []
    for j in range(t["seeds_per_grid"] * t["compare"]["episodes"]):
        b = betas[int(rng.integers(len(betas)))]
        low = ref.run_world(cell.config, cell.traffic["world"], seed + j,
                            device, eval_every=cell.traffic["eval_every"],
                            beta=b, tf32=True)
        kept.append((seed + j, b, low))
    return S.check(cell, kept, ref, device)
