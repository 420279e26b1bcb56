"""Scenario registry: named, parameterized simulation worlds (DESIGN.md §8).

The full registry of ``repro.core.scenarios``, as data, so every named world
builds identically in both packages.  ``run_scenario`` runs the single-RSU
worlds on the host engines (``serial`` and ``batched``), on the device
fleet engine (``jit``, with the bf16 ring where the world asks for it) and
as a one-world batch of the sweep engine (``vmap``), and the multi-RSU
corridor worlds on the device corridor engine (``corridor``) and the
serial handover loop (``serial``), vehicle selection and fault injection
included.  :class:`SweepSpec` and :func:`run_sweep` run a grid of worlds
over one base scenario as one batch (``core/sweep.py``), or one by one on
``jit``.

    from repro_torch.core.scenarios import SweepSpec, run_scenario, run_sweep
    result = run_scenario("paper-k10", use_kernel=True)     # on the card
    result = run_scenario("fleet-k10000")       # fleet engine, bf16 ring
    result = run_scenario("corridor-r8-k4000")  # corridor engine
    result = run_scenario("fleet-k1000-topk", K=40, device="cpu")
    result = run_scenario("fleet-k1000-flaky", rounds=10, device="cpu")
    results = run_sweep(SweepSpec(             # Fig. 5: 5 betas x 3 seeds
        scenario="paper-k10", seeds=(0, 1, 2),
        variants=tuple((("channel_overrides", (("beta", b),)),)
                       for b in (0.1, 0.3, 0.5, 0.7, 0.9))))
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.channel import ChannelParams
from repro_torch.core.mafl import ENGINES, SimResult, run_simulation
from repro_torch.device import resolve_device
from repro_torch.faults import scenario_faults
from repro_torch.selection import scenario_spec
from repro_torch.telemetry import PhaseTimers

# engines that run multi-RSU corridor worlds: the device corridor engine
# and the serial handover loop
CORRIDOR_ENGINES = ("corridor", "serial")


@dataclass(frozen=True)
class Scenario:
    """Everything needed to build and run one simulation world."""
    name: str
    description: str
    K: int = 10
    rounds: int = 40
    l_iters: int = 5
    lr: float = 0.03
    scheme: str = "mafl"
    # data world
    n_train: int = 6000
    n_test: int = 800
    noise: float = 0.5
    scale: float = 0.02
    dirichlet_alpha: Optional[float] = None
    max_per_vehicle: Optional[int] = None
    # topology
    n_rsus: int = 1
    reconcile_every: int = 8
    # cloud-tier reconciliation (multi-RSU only): "fedavg" = every cohort
    # adopts the cross-RSU mean; "ema" = each cohort moves reconcile_tau
    # toward it (DESIGN.md §10)
    reconcile_mode: str = "fedavg"
    reconcile_tau: float = 0.5
    # initial corridor placement: "uniform" traffic or a "rush" wave
    # packed into the westmost segment (CorridorMobility entry profiles)
    corridor_entry: str = "uniform"
    # vehicle selection (DESIGN.md §11): policy name (None = the paper's
    # admit-everyone baseline with zero selection machinery), per-RSU
    # admission cap k, per-RSU upload-airtime budget (seconds/cycle),
    # bandit exploration probability, and the single-RSU re-selection
    # epoch in rounds (corridor worlds re-score at reconcile boundaries)
    selection: Optional[str] = None
    selection_k: Optional[int] = None
    selection_budget: Optional[float] = None
    selection_eps: float = 0.1
    resel_every: Optional[int] = None
    # snapshot-ring dtype on the device engines' flat fast path (DESIGN.md
    # §12): "f32" = bitwise-exact (golden-pinned); "bf16" = half-memory
    # ring + upload buffers around f32 master weights — an explicit
    # opt-in, never a default precision change
    ring_dtype: str = "f32"
    # fault injection (DESIGN.md §16): name of a FaultSpec profile from
    # ``repro_torch.faults.PROFILES`` (None = the fault-free world — the
    # engines run their exact path without faults), plus
    # dataclasses.replace(...) override pairs applied to the profile
    faults: Optional[str] = None
    faults_overrides: tuple = ()
    # dataclasses.replace(...) overrides applied to ChannelParams
    channel_overrides: tuple = ()

    def channel(self) -> ChannelParams:
        return dataclasses.replace(ChannelParams(), K=self.K,
                                   **dict(self.channel_overrides))

    def selection_spec(self):
        """The scenario's :class:`repro_torch.selection.SelectionSpec`
        (or None)."""
        return scenario_spec(self)


_REGISTRY: dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    if sc.name in _REGISTRY:
        raise ValueError(f"duplicate scenario {sc.name!r}")
    _REGISTRY[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; known: {known}") from None


def list_scenarios() -> list[str]:
    return sorted(_REGISTRY)


register(Scenario(
    name="paper-k10",
    description="The paper's Section V-A world: K=10, Table-I "
                "heterogeneity, IID shards (CPU-scaled).",
))
register(Scenario(
    name="paper-k10-noniid",
    description="Paper world with Dirichlet(0.5) class-skewed shards.",
    dirichlet_alpha=0.5,
))
register(Scenario(
    name="quick-k5",
    description="Five-vehicle smoke world for tests and CI.",
    K=5, rounds=10, l_iters=2, n_train=1200, n_test=240, scale=0.01,
))
register(Scenario(
    name="fleet-k100",
    description="Fleet-scale: 100 vehicles under one RSU; shard storage "
                "capped so the wave engine batches ~uniform minibatches.",
    K=100, rounds=120, scale=0.022, max_per_vehicle=512,
    n_train=4000, n_test=800,
))
register(Scenario(
    name="fleet-k100-noniid",
    description="100-vehicle fleet with Dirichlet(0.3) heterogeneity.",
    K=100, rounds=120, scale=0.022, max_per_vehicle=512,
    n_train=4000, n_test=800, dirichlet_alpha=0.3,
))
register(Scenario(
    name="fleet-k1000",
    description="Mega-fleet: 1000 vehicles under one RSU, single local "
                "step per download (many clients x few local iterations); "
                "sized for engine='jit' (DESIGN.md §9) — the snapshot ring "
                "holds rounds+1 models instead of 1000 payloads.",
    K=1000, rounds=30, l_iters=1, scale=0.004, max_per_vehicle=256,
    n_train=4000, n_test=400,
))
register(Scenario(
    name="fleet-k1000-noniid",
    description="Mega-fleet with Dirichlet(0.3) class-skewed shards.",
    K=1000, rounds=30, l_iters=1, scale=0.004, max_per_vehicle=256,
    n_train=4000, n_test=400, dirichlet_alpha=0.3,
))
register(Scenario(
    name="fleet-k10000",
    description="Giga-fleet: 10000 vehicles under one RSU — the regime "
                "the DRL-selection literature studies (PAPERS.md) and the "
                "flat fast path unlocks: the bf16 snapshot ring + packed "
                "upload buffers halve the ring memory that caps the f32 "
                "pytree layout (DESIGN.md §12), and aggregation streams "
                "as fused ring_agg chains.",
    K=10000, rounds=60, l_iters=1, scale=0.0008, max_per_vehicle=64,
    n_train=4000, n_test=400, ring_dtype="bf16",
))
register(Scenario(
    name="platoon-burst-k500",
    description="Bursty arrivals: 500 vehicles in platoons of 25 sharing "
                "the leader's compute/data (identical training delays), so "
                "uploads land in near-simultaneous bursts — stress test "
                "for time-ordered consumption under the jit engine.",
    K=500, rounds=40, l_iters=1, scale=0.005, max_per_vehicle=256,
    n_train=4000, n_test=400,
    channel_overrides=(("platoon", 25),),
))
register(Scenario(
    name="highway-k40-handover",
    description="Four-RSU corridor, 40 vehicles with handover and "
                "periodic cross-RSU reconciliation.",
    K=40, rounds=80, n_rsus=4, reconcile_every=8,
    scale=0.02, max_per_vehicle=512, n_train=4000, n_test=800,
))
register(Scenario(
    name="corridor-quick-r2-k8",
    description="Two-RSU, eight-vehicle corridor smoke world for tests "
                "and the CI corridor bench.",
    K=8, rounds=8, l_iters=1, n_rsus=2, reconcile_every=4,
    n_train=1200, n_test=240, scale=0.01,
))
register(Scenario(
    name="corridor-r4-k400",
    description="Conformance-sized corridor: four RSUs, 400 vehicles, "
                "device-resident handover engine vs the serial reference.",
    K=400, rounds=40, l_iters=1, n_rsus=4, reconcile_every=8,
    scale=0.006, max_per_vehicle=256, n_train=4000, n_test=400,
))
register(Scenario(
    name="corridor-r8-k4000",
    description="Mega-corridor: eight RSUs, 4000 vehicles — four times "
                "the largest single-RSU fleet; sized for "
                "engine='corridor' (the serial reference is extrapolated "
                "only, DESIGN.md §10).",
    K=4000, rounds=40, l_iters=1, n_rsus=8, reconcile_every=8,
    scale=0.0015, max_per_vehicle=128, n_train=4000, n_test=400,
))
register(Scenario(
    name="fleet-k1000-topk",
    description="Mega-fleet with weighted-topk selection (DESIGN.md §11): "
                "the RSU admits the 250 best vehicles by data x compute x "
                "predicted residence time, so waves shrink 4x at equal "
                "rounds (arXiv:2304.02832's selection ingredients).",
    K=1000, rounds=30, l_iters=1, scale=0.004, max_per_vehicle=256,
    n_train=4000, n_test=400,
    selection="weighted-topk", selection_k=250,
))
register(Scenario(
    name="fleet-k1000-budget",
    description="Mega-fleet under a per-cycle upload-airtime budget "
                "(arXiv:2210.15496's binding constraint): cheapest-upload "
                "vehicles admitted until 0.5 s of slot budget is spent.",
    K=1000, rounds=30, l_iters=1, scale=0.004, max_per_vehicle=256,
    n_train=4000, n_test=400,
    selection="budget", selection_budget=0.5,
))
register(Scenario(
    name="corridor-r4-k400-bandit",
    description="Conformance-sized corridor with eps-greedy bandit "
                "selection: each RSU admits its 25 best vehicles by "
                "historical delay-weight reward (10% exploration), "
                "re-scored at every reconcile boundary so handed-over "
                "vehicles are re-scored by their new RSU.",
    K=400, rounds=40, l_iters=1, n_rsus=4, reconcile_every=8,
    scale=0.006, max_per_vehicle=256, n_train=4000, n_test=400,
    selection="eps-bandit", selection_k=25, selection_eps=0.1,
))
register(Scenario(
    name="corridor-rush-hour-r8-k4000",
    description="Rush hour on the mega-corridor: 4000 vehicles in "
                "platoons of 50 entering at the west end, a density wave "
                "propagating down the eight RSU cells (bursty arrivals + "
                "skewed per-RSU load).",
    K=4000, rounds=40, l_iters=1, n_rsus=8, reconcile_every=8,
    scale=0.0015, max_per_vehicle=128, n_train=4000, n_test=400,
    corridor_entry="rush", channel_overrides=(("platoon", 50),),
))
register(dataclasses.replace(
    get_scenario("fleet-k1000"),
    name="fleet-k1000-flaky",
    description="Mega-fleet under flaky connectivity (DESIGN.md §16): "
                "8% of uploads drop mid-flight and vehicles fall into "
                "Gilbert-Elliott blackouts (~30 s mean), with uploads "
                "staler than 12 rounds discarded at the RSU — the "
                "graceful-degradation baseline for the faults bench.",
    faults="flaky",
))
register(dataclasses.replace(
    get_scenario("corridor-rush-hour-r8-k4000"),
    name="corridor-rush-hour-deadzone-r8-k4000",
    description="Rush hour on the mega-corridor with coverage dead zones "
                "(DESIGN.md §16): 10% blackout entry per cycle with ~60 s "
                "mean outages — a platoon that enters a dead zone goes "
                "dark as a block — and a 16-round staleness cap at every "
                "RSU; recovered vehicles re-admit at reconcile "
                "boundaries.",
    faults="deadzone",
))
register(dataclasses.replace(
    get_scenario("fleet-k1000"),
    name="fleet-k1000-throttled",
    description="Mega-fleet under compute throttling (DESIGN.md §16): "
                "half the training cycles finish only a prefix of the "
                "local epochs (partial computation), 30% of vehicles are "
                "4x stragglers, and an 8-round staleness cap discards "
                "what arrives too late.",
    faults="throttled",
))


def build_world(sc: Scenario, seed: int = 0):
    """Materialize (vehicles, test_images, test_labels, params) for ``sc``."""
    # deferred: repro_torch.data imports repro_torch.core.client, so a
    # module-level import here would make the core package circular
    from repro_torch.data import partition_vehicles, synth_mnist
    tr_i, tr_l, te_i, te_l = synth_mnist(n_train=sc.n_train,
                                         n_test=sc.n_test, seed=0,
                                         noise=sc.noise)
    p = sc.channel()
    veh = partition_vehicles(tr_i, tr_l, p, seed=seed, scale=sc.scale,
                             dirichlet_alpha=sc.dirichlet_alpha,
                             max_per_vehicle=sc.max_per_vehicle)
    return veh, te_i, te_l, p


def run_scenario(scenario: str | Scenario, *, seed: int = 0,
                 engine: Optional[str] = None, eval_every: int = 10,
                 progress=None, use_kernel: bool = False, mesh=None,
                 record_cohorts: bool = False, flat: Optional[bool] = None,
                 metrics=None, device=None, **overrides) -> SimResult:
    """Build the named world and run it on ``device`` (``None`` -> the
    card); ``overrides`` replace Scenario fields (e.g. ``rounds=20``).

    ``engine=None`` auto-selects as ``repro`` does: ``"corridor"`` for
    multi-RSU worlds; for single-RSU ones ``"jit"`` when the world's ring is
    not f32 (the bf16 ring exists only on the device engines' flat path),
    else ``"batched"``.  An engine that cannot run the world's topology
    raises.  ``mesh`` (``launch/mesh.py``) and ``record_cohorts`` reach
    the corridor engine only: a multi-RSU world on ``engine="serial"``
    refuses them, as ``repro`` does, and a single-RSU world refuses a mesh
    (``repro`` drops it there; its wave sharding is
    ``run_simulation_jit(mesh=...)``).  ``flat`` reaches the device
    engines (``None`` = their default, flat on).  The
    world's fault profile (``faults`` with ``faults_overrides``) is
    resolved once and handed to every engine.  ``metrics`` reaches every
    engine; the result's ``report`` carries the scenario's name.
    ``engine="vmap"`` runs the world as a one-world sweep batch
    (``core/sweep.py``), which has no ``use_kernel``, ``mesh``,
    ``record_cohorts`` or ``flat=False`` and raises on them, on fault
    worlds and on metrics, as ``repro`` does."""
    device = resolve_device(device)
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if overrides:
        sc = dataclasses.replace(sc, **overrides)
    flt = scenario_faults(sc)
    if sc.ring_dtype != "f32" and (engine not in (None, "jit", "corridor",
                                                  "vmap")
                                   or flat is False):
        raise ValueError(
            f"ring_dtype={sc.ring_dtype!r} needs the flat fast path of a "
            "device engine (engine='jit' or the corridor engine); the "
            "host engines and the pytree layout keep full precision")
    if sc.n_rsus > 1:
        eng = engine or "corridor"
        if eng not in CORRIDOR_ENGINES:
            raise ValueError(
                f"engine {eng!r} cannot run multi-RSU scenario "
                f"{sc.name!r} (n_rsus={sc.n_rsus}); corridor scenarios "
                f"accept {CORRIDOR_ENGINES}")
    else:
        eng = engine or ("jit" if sc.ring_dtype != "f32" else "batched")
        if eng in CORRIDOR_ENGINES and eng not in ENGINES:
            raise ValueError(
                f"engine {eng!r} needs a multi-RSU corridor scenario; "
                f"{sc.name!r} has a single RSU — use one of {ENGINES}")
        if eng not in ENGINES and eng != "vmap":
            raise ValueError(
                f"unknown engine {eng!r}; expected one of {ENGINES} or "
                f"'vmap' (single-RSU) or {CORRIDOR_ENGINES} (multi-RSU)")
    if eng == "vmap":
        # a W = 1 sweep batch (DESIGN.md §15): every channel scalar is
        # batch-uniform, so the world runs the fleet engine's loop op for op
        if use_kernel or mesh is not None or record_cohorts:
            raise ValueError(
                "engine='vmap' has no use_kernel/mesh/record_cohorts: "
                "the sweep tier compiles the flat in-scan program only "
                "(DESIGN.md §15) — run the world solo with engine='jit'")
        if flat is False:
            raise ValueError(
                "engine='vmap' is flat-only: the world axis lives on the "
                "packed [W, P] buffer (DESIGN.md §15)")
        from repro_torch.core.sweep import run_simulation_vmap
        cb = None if progress is None else (
            lambda _w, rr, acc: progress(rr, acc))
        return _stamp(run_simulation_vmap(
            [(sc, seed)], eval_every=eval_every, metrics=metrics,
            progress=cb, device=device)[0], sc)
    if mesh is not None and sc.n_rsus == 1:
        raise ValueError(
            "mesh reaches the corridor engine only (multi-RSU worlds); "
            "shard a single-RSU world's wave training with "
            "core.jit_engine.run_simulation_jit(mesh=...)")
    timers = PhaseTimers()
    with timers.phase("world"):
        veh, te_i, te_l, p = build_world(sc, seed=seed)
    if sc.n_rsus > 1:
        from repro_torch.corridor import (run_corridor_simulation,
                                          run_handover_simulation)
        if eng == "serial":
            if mesh is not None or record_cohorts:
                raise ValueError(
                    "mesh/record_cohorts require engine='corridor'; the "
                    "serial reference runs unsharded and keeps no cohort "
                    "snapshots")
            return _stamp(run_handover_simulation(
                sc, veh, te_i, te_l, p, seed=seed, eval_every=eval_every,
                use_kernel=use_kernel, progress=progress,
                selection=sc.selection_spec(), metrics=metrics,
                faults=flt, device=device), sc, timers)
        return _stamp(run_corridor_simulation(
            sc, veh, te_i, te_l, p, seed=seed, eval_every=eval_every,
            use_kernel=use_kernel, mesh=mesh, record_cohorts=record_cohorts,
            progress=progress, selection=sc.selection_spec(), flat=flat,
            metrics=metrics, faults=flt, device=device), sc, timers)
    kw = {} if flat is None else {"flat": flat}
    return _stamp(run_simulation(
        veh, te_i, te_l, scheme=sc.scheme,
        rounds=sc.rounds, l_iters=sc.l_iters, lr=sc.lr,
        params=p, seed=seed, eval_every=eval_every,
        use_kernel=use_kernel, engine=eng, progress=progress,
        selection=sc.selection_spec(), ring_dtype=sc.ring_dtype,
        metrics=metrics, faults=flt, device=device, **kw), sc, timers)


def _stamp(result: SimResult, sc: Scenario,
           timers: Optional[PhaseTimers] = None) -> SimResult:
    """Stamp the scenario name, and the phases ``run_scenario`` timed
    around the engine (``world``), onto the run's telemetry report."""
    result.report.scenario = sc.name
    if timers is not None:
        result.report.phases.update(timers.snapshot())
    return result


# ---------------------------------------------------------------------------
# multi-world sweeps (DESIGN.md §15)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SweepSpec:
    """A grid of worlds over one base scenario.

    ``variants`` is a tuple of override-sets — each itself a tuple of
    ``(field, value)`` pairs applied to the base scenario with
    ``dataclasses.replace`` (so e.g. a beta ablation is
    ``variants=tuple((("channel_overrides", (("beta", b),)),)
    for b in BETAS)``) — and every variant runs at every seed.
    World order is variant-major: ``w = i_variant * len(seeds) + i_seed``.
    ``overrides`` apply to the base scenario before the variants do."""
    scenario: object = "paper-k10"        # name or Scenario
    seeds: tuple = (0,)
    variants: tuple = ((),)
    overrides: tuple = ()
    eval_every: int = 10

    def worlds(self) -> list:
        """The grid as ``[(Scenario, seed), ...]``, variant-major."""
        sc = (get_scenario(self.scenario)
              if isinstance(self.scenario, str) else self.scenario)
        if self.overrides:
            sc = dataclasses.replace(sc, **dict(self.overrides))
        out = []
        for var in self.variants:
            sc_v = dataclasses.replace(sc, **dict(var)) if var else sc
            for seed in self.seeds:
                out.append((sc_v, int(seed)))
        return out


def run_sweep(spec: SweepSpec, *, engine: str = "vmap", progress=None,
              device=None) -> list[SimResult]:
    """Run every world of ``spec`` on ``device`` (``None`` -> the card);
    returns per-world ``SimResult``s in variant-major order, each stamped
    with its scenario and carrying its engine's ``RunReport``.

    ``engine="vmap"`` (the default) runs the whole grid as one batch of
    the sweep engine (``core/sweep.py``); ``engine="jit"`` runs the same
    worlds one by one through the solo fleet engine: the conformance
    oracle and the baseline.  ``progress`` fires after each run as
    ``progress(world_index, round, acc)`` under either engine."""
    device = resolve_device(device)
    worlds = spec.worlds()
    if engine == "vmap":
        from repro_torch.core.sweep import run_simulation_vmap
        results = run_simulation_vmap(worlds, eval_every=spec.eval_every,
                                      progress=progress, device=device)
    elif engine == "jit":
        results = []
        for w, (sc, seed) in enumerate(worlds):
            cb = None if progress is None else (
                lambda rr, acc, _w=w: progress(_w, rr, acc))
            results.append(run_scenario(sc, seed=seed, engine="jit",
                                        eval_every=spec.eval_every,
                                        progress=cb, device=device))
    else:
        raise ValueError(
            f"run_sweep engine must be 'vmap' or 'jit', not {engine!r}")
    for (sc, _seed), r in zip(worlds, results):
        _stamp(r, sc)
    return results
