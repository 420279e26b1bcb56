"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh*.py``).

:func:`start` runs a body on ``world`` processes that
``torch.multiprocessing`` starts, over gloo on the CPU, with the process
group on a ``file://`` store under the test's ``tmp_path`` (so pytest-xdist
workers share no TCP port) and one torch thread a rank.  Each rank returns
its results as numpy, which the test compares with ``repro``'s unsharded
runs and the port's.  This module imports neither jax nor ``repro``: the
ranks run the port alone."""
from __future__ import annotations

import dataclasses
import pickle
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

QUICK = "corridor-quick-r2-k8"
# a collective that never meets its peers fails the test instead of hanging
TIMEOUT = timedelta(seconds=120)


def start(body, world: int, tmp_path, *args):
    """Start ``body(rank, world, *args)`` on ``world`` spawned ranks and
    return a function that waits for them and returns each rank's return
    value, in rank order (a failed rank raises there).  The caller works
    while the ranks run."""
    ctx = mp.spawn(_rank, args=(world, str(tmp_path), body, args),
                   nprocs=world, join=False)

    def results() -> list:
        while not ctx.join():
            pass
        out = []
        for r in range(world):
            with open(tmp_path / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    return results


def _rank(rank, world, tmp, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        res = body(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def numpy_tree(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def numpy_init(seed: int = 0) -> dict:
    """The port's seeded CNN init as numpy leaves: both packages take it
    through ``init_params`` (drawing ``repro``'s would compile JAX)."""
    from repro_torch.models.cnn import init_cnn
    return numpy_tree(init_cnn(torch.Generator().manual_seed(seed),
                               device="cpu"))


def digest(res) -> dict:
    """What a run computes, as numpy: the trace, the final params, the
    eval history and the corridor's cohort stacks."""
    ex = res.extras or {}
    return {
        "trace": [(r.round, r.vehicle, r.rsu) for r in res.rounds],
        "times": np.array([[r.time, r.upload_delay, r.train_delay, r.weight]
                           for r in res.rounds]),
        "params": numpy_tree(res.final_params),
        "acc": list(res.acc_history),
        "loss": list(res.loss_history),
        "final_cohorts": (numpy_tree(ex["final_cohorts"])
                          if "final_cohorts" in ex else None),
        "cohorts": [numpy_tree(c) for c in ex.get("cohort_snapshots", [])],
    }


class Counts:
    """Calls of the aggregation wrappers in this rank (``ring_agg``: K1;
    ``weighted_agg_tree``: K2), the launches they make on the card."""

    NAMES = ("ring_agg", "weighted_agg_tree")

    def __init__(self):
        from repro_torch.kernels.weighted_agg import ops
        self.n = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(ops, name)

            def wrap(*a, _real=real, _name=name, **kw):
                self.n[_name] += 1
                return _real(*a, **kw)
            setattr(ops, name, wrap)

    def take(self) -> dict:
        out, self.n = self.n, dict.fromkeys(self.NAMES, 0)
        return out


# ---------------------------------------------------------------------------
# the runs, shared by the rank bodies and the tests' unsharded runs
# ---------------------------------------------------------------------------
# fleet-k1000 cut to K 16 (and 100 test images) for 14 rounds: a wave of 12
# events of one payload and one of 2 events of a payload each
FLEET_CUT = dict(K=16, n_test=100)
FLEET_ROUNDS = 14


def fleet_run(init, mesh=None, **kw):
    """The fleet-k1000 cut on the port's fleet engine on the CPU from
    ``init`` (numpy leaves)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core.jit_engine import run_simulation_jit
    from repro_torch.core.scenarios import build_world, get_scenario
    sc = dataclasses.replace(get_scenario("fleet-k1000"), **FLEET_CUT)
    veh, ti, tl, p = build_world(sc)
    return run_simulation_jit(
        veh, ti, tl, scheme=sc.scheme, rounds=FLEET_ROUNDS,
        l_iters=sc.l_iters, lr=sc.lr, params=p, eval_every=4, mesh=mesh,
        init_params=params_from_jax(init, "cpu"), device="cpu", **kw)


# corridor-quick-r2-k8 for 6 rounds of one local step (repro's own sharded
# corridor test), with reconciles at rounds 4 and the evals at 3 and 6
CORRIDOR_CUT = dict(rounds=6, l_iters=1)
CORRIDOR_RUNS = {
    "kernel": dict(use_kernel=True),
    "ema-kernel-cohorts": dict(reconcile_mode="ema", reconcile_tau=0.3,
                               use_kernel=True, record_cohorts=True),
}


def corridor_run(variant, init, mesh=None, flat=None, **fields):
    """corridor-quick-r2-k8 cut by ``CORRIDOR_CUT`` under ``variant``
    (``CORRIDOR_RUNS``) on the port's corridor engine on the CPU."""
    from repro_torch.convert import params_from_jax
    from repro_torch.corridor import run_corridor_simulation
    from repro_torch.core.scenarios import build_world, get_scenario
    kw = dict(CORRIDOR_RUNS[variant])
    sc_fields = {k: kw.pop(k) for k in ("reconcile_mode", "reconcile_tau")
                 if k in kw}
    sc = dataclasses.replace(get_scenario(QUICK), **CORRIDOR_CUT,
                             **sc_fields, **fields)
    veh, ti, tl, p = build_world(sc)
    return run_corridor_simulation(
        sc, veh, ti, tl, p, eval_every=3, mesh=mesh, flat=flat,
        init_params=params_from_jax(init, "cpu"), device="cpu", **kw)


def refusal(fn) -> str:
    """The message of the ``ValueError`` that ``fn()`` raises, or "" when
    it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# the rank body
# ---------------------------------------------------------------------------
# the meshes of the four ranks: a two-rank axis is one of two axes of 2, the
# other ("model") one that neither engine reads, so each pair of ranks along
# it runs the two-rank program; rank r sits at (r // 2, r % 2)
MESHES = {"data 2": ((2, 2), ("data", "model")),
          "data 4": ((4,), ("data",)),
          "rsu 2": ((2, 2), ("rsu", "model")),
          "rsu 2 data 2": ((2, 2), ("rsu", "data")),
          "rsu 4": ((4,), ("rsu",))}


def four_ranks_body(rank, world, init, leaves):
    """Four ranks over gloo: the fleet engine over ``"data"`` axes of 2
    and 4 (flat; the pytree program under ``use_kernel`` over 2), the
    corridor over an ``"rsu"`` axis of 2 (the EMA variant) and its FedAvg
    variant over ``("rsu", "data")`` (2, 2), with each run's wrapper
    calls; the corridor's refusals; then :func:`hierarchy` on
    ``leaves``."""
    from repro_torch.launch.mesh import make_mesh
    counts = Counts()
    meshes = {tag: make_mesh(shape, axes, "cpu")
              for tag, (shape, axes) in MESHES.items()}
    out = {}
    for tag in ("data 2", "data 4"):
        out["fleet", tag] = digest(fleet_run(init, meshes[tag]))
        out["fleet", tag, "counts"] = counts.take()
    out["fleet pytree", "data 2"] = digest(fleet_run(
        init, meshes["data 2"], flat=False, use_kernel=True))
    out["fleet pytree", "data 2", "counts"] = counts.take()
    out["corridor", "rsu 2"] = digest(corridor_run(
        "ema-kernel-cohorts", init, meshes["rsu 2"]))
    out["corridor", "rsu 2", "counts"] = counts.take()
    out["corridor", "rsu 2 data 2"] = digest(corridor_run(
        "kernel", init, meshes["rsu 2 data 2"]))
    out["corridor", "rsu 2 data 2", "counts"] = counts.take()
    rsu = meshes["rsu 2"]
    out["refusals"] = {
        "flat": refusal(lambda: corridor_run("kernel", init, rsu,
                                             flat=True)),
        "bf16": refusal(lambda: corridor_run("kernel", init, rsu,
                                             ring_dtype="bf16")),
        "odd": refusal(lambda: corridor_run("kernel", init, rsu,
                                            n_rsus=3)),
        "rsu 4": refusal(lambda: corridor_run("kernel", init,
                                              meshes["rsu 4"])),
    }
    out.update(hierarchy(rank, world, leaves))
    return out


def hierarchy(rank, world, leaves):
    """``cross_pod_reconcile`` on a (2, 2) ``("pod", "data")`` mesh (the
    default shard spec) and a (4,) ``"pod"`` mesh, at tau 1 and 0.5, with
    and without ``use_kernel``; ``make_hierarchical_round`` at a step
    without and with its reconcile; the refusals.  ``leaves`` are the
    global arrays; rank i holds row block i of each (row-major over the
    mesh, as ``repro``'s ``P(("pod", "data"))`` tiles it)."""
    from repro_torch.core.hierarchical import (cross_pod_reconcile,
                                               make_hierarchical_round)
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                         make_production_mesh, mesh_axis)

    def shard(tree):
        return {k: torch.from_numpy(np.ascontiguousarray(
            np.split(v, world)[rank])) for k, v in tree.items()}

    local = shard(leaves)
    out = {}
    meshes = {"pod-data": (make_mesh((2, 2), ("pod", "data"), "cpu"), None),
              "pod": (make_mesh((4,), ("pod",), "cpu"), "pod")}
    for tag, (mesh, spec) in meshes.items():
        out[tag, "axes"] = {a: (ax.size, ax.index) for a in ("pod", "data")
                            if (ax := mesh_axis(mesh, a)) is not None}
        for tau in (1.0, 0.5):
            for use_kernel in (False, True):
                got = cross_pod_reconcile(local, mesh, shard_spec=spec,
                                          tau=tau, use_kernel=use_kernel)
                out[tag, tau, use_kernel] = numpy_tree(got)
    mesh = meshes["pod-data"][0]
    round_fn = make_hierarchical_round(mesh, beta=0.5, reconcile_every=2)
    upload = shard({k: v[::-1].copy() for k, v in leaves.items()})
    out["round", 0] = numpy_tree(round_fn(0, local, upload, 0.8))
    out["round", 1] = numpy_tree(round_fn(1, local, upload, 0.8))
    out["mesh refusals"] = {
        "production": refusal(lambda: make_production_mesh(device="cpu")),
        "multi-pod": refusal(lambda: make_production_mesh(multi_pod=True,
                                                          device="cpu")),
        "host": refusal(lambda: make_host_mesh("cpu")),
        "spec": refusal(lambda: cross_pod_reconcile(
            local, meshes["pod"][0], shard_spec=("pod", "data"))),
        "axis": refusal(lambda: cross_pod_reconcile(
            local, make_mesh((4,), ("data",), "cpu"), shard_spec="data")),
    }
    return out
