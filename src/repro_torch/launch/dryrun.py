"""Dry run of the (arch x shape x mesh) matrix, the counterpart of
``repro.launch.dryrun``: each step at full size on a fake process group of
256 (or 512) ranks, with ``meta`` tensors, nothing allocated and nothing
computed.

For each (arch, shape, mesh) it starts a ``"fake"`` process group, builds
``launch/mesh.py:make_production_mesh`` on it, builds the model on
``meta`` (no init draws), lays its parameters out by
``sharding.param_specs`` as DTensors, and runs the train, prefill or
serve step (and, with ``--mafl-agg``, the MAFL aggregation) under
``roofline.dispatch_count``'s counter, which reads one device's matmul
FLOPs, collective bytes and memory from the ops the step dispatches.  The
record carries ``repro``'s keys for the H100 (``roofline.analysis.H100``:
the data sheet's peaks, so the terms are predictions), with
``trace_seconds`` (the host time of the counted run) in place of
``compile_seconds`` and ``while_trips``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k

writes ``dryrun/dryrun_<arch>_<shape>_<mesh>.json`` under the repository
root (``--out`` to change it).  A failing (arch, shape) prints its error
and traceback, writes no record, and is listed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape, legal_shapes, list_archs
from repro_torch.configs.shapes import DECODE, PREFILL, TRAIN
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.roofline.analysis import (H100, model_flops_estimate,
                                           roofline_terms)
from repro_torch.roofline.dispatch_count import count_step
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.specs import (batch_spec, cache_specs, mesh_sizes,
                                        needs_fsdp, param_specs, placements)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun"

# Production memory knobs per arch for the TRAIN shape: grad-accumulation
# splits + activation sharding (``repro``'s DESIGN.md §5), as ``repro``'s.
TRAIN_OVERRIDES = {
    "llama3-405b": dict(microbatches=4, shard_activations=True,
                        grad_accum_dtype="bfloat16"),
    "llama4-scout-17b-a16e": dict(microbatches=16, remat_sublayer=True,
                                  shard_activations=True,
                                  grad_accum_dtype="bfloat16"),
    "jamba-v0.1-52b": dict(microbatches=16, shard_activations=True,
                           grad_accum_dtype="bfloat16", remat_sublayer=True),
    "mistral-nemo-12b": dict(microbatches=8, shard_activations=True),
    "deepseek-v2-lite-16b": dict(microbatches=16, remat_sublayer=True,
                                 shard_activations=True),
    "qwen1.5-4b": dict(microbatches=8, shard_activations=True),
    "musicgen-large": dict(microbatches=4, shard_activations=True),
    "internvl2-2b": dict(microbatches=4, shard_activations=True),
    "rwkv6-1.6b": dict(microbatches=2),
    "smollm-360m": dict(microbatches=2),
}


def arch_for(arch: str, shape_name: str):
    """Arch config, applying long-context and train-memory variants."""
    if arch == "mistral-nemo-12b" and shape_name == "long_500k":
        from repro_torch.configs.mistral_nemo_12b import \
            sliding_window_variant
        cfg = sliding_window_variant()
    else:
        cfg = get_config(arch)
    if shape_name == "train_4k" and arch in TRAIN_OVERRIDES:
        cfg = cfg.variant(**TRAIN_OVERRIDES[arch])
    if cfg.vocab_size % 256:
        # pad the vocab to a shardable multiple (standard production
        # practice; the model card's tokenizer ids are unaffected) so the
        # embedding/lm_head shard over the 16-way model axis.
        cfg = cfg.variant(vocab_size=-(-cfg.vocab_size // 256) * 256)
    return cfg


def start_fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks in this process (rank
    0): collectives return at once, their shapes right."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _meta_model(cfg, mesh, specs):
    model = T.Transformer(cfg, torch.bfloat16, "meta")
    return dt.shard_module(model, mesh, specs)


def _batch(cfg, shape, mesh, kind):
    """The step's token batch (``repro``'s ``input_specs``) on ``meta``,
    its batch over ``batch_spec``."""
    B, S = shape.global_batch, shape.seq_len
    P = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    bspec = batch_spec(mesh, B)
    n = S - P + 1 if kind == TRAIN else S - P
    tokens = dt.shard(mesh, torch.empty((B, n), dtype=torch.int32,
                                        device="meta"),
                      placements(mesh, bspec + (None,)))
    batch = {"tokens": tokens}
    if P:
        batch["patch_embeds"] = dt.shard(
            mesh, torch.empty((B, P, cfg.d_model), dtype=torch.bfloat16,
                              device="meta"),
            placements(mesh, bspec + (None, None)))
    return batch


def _record(cfg, shape_name, kind, mesh, mesh_name, stats, memory, seconds,
            model_flops, tokens):
    n_chips = mesh.size()
    terms = roofline_terms(
        arch=cfg.name, shape=shape_name, mesh_name=mesh_name,
        n_chips=n_chips, stats=stats, memory_stats=memory, cost_flops=0.0,
        model_flops=model_flops, tokens=tokens)
    rec = terms.to_dict()
    rec.update(
        n_chips=n_chips, hardware=H100.name,
        param_count=T.param_count(cfg),
        param_count_active=T.param_count(cfg, active_only=True),
        argument_bytes=memory.argument_size_in_bytes,
        output_bytes=memory.output_size_in_bytes,
        temp_bytes=memory.temp_size_in_bytes,
        alias_bytes=memory.alias_size_in_bytes,
        collective_counts=dict(stats.collective_counts),
        trace_seconds=round(seconds, 1))
    return rec


def lower_one(cfg, shape, mesh, mesh_name: str, extra_opts=None):
    """Count one (arch, shape, mesh) and return the record dict.

    The stack's periods are identical, and so are a train step's
    microbatches, so every count of a step (FLOPs, collective bytes and
    calls, argument, output and temporary bytes) is affine in the number
    of periods and in the number of microbatches: the step is run at 1
    and 2 periods (and, past 4 microbatches, at 2 and 4 of them, each of
    the real microbatch's rows) and the counts carried to the whole
    (``repro`` multiplies its scan bodies by their while loops' trip
    counts the same way).  ``"exact"`` in ``extra_opts`` runs the whole
    step instead."""
    opts = dict(extra_opts or {})
    if opts.get("fsdp") is None:    # the whole model's rule, not a cut's
        opts["fsdp"] = needs_fsdp(cfg, mesh_sizes(mesh).get("model", 1))
    n, M = cfg.n_periods, cfg.microbatches
    ps = [n] if opts.get("exact") or n <= 2 else [1, 2]
    ms = ([M] if opts.get("exact") or shape.kind != TRAIN or M <= 4
          else [2, 4])
    runs = {(p, m): _counted(
        cfg.variant(n_layers=cfg.first_k_dense + p * cfg.scan_period,
                    microbatches=m),
        dataclasses.replace(shape, global_batch=shape.global_batch // M * m),
        mesh, opts) for p in ps for m in ms}
    stats, memory = (_bilinear({k: r[i] for k, r in runs.items()}, n, M)
                     for i in (0, 1))
    rec = _record(cfg, shape.name, shape.kind, mesh, mesh_name, stats,
                  memory, sum(r[2] for r in runs.values()),
                  model_flops_estimate(cfg, shape), shape.tokens)
    rec.update(n_periods=n, periods_counted=ps, microbatches_counted=ms)
    return rec


def _bilinear(points: dict, n: int, M: int):
    """Counts at (periods, microbatches) ``points`` (one, two or four of
    them) carried to (``n``, ``M``), field by field (dicts of numbers by
    key): affine in each, through the points counted.  The temporaries'
    peak is one microbatch's, not a sum over them: it is carried over the
    periods only, from the most microbatches counted, and never below the
    deepest count (a peak that falls with depth, as where a prefill's
    caches are outputs, stays at that count)."""
    from dataclasses import fields, replace
    ps = sorted({p for p, _ in points})
    ms = sorted({m for _, m in points})
    tp = (n - ps[0]) / (ps[-1] - ps[0]) if len(ps) > 1 else 0
    tm = (M - ms[0]) / (ms[-1] - ms[0]) if len(ms) > 1 else 0
    f00, f10 = points[ps[0], ms[0]], points[ps[-1], ms[0]]
    f01, f11 = points[ps[0], ms[-1]], points[ps[-1], ms[-1]]

    def carry(a, b, c, d, tm=tm):
        if isinstance(a, dict):
            return {k: carry(a[k], b[k], c[k], d[k], tm) for k in a}
        v = a + tp * (b - a) + tm * (c - a) + tp * tm * (d - b - c + a)
        return type(a)(round(v)) if isinstance(a, int) else v
    out = {f.name: carry(*(getattr(x, f.name) for x in (f00, f10, f01, f11)))
           for f in fields(f00) if f.name != "ops"}
    if "temp_size_in_bytes" in out:
        out["temp_size_in_bytes"] = max(carry(
            f01.temp_size_in_bytes, f11.temp_size_in_bytes, 0, 0, tm=0),
            f11.temp_size_in_bytes)
    return replace(f00, **out)


def _counted(cfg, shape, mesh, opts):
    """``(stats, memory, seconds)`` of one step of ``cfg`` under the
    counter."""
    specs = param_specs(cfg, mesh, fsdp=opts.get("fsdp"))
    if opts.get("dp_over_model"):
        specs = {k: (None,) * len(s) for k, s in specs.items()}
    model = _meta_model(cfg, mesh, specs)
    params = T.param_dict(model)
    B, S = shape.global_batch, shape.seq_len
    if opts.get("dp_over_model"):
        bspec = (tuple(mesh.mesh_dim_names),)
    else:
        bspec = batch_spec(mesh, B)
    if shape.kind in (TRAIN, PREFILL):
        batch = _batch(cfg, shape, mesh, shape.kind)
        batch["tokens"] = batch["tokens"].redistribute(
            placements=placements(mesh, bspec + (None,)))
    if shape.kind == TRAIN:
        gspecs = None if opts.get("no_grad_specs") else specs
        step = steps_mod.make_train_step(cfg, grad_specs=gspecs)
        _, stats, memory, secs = count_step(step, model, params, batch)
    elif shape.kind == PREFILL:
        step = steps_mod.make_prefill_step(cfg)
        _, stats, memory, secs = count_step(step, model, batch,
                                            weights=params)
    else:
        assert shape.kind == DECODE
        step = steps_mod.make_serve_step(cfg)
        cache = dt.shard_tree(
            mesh, T.init_cache(cfg, B, S, torch.bfloat16, "meta"),
            cache_specs(cfg, mesh, B, S))
        token = dt.shard(mesh, torch.empty((B, 1), dtype=torch.int32,
                                           device="meta"),
                         placements(mesh, bspec + (None,)))
        _, stats, memory, secs = count_step(
            lambda m, t, c: step(m, t, c, S - 1), model, token, cache,
            weights=params, in_place=cache)
    return stats, memory, secs


def mafl_agg_record(cfg, mesh, mesh_name: str):
    """The RSU aggregation (Eq. 10+11) over the whole sharded parameter
    dict: the paper's technique as its own step."""
    specs = param_specs(cfg, mesh)
    g = T.param_dict(_meta_model(cfg, mesh, specs))
    loc = T.param_dict(_meta_model(cfg, mesh, specs))
    step = steps_mod.make_mafl_step(cfg)
    _, stats, memory, secs = count_step(lambda a, b: step(a, b, 0.5, 0.9),
                                        g, loc)
    return _record(cfg, "mafl_agg", "agg", mesh, mesh_name, stats, memory,
                   secs, 3.0 * T.param_count(cfg), 0)


def _overrides(text: str) -> dict:
    kw = {}
    for kv in text.split(","):
        k, v = kv.split("=")
        kw[k] = {"True": True, "False": False}.get(
            v, int(v) if v.isdigit() else v)
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-pod dry-run matrix")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--mafl-agg", action="store_true",
                    help="also run the MAFL aggregation step per arch")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fsdp", default=None,
                    help="override FSDP auto-rule: on|off")
    ap.add_argument("--override", default="",
                    help="cfg variant overrides, e.g. "
                         "'microbatches=8,mla_absorb=True'")
    ap.add_argument("--tag", default="",
                    help="suffix for the output record filename")
    ap.add_argument("--no-grad-specs", action="store_true",
                    help="disable the grad reduce-scatter constraint")
    ap.add_argument("--dp-over-model", action="store_true",
                    help="shard the batch over BOTH mesh axes (pure data "
                         "parallel; params replicated)")
    ap.add_argument("--exact", action="store_true",
                    help="count every period rather than carrying the "
                         "counts of 1 and 2 periods to the whole depth")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    fsdp = {None: None, "on": True, "off": False}[args.fsdp]
    failed = []
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        start_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        for arch in archs:
            base_cfg = get_config(arch)
            shapes = (legal_shapes(base_cfg) if args.shape == "all"
                      else args.shape.split(","))
            if arch == "mistral-nemo-12b" and args.shape == "all":
                shapes = shapes + ["long_500k"]   # via the SWA variant
            for shape_name in shapes:
                tag = f"_{args.tag}" if args.tag else ""
                out_path = os.path.join(
                    args.out,
                    f"dryrun_{arch}_{shape_name}_{mesh_name}{tag}.json")
                if os.path.exists(out_path) and not args.force:
                    print(f"skip {out_path} (exists)")
                    continue
                cfg = arch_for(arch, shape_name)
                if args.override:
                    cfg = cfg.variant(**_overrides(args.override))
                shape = get_shape(shape_name)
                print(f"[{mesh_name}] {arch} x {shape_name} ...", flush=True)
                try:
                    rec = lower_one(cfg, shape, mesh, mesh_name,
                                    {"fsdp": fsdp,
                                     "dp_over_model": args.dp_over_model,
                                     "no_grad_specs": args.no_grad_specs,
                                     "exact": args.exact})
                    with open(out_path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"  ok: flops/dev={rec['flops_per_device']:.3e} "
                          f"coll={rec['collective_bytes_per_device']:.3e} "
                          f"bottleneck={rec['bottleneck']} "
                          f"fits={rec['fits_hbm']} "
                          f"({rec['trace_seconds']}s)", flush=True)
                except Exception as e:
                    failed.append(f"{mesh_name} {arch} {shape_name}")
                    print(f"  FAIL: {e}")
                    traceback.print_exc()
            if args.mafl_agg:
                out_path = os.path.join(
                    args.out, f"dryrun_{arch}_mafl-agg_{mesh_name}.json")
                if os.path.exists(out_path) and not args.force:
                    continue
                try:
                    rec = mafl_agg_record(get_config(arch), mesh, mesh_name)
                    with open(out_path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"  mafl-agg ok ({rec['trace_seconds']}s)",
                          flush=True)
                except Exception as e:
                    failed.append(f"{mesh_name} {arch} mafl-agg")
                    print(f"  mafl-agg FAIL: {e}")
                    traceback.print_exc()
        dist.destroy_process_group()
    print(f"failed: {failed}" if failed else "failed: none", flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"dry run took {time.perf_counter() - t0:.1f} s")
