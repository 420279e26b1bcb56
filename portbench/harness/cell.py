"""One run of one cell: set-up, the measured window, the readings, the
comparison with the plain reference, and the result's line.

The window runs whole episodes of the cell's entry back to back until
``seconds`` have passed; it ends with the last episode, whose end the
harness waits for on the card.  Every end-to-end rate is the work of all
those episodes over all of the window's time.  Set-up (``setup_s``) runs
from the process's start to the window's: imports, the card, the kernels
(built on a checkout's first run, loaded after), the inputs made from the
seed and one warm-up episode of the cell's own shapes.  With ``trace`` the
same window runs under ``torch.profiler`` and the per-layer readers read
it; without, they are not run.

Once the window has closed and the device's peak memory is read, the
program's state is dropped and the plain reference re-runs what the
compared episodes ran; each number compared is printed beside its limit.
A run that has loaded JAX or the JAX package by then, in the program, a
metric reader or the reference, ends with no result.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from portbench.harness import guard, spec
from portbench.harness import trace as trace_mod
from portbench.harness.record import Run


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ent, st, seconds: float, device):
    """Episodes back to back until ``seconds`` have passed; returns them
    and the window's length in seconds."""
    episodes = []
    _sync(device)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.episode"):
            ep = ent.episode(st, len(episodes))
        _sync(device)
        ep.wall = time.perf_counter() - t
        episodes.append(ep)
        if time.perf_counter() - t0 >= seconds:
            break
    return episodes, time.perf_counter() - t0


def _launches():
    from repro_torch import kernels
    return kernels.launch_counts()


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             started: float, root=spec.ROOT) -> dict:
    """Run cell ``name`` once; ``started`` is the process's start on the
    ``time.perf_counter`` clock.  Returns the result's line as a dict."""
    cell = spec.load_cell(name, root)
    ent = spec.entry(cell, root)
    ref = spec.reference(cell, root)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    st = ent.setup(cell, seed, device, ref)
    _sync(device)
    setup_s = time.perf_counter() - started

    before = _launches()
    prof = _profiler(device) if trace else None
    if prof is not None:
        prof.start()
    episodes, window_s = window(ent, st, seconds, device)
    if prof is not None:
        prof.stop()
    after = _launches()
    run = Run(cell=cell, episodes=episodes, window_s=window_s,
              launches={k: after[k] - before[k] for k in after},
              trace=trace_mod.read(prof) if prof is not None else None)
    del prof
    n_episodes = len(episodes)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], root).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = window_s
        breakdown = run.trace.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {
                    "value": run.total(ent.RATES[m["name"]]) / window_s,
                    "unit": m["unit"]}

    walls = sorted(ep.wall for ep in episodes)
    print(f"portbench: {len(walls)} episodes in {window_s:.3f} s, each "
          f"{walls[0]:.3f} / {walls[len(walls) // 2]:.3f} / {walls[-1]:.3f} "
          f"s (least / median / most); set-up {setup_s:.3f} s",
          file=sys.stderr)
    kept = ent.select(st, episodes, seed)
    del st, episodes, run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    per_item = ent.check(cell, kept, ref, device)
    limits = cell.traffic["limits"]
    n_failed = sum(bool(over(n, limits)) for n in per_item)
    out = {"correct": bool(per_item) and n_failed == 0,
           "attempted": n_episodes, "failed": n_failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = checks_of(worst(per_item), limits)
    # last, once the metric readers and the reference have run too
    found = guard.forbidden_modules()
    if found:
        raise SystemExit("portbench: the run loaded " + ", ".join(found))
    return out


def worst(per_item: list) -> dict:
    """Each number's largest value over the compared items; a NaN wins."""
    out: dict = {}
    for n in per_item:
        for k, v in n.items():
            prev = out.get(k)
            if prev is None or math.isnan(v) or \
                    (not math.isnan(prev) and v > prev):
                out[k] = v
    return out


def over(numbers: dict, limits: dict) -> list:
    """Names of the numbers above their limits; a number that is missing,
    has no limit or is not finite counts as above."""
    bad = [k for k in limits if k not in numbers]
    for k, v in numbers.items():
        lim = limits.get(k)
        if lim is None or not math.isfinite(v) or v > lim:
            bad.append(k)
    return bad


def checks_of(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": number, "limit": limit}}`` in the limits' order."""
    names = list(limits) + [k for k in numbers if k not in limits]
    return {k: {"value": numbers.get(k), "limit": limits.get(k)}
            for k in names}


def print_checks(checks: dict) -> None:
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
