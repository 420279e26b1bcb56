"""Versioned JSONL structured run logs: ``repro.telemetry.runlog`` for the
port (DESIGN.md §14).

One :class:`~repro_torch.telemetry.report.RunReport` JSON object per line —
append-only, so a sweep (or a CI job) accumulates runs into one file that
``python -m repro_torch.telemetry report`` renders and ``... diff``
compares (``repro``'s CLI reads the same lines).
The schema tag rides in every line; readers reject lines they do not
understand instead of mis-parsing them.
"""
from __future__ import annotations

import json
from typing import Union

from repro_torch.telemetry.report import RunReport


def append(path: str, report: Union[RunReport, dict]) -> None:
    """Append one run to a JSONL log (creating it if needed)."""
    d = report.to_json() if isinstance(report, RunReport) else report
    with open(path, "a") as f:
        f.write(json.dumps(d, sort_keys=True) + "\n")


def load(path: str) -> list[dict]:
    """All runs in a JSONL log, as schema-checked dicts."""
    out = []
    with open(path) as f:
        for ln, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            RunReport.from_json(d)      # schema check only
            out.append(d)
    return out


def _fmt_seconds(s: float) -> str:
    return f"{s * 1e3:.1f} ms" if s < 1.0 else f"{s:.2f} s"


def _channel_summary(ch: dict) -> list[str]:
    import numpy as np
    lines = []
    if "stale_hist" in ch:
        h = np.asarray(ch["stale_hist"])
        lines.append(f"  staleness hist     {h.tolist()}")
    if "occupancy" in ch:
        o = np.asarray(ch["occupancy"])
        lines.append(f"  occupancy          mean {o.mean(0).tolist() if o.ndim > 1 else float(o.mean()):} "
                     f"max {int(o.max())}")
    if "gap" in ch:
        g = np.asarray(ch["gap"], float)
        lines.append(f"  pop wait           mean {g.mean():.4f} max {g.max():.4f}")
    if "handover_count" in ch:
        lines.append(f"  handovers per RSU  {list(ch['handover_count'])}")
    if "reward" in ch:
        rw = np.asarray(ch["reward"], float)
        lines.append(f"  reward trace       mean {rw.mean():.4f} last {rw[-1]:.4f}")
    if "ring_nonfinite" in ch:
        lines.append(f"  bf16 ring          nonfinite {ch['ring_nonfinite']} "
                     f"max|row| {float(ch.get('ring_max_abs', 0.0)):.3g}")
    return lines


def render(runs: list[dict]) -> str:
    """Human-readable multi-run summary of a loaded log."""
    out = []
    for k, d in enumerate(runs):
        head = (f"run {k}: engine={d.get('engine')} scheme={d.get('scheme')} "
                f"rounds={d.get('rounds')} seed={d.get('seed')}")
        if d.get("scenario"):
            head += f" scenario={d['scenario']}"
        head += f" metrics={'on' if d.get('metrics_on') else 'off'}"
        out.append(head)
        phases = d.get("phases") or {}
        if phases:
            out.append("  phases: " + "  ".join(
                f"{n}={_fmt_seconds(s)}" for n, s in sorted(phases.items())))
        mem = d.get("memory") or {}
        if "peak_rss_bytes" in mem:
            out.append(f"  peak rss: {mem['peak_rss_bytes'] / 2**30:.2f} GiB")
        if "device_peak_bytes_in_use" in mem:
            out.append("  device live_bytes peak: "
                       f"{mem['device_peak_bytes_in_use'] / 2**30:.2f} GiB")
        sel = d.get("selection")
        if sel:
            out.append(f"  selection: policy={sel.get('policy')} "
                       f"admitted={sel.get('n_admitted_final')}")
        waves = d.get("waves")
        if waves:
            out.append(f"  waves: {waves.get('n_waves')} "
                       f"(mean fill {waves.get('mean_fill'):.1f}, "
                       f"utilization {waves.get('utilization_vs_fleet'):.3f})")
        spec = d.get("spec")
        if spec:
            out.append(f"  staleness edges: {spec.get('edges')}")
        out.extend(_channel_summary(d.get("channels") or {}))
    return "\n".join(out)


def diff(a: dict, b: dict) -> str:
    """Compare two runs: identity fields, phase timings (with relative
    delta), and summary statistics of the shared channels."""
    import numpy as np
    out = []
    for f in ("engine", "scheme", "rounds", "seed", "scenario",
              "metrics_on"):
        va, vb = a.get(f), b.get(f)
        mark = "" if va == vb else "   <-- differs"
        out.append(f"{f:12} {va!r:>20} | {vb!r:<20}{mark}")
    pa, pb = a.get("phases") or {}, b.get("phases") or {}
    for n in sorted(set(pa) | set(pb)):
        sa, sb = pa.get(n), pb.get(n)
        if sa is not None and sb is not None and sa > 0:
            rel = f"  ({(sb - sa) / sa * 100.0:+.1f}%)"
        else:
            rel = ""
        out.append(f"phase {n:10} "
                   f"{_fmt_seconds(sa) if sa is not None else '-':>12} | "
                   f"{_fmt_seconds(sb) if sb is not None else '-':<12}{rel}")
    ca, cb = a.get("channels") or {}, b.get("channels") or {}
    for n in sorted(set(ca) & set(cb)):
        xa = np.asarray(ca[n], float).ravel()
        xb = np.asarray(cb[n], float).ravel()
        if xa.shape == xb.shape and np.array_equal(xa, xb):
            out.append(f"channel {n:18} identical")
        elif xa.shape == xb.shape:
            out.append(f"channel {n:18} max|Δ| "
                       f"{float(np.max(np.abs(xa - xb))):.4g}")
        else:
            out.append(f"channel {n:18} shape {xa.shape} | {xb.shape}")
    return "\n".join(out)
