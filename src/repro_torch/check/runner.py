"""Orchestration for ``python -m repro_torch.check``: collect files, run the
analyzers, apply waivers, render text or JSON.  The port's copy of
``repro.check.runner``: the same JSON keys and exit codes."""
from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.check import config
from repro_torch.check.findings import RULES, Finding, apply_waivers

DEFAULT_PATHS = ["src/repro_torch"]


def collect_files(paths: list[str]) -> list[Path]:
    files: list[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            files.extend(f for f in sorted(p.rglob("*.py"))
                         if not config.is_excluded(f.as_posix()))
        elif p.suffix == ".py" and not config.is_excluded(p.as_posix()):
            files.append(p)
    return files


def run_checks(paths: list[str], *, probes: bool = True):
    """Returns ``(findings, reports, timings)``: waiver-applied findings,
    the kernel race reports, and per-analyzer wall times.  An analyzer that
    raises propagates: the CLI then exits non-zero."""
    from repro_torch.check import boundary, grid_race

    files = collect_files(paths)
    findings: list[Finding] = []
    timings: dict[str, float] = {}

    t0 = time.perf_counter()
    for f in files:
        findings.extend(boundary.check_file(f))
    timings["boundary"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reports, race_findings = grid_race.scan(files)
    findings.extend(race_findings)
    timings["grid_race"] = time.perf_counter() - t0

    if probes:
        from repro_torch.check import (dtype_flow, plan_shapes,
                                       telemetry_off)

        t0 = time.perf_counter()
        findings.extend(plan_shapes.probe_plan_shapes())
        timings["plan_shapes"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        findings.extend(dtype_flow.probe_dtype_flow())
        timings["dtype_flow"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        findings.extend(telemetry_off.probe_telemetry_off())
        timings["telemetry_off"] = time.perf_counter() - t0

    sources = {f.as_posix(): f.read_text() for f in files}
    findings = apply_waivers(findings, sources)
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings, reports, timings


def render_text(findings, reports, timings, *, strict: bool) -> str:
    lines = []
    for rep in reports:
        legal = ",".join(b for b, ok in sorted(rep.compiled_legal.items())
                         if ok) or "none"
        lines.append(f"kernel {rep.kernel_id}: {rep.classification} "
                     f"(grid {rep.grid}, compiled on: {legal})")
    for f in findings:
        lines.append(f.format())
    live = sum(1 for f in findings if not f.waived)
    waived = sum(1 for f in findings if f.waived)
    t = " ".join(f"{k}={v:.2f}s" for k, v in timings.items())
    lines.append(f"{live} finding(s), {waived} waived  [{t}]")
    if strict and live:
        lines.append("FAIL (strict): unwaived findings")
    return "\n".join(lines)


def render_json(findings, reports, timings) -> str:
    return json.dumps({
        "kernels": [r.to_json() for r in reports],
        "findings": [f.to_json() for f in findings],
        "timings_s": {k: round(v, 3) for k, v in timings.items()},
    }, indent=2)


def list_rules() -> str:
    lines = []
    for rule in RULES.values():
        lines.append(f"{rule.id}  {rule.slug}  [{rule.analyzer}]")
        lines.append(f"      {rule.rationale}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static invariant analyzers of the PyTorch/CUDA port: "
                    "CUDA grid races, host/device boundary lint, dtype "
                    "flow, plan shapes, the telemetry off path.")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any unwaived finding remains")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the run probes (dtype flow, plan shapes, "
                         "telemetry off): AST and race analysis only")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(list_rules())
        return 0

    findings, reports, timings = run_checks(
        args.paths or DEFAULT_PATHS, probes=not args.no_probes)
    if args.format == "json":
        print(render_json(findings, reports, timings))
    else:
        print(render_text(findings, reports, timings, strict=args.strict))
    live = sum(1 for f in findings if not f.waived)
    return 1 if (args.strict and live) else 0
