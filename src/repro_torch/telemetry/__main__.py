"""CLI for structured run logs: ``python -m repro_torch.telemetry <cmd>``,
``repro``'s ``python -m repro.telemetry`` for the port.

- ``report LOG``      render every run in a JSONL log
- ``diff A B``        compare two runs (last line of each log by default);
                      either log may come from ``repro``
- ``run SCENARIO``    run a registered scenario with ``metrics=on`` and
                      append its RunReport to a JSONL log; ``--device cpu``
                      runs it on the host (the default is the card)
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.telemetry import runlog


def _cmd_report(args) -> int:
    runs = runlog.load(args.log)
    if not runs:
        print(f"{args.log}: no runs")
        return 1
    if args.index is not None:
        runs = [runs[args.index]]
    print(runlog.render(runs))
    return 0


def _cmd_diff(args) -> int:
    a = runlog.load(args.log_a)[args.index_a]
    b = runlog.load(args.log_b)[args.index_b]
    print(runlog.diff(a, b))
    return 0


def _cmd_run(args) -> int:
    from repro_torch.core.scenarios import run_scenario

    result = run_scenario(args.scenario, seed=args.seed, engine=args.engine,
                          eval_every=args.eval_every, metrics=args.metrics,
                          device=args.device)
    runlog.append(args.out, result.report)
    acc = result.acc_history[-1][1] if result.acc_history else float("nan")
    print(f"{args.scenario} [{args.engine or 'auto'}] metrics={args.metrics}"
          f" final acc {acc:.4f} -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="render a JSONL run log")
    rp.add_argument("log")
    rp.add_argument("--index", type=int, default=None,
                    help="render only run N (negative indexes from the end)")
    rp.set_defaults(fn=_cmd_report)

    dp = sub.add_parser("diff", help="compare two runs")
    dp.add_argument("log_a")
    dp.add_argument("log_b")
    dp.add_argument("--index-a", type=int, default=-1)
    dp.add_argument("--index-b", type=int, default=-1)
    dp.set_defaults(fn=_cmd_diff)

    rn = sub.add_parser("run", help="run a scenario and log its report")
    rn.add_argument("scenario")
    rn.add_argument("--engine", default=None)
    rn.add_argument("--seed", type=int, default=0)
    rn.add_argument("--eval-every", type=int, default=10)
    rn.add_argument("--metrics", default="on", choices=("on", "off"))
    rn.add_argument("--device", default=None,
                    help="'cpu' runs on the host (default: the card)")
    rn.add_argument("--out", default="telemetry.jsonl")
    rn.set_defaults(fn=_cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
