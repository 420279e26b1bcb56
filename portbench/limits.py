"""Readings that a cell's limits are set from, on the card.

    python3 portbench/limits.py --workload <name> --seeds 1 2 3 --control
    python3 portbench/limits.py --workload <name> --seeds 1 2 3 \
        --fault half_batch
    python3 portbench/limits.py --workload <name> --seeds 1 2 3 --sound

For each seed, prints one JSON line with the numbers of the cell's
comparison for:

- ``--control``: the entry's ``control``, the plain reference in the
  nearest precision below the configuration's (TF32 for float32) put in
  the program's place against the reference in float32, on the world or
  episode the window's first episode runs;
- ``--fault <name>``: the program with a fault of ``harness/faults.py``
  planted, set up and run for as many episodes as a run's comparison
  draws from (the mix's ``compare.episodes``, else one), compared as a
  run's window would be, against the reference;
- ``--sound``: the same with no fault, for the sound readings of many
  seeds in one process (``run.py``'s result lines give them too, under
  ``checks``).

Each limit lies between the largest sound reading over a dozen seeds or
more and the smallest control (or fault) reading; ``PERF.md`` gives both.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    how = ap.add_mutually_exclusive_group(required=True)
    how.add_argument("--control", action="store_true")
    how.add_argument("--fault")
    how.add_argument("--sound", action="store_true")
    ap.add_argument("--sets", type=int, default=1,
                    help="with --fault or --sound: comparisons one set-up "
                    "makes, each over episodes of its own (entries whose "
                    "every episode keeps its output: scenario, sweep)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import faults, spec
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload, ROOT)
    ent, ref = spec.entry(cell, ROOT), spec.reference(cell, ROOT)
    if args.fault:
        faults.plant(cell.traffic["entry"], args.fault)
    label = args.fault or ("sound" if args.sound else "control")
    for seed in args.seeds:
        if args.control:
            numbers = ent.control(cell, seed, device, ref)
        else:
            st = ent.setup(cell, seed, device, ref)
            m = cell.traffic.get("compare", {}).get("episodes", 1)
            for i in range(args.sets):
                eps = [ent.episode(st, i * m + k) for k in range(m)]
                kept = ent.select(st, eps, seed + i)
                torch.cuda.empty_cache()
                numbers = ent.check(cell, kept, ref, device)
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "set": i, label: numbers}),
                      flush=True)
            del st
            torch.cuda.empty_cache()
            continue
        print(json.dumps({"workload": args.workload, "seed": seed,
                          label: numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
