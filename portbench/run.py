"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cell; its
configuration, traffic mix, entry, reference and per-layer readers are
files under ``portbench/`` found by name (``harness/spec.py``).  The last
line of standard output is the result's JSON; the numbers the comparison
held, each beside its limit, are the last lines of standard error.  With
no CUDA card the run prints no result and exits 2.
"""
from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (its start in ``/proc``), 0 where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(time.clock_gettime(time.CLOCK_BOOTTIME)
                   - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


STARTED = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; one host thread for the
    numeric libraries, so host work does not spread over the machine."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    torch.set_num_threads(1)
    from portbench.harness import spec
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness.cell import print_checks, run_cell
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), STARTED, ROOT)
    print_checks(out["checks"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
