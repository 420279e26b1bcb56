"""K2's wrapper (``kernels/weighted_agg/ops.py:weighted_agg_tree``: the
checks, the plan, the output views, the pointer arrays and the launch) in
the CNN worlds, in microseconds of host time per merge: the program's
``k2`` spans over the window's merges.

The spans run only under the traced run's profiler, which records every
op the wrapper makes, so this is host time under the profiler: much of it
the profiler's cost per op, growing with the window's length.  Compare it
only between runs of the same window; the untraced rate is the end-to-end
yardstick."""
from portbench.harness import spans


def read(run):
    return spans.per(run, "k2", "merges", 1e6)
