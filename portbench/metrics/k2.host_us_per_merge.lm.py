"""K2's wrapper (``kernels/weighted_agg/ops.py:weighted_agg_tree``) on the
LM's merges of every leaf, in microseconds of host time per merge: the
program's ``k2`` spans over the window's merges.

Host time under the traced run's profiler, which records every op the
wrapper makes (a view for each of the 290 leaves): much of it the
profiler's cost per op, growing with the window's length.  Compare it only
between runs of the same window; the untraced rate is the end-to-end
yardstick."""
from portbench.harness import spans


def read(run):
    return spans.per(run, "k2", "merges", 1e6)
