"""K2 (``weighted_agg``) in the CNN worlds: the time its merges' bytes
(global and local read, global written, ``harness/yardstick.py``) take at
the card's HBM bandwidth, over K2's own device time in the trace.
Percent; nothing when K2 did not run."""
from portbench.harness import yardstick as Y


def read(run):
    t = run.trace and run.trace.kernel_seconds("weighted_agg_kernel")
    merges = run.total("merges")
    if not t or not merges:
        return None
    nbytes = merges * Y.weighted_agg_bytes(Y.cnn_param_count(run.cell.config))
    return 100.0 * nbytes / Y.PEAK_HBM_BYTES_PER_S / t
