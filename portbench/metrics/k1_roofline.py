"""K1 (``ring_agg``) with a world axis: the time its chains' bytes take at
the card's HBM bandwidth, over K1's own device time in the trace.  A chain
of U uploads over W worlds reads each upload row once and the globals once
and writes them once (``harness/yardstick.py``); the chains of a batch
cover each of its rounds once, so over the window the uploads are the
merged rounds and each launch adds its 2 W globals.  Percent; nothing when
K1 did not run."""
from portbench.harness import yardstick as Y


def read(run):
    t = run.trace and run.trace.kernel_seconds("ring_agg_kernel")
    launches = run.launches.get("ring_agg", 0)
    if not t or not launches:
        return None
    worlds = run.episodes[0].counts["worlds"]
    P = Y.cnn_param_count(run.cell.config)
    rows = run.total("rounds") + 2 * launches * worlds
    return 100.0 * rows * P * Y.F32 / Y.PEAK_HBM_BYTES_PER_S / t
