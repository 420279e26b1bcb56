"""K3 (``cross_entropy``): the time its losses' logits (read once,
``harness/yardstick.py``) take at the card's HBM bandwidth, over K3's own
device time in the trace; the training steps' rows and the held-out
losses' rows both count.  Percent; nothing when K3 did not run."""
from portbench.harness import yardstick as Y


def read(run):
    t = run.trace and run.trace.kernel_seconds("cross_entropy_kernel")
    if not t:
        return None
    seq = run.cell.traffic["seq_len"]
    rows = (run.total("rows") + run.total("eval_rows")) * seq
    nbytes = Y.cross_entropy_bytes(rows, run.cell.config["vocab_size"])
    return 100.0 * nbytes / Y.PEAK_HBM_BYTES_PER_S / t
