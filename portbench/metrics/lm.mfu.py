"""Model FLOPs of the local SGD steps in the window (6 N per token over the
weights that multiply, plus causal attention; recomputation under the
checkpoints not counted), over the window and the card's float32 peak.
Held-out evaluation is not counted.  Percent."""
from portbench.harness import yardstick as Y


def read(run):
    steps = run.total("steps")
    if not steps or run.window_s <= 0:
        return None
    t = run.cell.traffic
    flops = steps * Y.lm_train_flops(run.cell.config, t["batch"],
                                     t["seq_len"])
    return 100.0 * flops / run.window_s / Y.PEAK_FLOPS["float32"]
