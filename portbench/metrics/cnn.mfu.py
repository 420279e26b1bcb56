"""Model FLOPs of the CNN's local training in the window, over the window
and the card's float32 peak: every merged round trained ``l_iters`` SGD
steps of one minibatch, each image 3 forward passes' worth of products
(``harness/yardstick.py``).  Evaluation is not counted.  Percent."""
from portbench.harness import yardstick as Y


def read(run):
    samples = run.total("samples")
    if not samples or run.window_s <= 0:
        return None
    flops = samples * Y.cnn_train_flops_per_sample(run.cell.config)
    return 100.0 * flops / run.window_s / Y.PEAK_FLOPS["float32"]
