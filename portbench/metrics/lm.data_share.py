"""Share of the traced window spent making the LM loop's data
(``launch/train.py:run_training``: the vehicles' token shards and the
held-out rows, ``data/synthetic.py:synth_tokens``): the host time of the
program's ``data`` spans over the window.  Percent."""
from portbench.harness import spans


def read(run):
    return spans.share(run, "data")
