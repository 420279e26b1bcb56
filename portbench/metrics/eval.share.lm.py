"""Share of the traced window spent on the LM loop's held-out loss
(``launch/train.py:run_training``, every fifth round and the last): the
host time of the program's ``eval`` spans over the window, which holds the
wait for the loss on the card.  Percent."""
from portbench.harness import spans


def read(run):
    return spans.share(run, "eval")
