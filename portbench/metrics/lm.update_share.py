"""Share of the traced window spent issuing the local steps' SGD update
(``launch/train.py:run_training``: two elementwise ops on each of the
model's leaves a step): the host time of the program's ``step.update``
spans over the window.  Percent.

Host time under the traced run's profiler, which records each of the
update's ops, so it reads above what an untraced run spends there."""
from portbench.harness import spans


def read(run):
    return spans.share(run, "step.update")
