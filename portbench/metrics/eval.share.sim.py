"""Share of the traced window spent evaluating global models
(``core/mafl.py:evaluate`` on the batched engine, nested in its ``run``;
the sweep tier's ``eval`` phase): the program's ``eval`` phase over the
window.  Percent."""


def read(run):
    if run.window_s <= 0 or \
            not all("eval" in ep.phases for ep in run.episodes):
        return None
    return 100.0 * run.phase("eval") / run.window_s
