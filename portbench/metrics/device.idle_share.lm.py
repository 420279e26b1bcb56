"""Share of the traced window in which nothing ran on the card: the window
less the union of the device's kernels, copies and sets in the profiler's
trace, over the window.  Percent."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
