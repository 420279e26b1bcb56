"""Share of the traced window spent building worlds (``core/scenarios.py:
build_world``: synthetic data, partition, channel): the program's ``world``
phase (``run_scenario`` around its build, the sweep tier around its
batch's builds) over the window.  Percent; nothing where the program has
no such phase."""


def read(run):
    if run.window_s <= 0 or \
            not all("world" in ep.phases for ep in run.episodes):
        return None
    return 100.0 * run.phase("world") / run.window_s
