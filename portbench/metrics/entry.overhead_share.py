"""Share of each call of the entry outside the engine's event loop (world
building, planning, staging, evaluation): the harness's clock around the
calls, less the program's ``run`` phase (``telemetry/timers.py``), over
the harness's clock.  Percent."""


def read(run):
    wall = sum(ep.wall for ep in run.episodes)
    if wall <= 0 or not all("run" in ep.phases for ep in run.episodes):
        return None
    return 100.0 * (wall - run.phase("run")) / wall
