"""The sweep tier's event loop (the program's ``run`` phase of a batch) in
milliseconds per batch round; one batch round merges one upload into
every world of the grid."""


def read(run):
    rounds = run.total("batch_rounds")
    if not rounds or not all("run" in ep.phases for ep in run.episodes):
        return None
    return 1e3 * run.phase("run") / rounds
