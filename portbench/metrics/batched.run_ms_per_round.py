"""The batched host engine's event loop (the program's ``run`` phase) in
milliseconds per merged round."""


def read(run):
    rounds = run.total("rounds")
    if not rounds or not all("run" in ep.phases for ep in run.episodes):
        return None
    return 1e3 * run.phase("run") / rounds
