"""The batched host engine's training waves (``core/mafl.py``: minibatch
draws, the stacking and copies of ``local_update_many``, the vmapped
steps' issue, the losses read back) in milliseconds per merged round: the
program's ``wave`` phase, which lies inside ``run``, over the window's
rounds.  Nothing where the program has no such phase."""


def read(run):
    rounds = run.total("rounds")
    if not rounds or not all("wave" in ep.phases for ep in run.episodes):
        return None
    return 1e3 * run.phase("wave") / rounds
