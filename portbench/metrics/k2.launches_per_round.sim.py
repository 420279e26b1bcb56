"""K2 launches (``kernels.launch_counts()``) per merged round."""


def read(run):
    merges = run.total("merges")
    if not merges:
        return None
    return run.launches.get("weighted_agg", 0) / merges
