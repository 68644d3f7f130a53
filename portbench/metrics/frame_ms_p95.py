"""The 95th percentile over every frame of the window, each from the start
of its draws to its image and counters on the host.  Host clock."""
from portbench import stats


def read(run):
    if not run.frames:
        return None
    return 1e3 * stats.percentile([e - s for s, e in run.frames], 95)
