"""Camera samples (W x H x spp) of every frame of the window over the
window's whole time, its start to its last frame's end.  Host clock."""
from portbench import stats


def read(run):
    if not run.frames:
        return None
    return stats.rate(len(run.frames) * run.samples_per_frame, run.frames,
                      run.window_start)
