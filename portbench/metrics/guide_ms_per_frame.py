"""The guide's milliseconds a frame: CUDA events around each guide call
(the harness wraps the guide it passes), summed over a frame, the mean
over the traced run's frames.  Device clock."""


def read(run):
    if not run.guide_ms:
        return None
    return sum(run.guide_ms) / len(run.guide_ms)
