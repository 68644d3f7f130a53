"""The frame's least time on the card's published peaks
(``peaks.frame_s``: the f32 operations the reference's trace needs, the
guide's flops on the rows it steered) over the traced frame time, in
percent.  Device trace, work from the reference."""
from portbench import peaks


def read(run):
    if run.trace is None or run.work is None:
        return None
    return 100.0 * peaks.frame_s(run) / run.trace.frame_s
