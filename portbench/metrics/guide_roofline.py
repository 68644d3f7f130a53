"""The guide's share of its roofline: its f32 flops on the rows it
steered (the reference's fb_used) at the f32 peak, over its time a
frame."""
from portbench import peaks
from portbench.metrics import guide_ms_per_frame


def read(run):
    ms = guide_ms_per_frame.read(run)
    if ms is None or run.work is None:
        return None
    return 100.0 * peaks.guide_s(run) / (ms * 1e-3)
