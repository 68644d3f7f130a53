"""csrc/path_level.cu's share of its roofline, over a frame's launches:
the levels' f32 operations, or their bytes, over the launches' device
time a frame."""
from portbench import peaks
from portbench.metrics import _kernel


def read(run):
    return _kernel.share(run, "path_level_kernel", peaks.level_kernel_s)
