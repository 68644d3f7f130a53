"""csrc/path_trace.cu's share of its roofline: the levels' f32
operations, or its bytes, over its device time a frame."""
from portbench import peaks
from portbench.metrics import _kernel


def read(run):
    return _kernel.share(run, "path_trace_kernel", peaks.path_kernel_s)
