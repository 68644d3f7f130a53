"""csrc/path_guided.cu's share of its roofline (the student on the tensor
cores): the levels' f32 operations and the student's bf16 flops on the
guided rows, or its bytes, over its device time a frame."""
from portbench import peaks
from portbench.metrics import _kernel


def read(run):
    return _kernel.share(run, "path_guided_kernel", peaks.path_kernel_s)
