"""The scene's tensors read to the host a frame (the program's
``host_reads`` counter over the traced frames; each read waits for the
card).  Program counter."""
from portbench.metrics import _spans


def read(run):
    return _spans.per_frame(run, "host_reads")
