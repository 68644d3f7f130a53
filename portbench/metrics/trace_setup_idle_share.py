"""The device's idle time while the host is inside ``trace_path``'s set-up
(the program's ``raytracer.trace_setup`` span: the scene's host reads,
the path table, the draws checked), as a share of the traced window, in
percent.  Device trace and program span."""
from portbench.metrics import _spans


def read(run):
    return _spans.idle_share(run, "raytracer.trace_setup")
