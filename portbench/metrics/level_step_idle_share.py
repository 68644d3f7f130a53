"""The device's idle time while the host is inside a level's step (the
program's ``raytracer.level_step`` span: the level kernel's launch, or the
stepwise level's sweep and tensor ops), as a share of the traced window,
in percent.  Device trace and program span."""
from portbench.metrics import _spans


def read(run):
    return _spans.idle_share(run, "raytracer.level_step")
