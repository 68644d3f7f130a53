"""The share of the rows the guide ran on that it steered: the
reference's guided rows a frame (``fb_used``, as ``guide_roofline`` reads
them) over the program's ``guide_rows`` counter a traced frame, in
percent.  Program counter, work from the reference."""
from portbench.metrics import _spans


def read(run):
    rows = _spans.per_frame(run, "guide_rows")
    if not rows or run.work is None:
        return None
    return 100.0 * run.work["guided_rows"] / rows
