"""The shared arithmetic of the readers of the program's spans and
counters (``portbench/spans.py::SpanRecord``): a span name's idle seconds
as a share of the traced window, and a counter's delta a traced frame.
None where the record has neither (a record without the program's spans
or counters)."""


def idle_share(run, name: str):
    t = run.trace
    idle = getattr(t, "span_idle_s", {}).get(name) if t else None
    if idle is None or t.window_s <= 0:
        return None
    return 100.0 * idle / t.window_s


def per_frame(run, counter: str):
    t = run.trace
    counts = getattr(t, "counters", None) if t else None
    if not counts or counter not in counts or t.frames <= 0:
        return None
    return counts[counter] / t.frames
