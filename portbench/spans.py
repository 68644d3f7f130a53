"""The traced run's record read with the program's own spans and counters.

The program records spans named ``raytracer.*`` inside its frame path
(``raytracer_tpu_torch/utils/profiling.py::span``) and keeps host counters
(``counters()``).  ``reduce`` gives ``tracing.reduce``'s record of the
same events with the program's spans left out (the same window, busy
time, device time by name and idle seconds; a program span that the
profiler mirrors onto the device's timeline is not device work), and adds:

* each idle gap's name in three parts where a program span covers its
  middle: the harness span, the innermost program span, the innermost
  other host op (``portbench.render/raytracer.trace_setup/aten::_to_copy``);
* ``span_idle_s``: for each program span name, the idle seconds inside the
  union of that name's intervals, by exact intersection: each name counts
  on its own, whatever nests inside it;
* ``counters``: the program's counter deltas over the traced frames.

``SpanTracer`` is ``tracing.Tracer`` with the counters taken when the
profiler starts and stops, and this record.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

from . import stats, tracing

PROGRAM = "raytracer."


@dataclasses.dataclass
class SpanRecord(tracing.TraceRecord):
    span_idle_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Optional[Dict[str, int]] = None


def reduce(events, frames: int,
           counters: Optional[Dict[str, int]] = None
           ) -> Optional[SpanRecord]:
    """``events``: ``(name, is_device, start_ns, end_ns)`` tuples, as
    ``tracing.reduce`` takes them; ``counters``: the deltas over the traced
    frames, or None.  None when ``tracing.reduce`` gives None."""
    rest = [ev for ev in events if not ev[0].startswith(PROGRAM)]
    base = tracing.reduce(rest, frames)
    if base is None:
        return None
    frame = [(s, e) for n, dev, s, e in rest
             if not dev and n == tracing.SPAN + "frame"]
    lo, hi = min(s for s, _ in frame), max(e for _, e in frame)
    busy = stats.union((max(s, lo), min(e, hi)) for n, dev, s, e in rest
                       if dev and e > lo and s < hi
                       and not n.startswith(tracing.SPAN))
    gaps = stats.gaps(busy, lo, hi)        # tracing.reduce's, in its order
    program = sorted((s, e, n) for n, dev, s, e in events
                     if not dev and n.startswith(PROGRAM))
    names = _innermost(program, [(s + e) // 2 for s, e in gaps])
    named = []
    for (name, seconds), inner in zip(base.gaps, names):
        if inner:
            span, _, op = name.partition("/")
            name = "/".join(p for p in (span, inner, op) if p)
        named.append((name, seconds))
    return SpanRecord(base.window_s, base.busy_s, base.frames, base.kernel_s,
                      named, span_idle_s=idle_by_name(program, gaps, lo, hi),
                      counters=counters)


def _innermost(spans: List[Tuple[int, int, str]], points: List[int]
               ) -> List[str]:
    """For each point (ascending), the name of the shortest span ``(start,
    end, name)`` (sorted) that covers it, "" where none does."""
    out, open_, at = [], [], 0
    for p in points:
        while at < len(spans) and spans[at][0] <= p:
            s, e, n = spans[at]
            heapq.heappush(open_, (e, s, n))
            at += 1
        while open_ and open_[0][0] < p:
            heapq.heappop(open_)
        out.append(min(((e - s, n) for e, s, n in open_),
                       default=(0, ""))[1])
    return out


def idle_by_name(spans: List[Tuple[int, int, str]],
                 gaps: List[Tuple[int, int]], lo: int, hi: int
                 ) -> Dict[str, float]:
    """Seconds of ``gaps`` (ns, sorted, disjoint) inside the union of each
    name's ``(start, end, name)`` spans clipped to ``[lo, hi]``; a name
    with a span in the window and no idle time reads 0."""
    by: Dict[str, list] = {}
    for s, e, n in spans:
        if e > lo and s < hi:
            by.setdefault(n, []).append((max(s, lo), min(e, hi)))
    return {n: overlap_ns(stats.union(iv), gaps) * 1e-9
            for n, iv in by.items()}


def overlap_ns(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def delta(before: Optional[dict], after: Optional[dict]
          ) -> Optional[Dict[str, int]]:
    if before is None or after is None:
        return None
    return {k: after[k] - before.get(k, 0) for k in after}


class SpanTracer(tracing.Tracer):
    """``tracing.Tracer`` whose record is ``reduce``'s, with the deltas of
    ``counters()`` (a snapshot dict of the program's counters, None where
    the program keeps none) from the profiler's start to its stop."""

    counters: Callable[[], Optional[dict]] = staticmethod(lambda: None)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.at_start = self.deltas = None

    def before_frame(self, elapsed: float, frame_s: float) -> None:
        started = self.prof is None
        super().before_frame(elapsed, frame_s)
        if started and self.prof is not None:
            self.at_start = self.counters()

    def finish(self) -> None:
        if self.prof is not None:
            self.deltas = delta(self.at_start, self.counters())
        super().finish()

    def record(self) -> Optional[SpanRecord]:
        return (reduce(self.events, self.traced, self.deltas)
                if self.done else None)
