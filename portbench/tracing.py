"""The traced run's device record: ``torch.profiler`` over a steady run of
frames inside the window, reduced to what the per-layer metrics read.

The harness marks each frame and its stages with ``record_function``
spans (``portbench.frame``, ``.draw``, ``.render``, ``.guide``); the
window is the first traced frame's start to the last one's end on the
profiler's clock.  Device time is the union of the device's activity
intervals (kernels, copies, sets) clipped to the window, so overlapping
work is not counted twice; an idle gap is named by what the host was
doing at its middle: the innermost harness span and the innermost other
host op that cover it.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

from . import stats

SPAN = "portbench."
TOP = 10


@dataclasses.dataclass
class TraceRecord:
    window_s: float
    busy_s: float
    frames: int
    kernel_s: Dict[str, float]          # device seconds by name
    gaps: List[Tuple[str, float]]       # (host activity, idle seconds)

    @property
    def frame_s(self) -> float:
        return self.window_s / self.frames

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        by = defaultdict(float)
        for name, s in self.gaps:
            by[name] += s
        gaps = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _ns(e, which: str) -> int:
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start if which == "start" else start + e.duration_ns()
    start = e.start_us() * 1000
    return start if which == "start" else start + e.duration_us() * 1000


def reduce(events, frames: int) -> Optional[TraceRecord]:
    """``events``: ``(name, is_device, start_ns, end_ns)`` tuples.  None
    when no frame span or no device activity is in them."""
    spans = [(s, e) for n, dev, s, e in events
             if not dev and n == SPAN + "frame"]
    if not spans:
        return None
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    # The profiler mirrors the harness's spans onto the device's timeline;
    # they are not device work.
    device = [(n, max(s, lo), min(e, hi)) for n, dev, s, e in events
              if dev and e > lo and s < hi and not n.startswith(SPAN)]
    if not device:
        return None
    union = stats.union([(s, e) for _, s, e in device])
    kernel_s: Dict[str, float] = defaultdict(float)
    for n, s, e in device:
        kernel_s[n] += (e - s) * 1e-9
    host = sorted((s, e, n) for n, dev, s, e in events if not dev)
    gaps, open_, at = [], [], 0
    for s, e in stats.gaps(union, lo, hi):      # in time order
        mid = (s + e) // 2
        while at < len(host) and host[at][0] <= mid:
            heapq.heappush(open_, (host[at][1], host[at][0], host[at][2]))
            at += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        covering = [(he - hs, n) for he, hs, n in open_]
        span = min((c for c in covering if c[1].startswith(SPAN)),
                   default=(0, SPAN + "host"))[1]
        op = min((c for c in covering if not c[1].startswith(SPAN)),
                 default=(0, ""))[1]
        gaps.append((f"{span}/{op}" if op else span, (e - s) * 1e-9))
    busy = sum(e - s for s, e in union) * 1e-9
    return TraceRecord((hi - lo) * 1e-9, busy, frames, dict(kernel_s), gaps)


class Tracer:
    """Profiles ``n`` frames once the window is ``at`` through: ``n``
    covers about ``target_s`` of frames, at least 2 and at most
    ``most``.  ``span(name)`` marks a stage while profiling."""

    def __init__(self, seconds: float, at: float = 0.3,
                 target_s: float = 1.0, most: int = 100):
        self.start_after = seconds * at
        self.target_s, self.most = target_s, most
        self.prof = None
        self.left = 0
        self.traced = 0
        self.done = False
        self.events = []

    @staticmethod
    def warm_up(fn):
        """One profiled call in set-up: the profiler's first start (CUPTI's
        set-up) stays out of the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()

    def span(self, name: str):
        if self.prof is None:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN + name)

    def before_frame(self, elapsed: float, frame_s: float) -> None:
        if self.done or self.prof is not None or elapsed < self.start_after:
            return
        from torch.profiler import ProfilerActivity, profile
        self.left = max(2, min(self.most,
                               math.ceil(self.target_s / max(frame_s,
                                                             1e-6))))
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def after_frame(self) -> None:
        if self.prof is None:
            return
        self.traced += 1
        self.left -= 1
        if self.left <= 0:
            self.finish()

    def finish(self) -> None:
        """Stops the profiler if it runs (the window closed first)."""
        if self.prof is None:
            return
        self.prof.__exit__(None, None, None)
        self.events = [(e.name(), e.device_type().name != "CPU",
                        _ns(e, "start"), _ns(e, "end"))
                       for e in self.prof.profiler.kineto_results.events()]
        self.prof = None
        self.done = True

    def record(self) -> Optional[TraceRecord]:
        return reduce(self.events, self.traced) if self.done else None
