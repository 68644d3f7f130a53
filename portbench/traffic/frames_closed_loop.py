"""One client rendering frames one after another, each after the last has
reached the host: how the comparison harness, the CLI and the turntables
call the renderers.

A frame is timed from the start of its draws (its planes, made from
``(seed, frame index)`` by the cell's program kind) to its image and
counters on the host.  Frames start while the window is open; the window's time runs to
the end of its last frame.  A seeded reservoir keeps ``keep`` of the
window's frames, uniformly, for the comparison with the reference.
"""
from __future__ import annotations

import random
import time
from contextlib import nullcontext
from typing import List, Tuple

WARM_UP_FRAMES = 2


class Reservoir:
    """``keep`` items drawn uniformly from a stream (algorithm R), the
    draws from ``seed``."""

    def __init__(self, keep: int, seed: int):
        self.keep, self.rng = keep, random.Random(seed)
        self.items: List[tuple] = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.keep:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.keep:
                self.items[j] = item
        self.seen += 1


def warm_up(session) -> None:
    """Frames of the cell's own shapes from planes of negative indices:
    every kernel built and loaded, every shape seen once."""
    for i in range(WARM_UP_FRAMES):
        session.render(session.planes(-1 - i))


def window(session, seconds: float, keep: Reservoir, tracer=None,
           min_frames: int = 1) -> Tuple[float, List[Tuple[float, float]]]:
    """Frames for ``seconds`` (and at least ``min_frames``): ``(start,
    [(frame start, frame end)])`` on the host clock; each frame's ``(index,
    image, counters)`` offered to ``keep``."""
    frames: List[Tuple[float, float]] = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if tracer is not None:
            tracer.before_frame(t0 - start, (t0 - start) / max(i, 1))
        span = tracer.span if tracer is not None else _no_span
        with span("frame"):
            with span("draw"):
                planes = session.planes(i)
            with span("render"):
                image, counters = session.render(planes)
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.after_frame()
        session.frame_done()
        frames.append((t0, t1))
        keep.offer((i, image, counters))
        i += 1
        if t1 - start >= seconds and i >= min_frames:
            break
    if tracer is not None:
        tracer.finish()
    return start, frames


def _no_span(name):
    return nullcontext()
