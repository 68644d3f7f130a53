"""Timing and tracing helpers.

Counterpart of ``raytracer_tpu/utils/profiling.py``:

* ``Timer``: a wall-clock bracket with derived rays/s (end the timed
  work with ``torch.cuda.synchronize()`` inside it: CUDA calls return
  before the card finishes);
* ``device_trace``: a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activity) around a block, written as a Chrome trace
  ``trace.json`` into ``log_dir`` (Perfetto and ``chrome://tracing`` read
  it);
* ``progress``: tqdm if present, else the reference's percent-milestone
  prints (RL/Planets 2.ipynb cell 0).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterable, Iterator, Optional

import torch


class Timer:
    def __init__(self, name: str = "", rays: Optional[int] = None):
        self.name = name
        self.rays = rays
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @property
    def rays_per_second(self) -> float:
        return (self.rays / self.elapsed
                if self.rays and self.elapsed > 0 else 0.0)

    def report(self) -> str:
        s = f"{self.name}: {self.elapsed:.3f}s"
        if self.rays:
            s += f" ({self.rays_per_second / 1e6:.2f} Mrays/s)"
        return s


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write
    ``log_dir/trace.json``; yields the profiler (its ``key_averages()``
    sums time by operator and kernel)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def progress(it: Iterable, total: Optional[int] = None,
             desc: str = "") -> Iterator:
    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = None
    if tqdm is not None:
        yield from tqdm(it, total=total, desc=desc)
        return
    total = total or (len(it) if hasattr(it, "__len__") else None)
    milestones = list(range(0, 101, 10))
    for i, x in enumerate(it):
        if total:
            pct = (i + 1) / total * 100
            while milestones and pct >= milestones[0]:
                print(f"{desc}: {milestones.pop(0)}%", end="\r")
        yield x
