"""Timing and tracing helpers.

Counterpart of ``raytracer_tpu/utils/profiling.py``:

* ``Timer``: a wall-clock bracket with derived rays/s (end the timed
  work with ``torch.cuda.synchronize()`` inside it: CUDA calls return
  before the card finishes);
* ``device_trace``: a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activity) around a block, written as a Chrome trace
  ``trace.json`` into ``log_dir`` (Perfetto and ``chrome://tracing`` read
  it);
* ``span`` and ``spanned``: the frame path's named spans, recorded by any
  ``torch.profiler`` session (``device_trace`` among them) on the device
  trace's clock, and nothing at all without one;
* ``count`` and ``counters``: the frame path's host counters and the
  kernels' launch counts, as one snapshot;
* ``progress``: tqdm if present, else the reference's percent-milestone
  prints (RL/Planets 2.ipynb cell 0).
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Iterable, Iterator, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
# Counted where the work happens, on the host: ``host_reads``, the scene's
# tensors read to host numpy on the frame path (each a device sync on a
# card); ``guide_rows``, the rows passed to a guide called on the host;
# ``guide_module_calls``, full-agent guide calls on a card that ran
# ``fb/networks.py``'s modules instead of ``fb/fused_guide.py`` (the bf16
# guide, or widths the row kernel does not take).
_COUNTS = {"host_reads": 0, "guide_rows": 0, "guide_module_calls": 0}


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


def span(name: str):
    """A context manager that records ``name`` as a span while a
    ``torch.profiler`` session records, and is a shared no-op otherwise.

    A span's parent is the span that encloses it on the host thread, so the
    spans of one frame nest under the caller's own.  They live in the
    profiler's memory and leave with its trace.  The span is recorded in
    the profiler's function scope, not ``record_function``'s user scope:
    the profiler mirrors a user-scope span onto the device's timeline as
    one interval from the first to the last kernel launched inside it,
    idle time between them included, and a reader that takes the device's
    intervals for its work would count that time as busy."""
    if not _profiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` (``counters`` lists them)."""
    _COUNTS[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of the process's counters: ``host_reads``,
    ``guide_rows`` and ``guide_module_calls`` (``count``), and each kernel's launches, all routes and
    by route (``launches.path_trace.<route>``).  The work between two
    snapshots is their difference."""
    from ..core import (cuda_intersect, cuda_level, cuda_norm, cuda_path,
                        cuda_shade, cuda_whitted)
    out = {"launches.path_trace": cuda_path.path_trace.launches}
    for route, n in cuda_path.path_trace.route_launches.items():
        out[f"launches.path_trace.{route}"] = n
    out["launches.path_level"] = cuda_level.path_level.launches
    out["launches.nearest_hit"] = cuda_intersect.nearest_hit.launches
    out["launches.whitted_trace"] = cuda_whitted.whitted_trace.launches
    out["launches.whitted_shade"] = cuda_shade.whitted_shade.launches
    out["launches.guide_norm"] = cuda_norm.guide_norm.launches
    out.update(_COUNTS)
    return out


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
