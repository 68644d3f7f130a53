"""Whole-trace Whitted kernel: wrapper, launch count and plain version.

Replaces ``raytracer_tpu/core/pallas_whitted.py::_kernel`` (reached through
``trace_whitted_pallas``).  The CUDA kernel is ``csrc/whitted_trace.cu``;
its note says what bounds it on an H100 and what its design does about
that.

``whitted_trace`` launches the kernel for CUDA tensors and raises on
anything it does not take (float64 included); for CPU tensors, and only
for them, it runs ``whitted_trace_plain``, the level loop of
``raytracer_tpu/trace/whitted.py::trace_whitted`` in plain PyTorch, op for
op.  Both take ``[R, 3]`` origins and unnormalised directions and return a
``TraceResult``.  The kernel traces from the camera entry (no
``bounces0``/``through0``), as ``trace_whitted_pallas`` does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import native, vec
from .cuda_intersect import (SphereTable, check_rays, nearest_hit,
                             sweep_work)
from .intersect import NO_SUPPRESS, nearest_hit_c
from ..trace.whitted import (ACTIVE, DONE_HIT, DONE_NONE, TraceResult,
                             _refract_walk_c)

_FIELDS = ("idx", "px", "py", "pz", "nx", "ny", "nz", "t", "bounces",
           "through")


def whitted_trace(origins: torch.Tensor, dirs: torch.Tensor,
                  suppress_id: Optional[torch.Tensor], table: SphereTable, *,
                  max_bounces: int, fast: bool = False) -> TraceResult:
    """The Whitted kernel on CUDA tensors; the plain version on CPU
    tensors.  ``suppress_id``: ``[R]`` int32 or None."""
    check_rays(origins, dirs, suppress_id, table)
    if max_bounces < 0:
        raise ValueError(f"max_bounces must be >= 0, got {max_bounces}")
    dev = origins.device
    if dev.type == "cpu":
        return whitted_trace_plain(origins, dirs, suppress_id, table,
                                   max_bounces=max_bounces, fast=fast)
    lib = _library()
    R = origins.shape[0]
    f32, i32 = torch.float32, torch.int32
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    idx = torch.empty((R,), dtype=i32, device=dev)
    t = torch.empty((R,), dtype=f32, device=dev)
    point = torch.empty((R, 3), dtype=f32, device=dev)
    normal = torch.empty((R, 3), dtype=f32, device=dev)
    bounces = torch.empty((R,), dtype=i32, device=dev)
    through = torch.empty((R,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whitted_trace_launch(
            origins.data_ptr(), dirs.data_ptr(),
            None if suppress_id is None else suppress_id.data_ptr(),
            table.spheres.data_ptr(), table.ids.data_ptr(), len(table.spec),
            R, max_bounces, int(fast), hit.data_ptr(), idx.data_ptr(),
            t.data_ptr(), point.data_ptr(), normal.data_ptr(),
            bounces.data_ptr(), through.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"whitted_trace kernel launch failed: CUDA error "
                           f"{err}")
    whitted_trace.launches += 1
    return TraceResult(hit=hit, idx=idx, point=point, normal=normal, t=t,
                       bounces=bounces, through=through)


whitted_trace.launches = 0      # kernel launches in this process


def _library() -> ctypes.CDLL:
    lib = native.load("whitted_trace").lib
    fn = lib.whitted_trace_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, i,
                       p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def whitted_trace_plain(origins: torch.Tensor, dirs: torch.Tensor,
                        suppress_id: Optional[torch.Tensor],
                        table: SphereTable, *, max_bounces: int,
                        fast: bool = False,
                        bounces0: Optional[torch.Tensor] = None,
                        through0: Optional[torch.Tensor] = None,
                        sweep: str = "plain",
                        counters: Optional[dict] = None) -> TraceResult:
    """Plain PyTorch version of the kernel, on any device, in the rays'
    float dtype (float32 or float64): ``trace_whitted``'s level loop, every
    level over the whole wavefront.

    ``sweep="kernel"`` takes each level's nearest hit from the nearest-hit
    kernel (float32).  ``counters``: optional dict of ints that gains the
    work done (``levels`` active ray-levels, their sweep's work as
    ``cuda_intersect.sweep_work`` counts it, ``mirror`` and ``glass``
    bounces, ``walk_steps``, ``walk_exits``), from which ``chip_smoke.py``
    counts the kernel's operations; it costs host reads."""
    lanes, cols = _start(origins, dirs, suppress_id, table, bounces0,
                         through0, counters)
    for _ in range(max_bounces + 2):
        if not bool((lanes["status"] == ACTIVE).any()):
            break           # nothing left: later levels are no-ops
        lanes = _level(lanes, table, cols, max_bounces=max_bounces,
                       fast=fast, sweep=sweep, counters=counters)
    return _result(lanes)


def whitted_trace_compact(origins: torch.Tensor, dirs: torch.Tensor,
                          suppress_id: Optional[torch.Tensor],
                          table: SphereTable, *, max_bounces: int,
                          fast: bool = False,
                          bounces0: Optional[torch.Tensor] = None,
                          through0: Optional[torch.Tensor] = None,
                          sweep: str = "plain", min_bucket: int = 1024,
                          counters: Optional[dict] = None) -> TraceResult:
    """``whitted_trace_plain`` with the live lanes compacted between levels
    (JAX ``trace_whitted_compact``): level 0 runs on the whole wavefront,
    each later level on the lanes still active, gathered into a bucket of
    ``max(min_bucket, the next power of two)`` lanes (at most the previous
    level's), the padding inactive.  The per-lane arithmetic is the plain
    level's, so every field equals ``whitted_trace_plain``'s bit for bit.
    One host read a level besides the plain level's own (whether any lane
    refracts): the counts of live and newly finished lanes, taken together
    with the stable sort that lists both.  ``counters`` also gains
    ``lanes``: ``(live, bucket)`` of each level."""
    lanes, cols = _start(origins, dirs, suppress_id, table, bounces0,
                         through0, counters)
    R = origins.shape[0]
    full = {k: v for k, v in lanes.items()
            if k == "status" or k.startswith("res_")}
    idx_map = torch.arange(R, device=origins.device)
    valid = torch.ones((R,), dtype=torch.bool, device=origins.device)
    live = R
    for _ in range(max_bounces + 2):
        if counters is not None:
            counters.setdefault("lanes", []).append(
                (live, idx_map.shape[0]))
        lanes = _level(lanes, table, cols, max_bounces=max_bounces,
                       fast=fast, sweep=sweep, counters=counters)
        # 0: still active, 1: finished at this level, 2: padding.  A
        # stable sort lists the active lanes, then the finished ones, each
        # in lane order.
        active = lanes["status"] == ACTIVE
        group = torch.where(active, 0, torch.where(valid, 1, 2))
        order = torch.sort(group, stable=True).indices
        live, n_done = torch.bincount(group, minlength=3)[:2].tolist()
        di = order[live:live + n_done]
        for k in full:
            full[k] = full[k].index_copy(0, idx_map[di],
                                         lanes[k][di].to(full[k].dtype))
        if live == 0:
            break
        bucket = max(min_bucket, 1 << max(live - 1, 1).bit_length())
        bucket = min(bucket, idx_map.shape[0])
        sel = order[:live]
        pad = bucket - live
        if pad:     # padding lanes: copies of lane 0, made inactive
            sel = torch.cat([sel, sel.new_zeros(pad)])
        valid = torch.arange(bucket, device=sel.device) < live
        lanes = {k: v[sel] for k, v in lanes.items()}
        lanes["status"] = torch.where(valid, lanes["status"], DONE_NONE)
        idx_map = idx_map[sel]
    return _result(full)


def _start(origins, dirs, suppress_id, table, bounces0, through0, counters):
    """The level loop's lanes at the camera entry: a dict of ``[R]``
    tensors (ray, suppressed id, depth, status, the result so far and the
    mirror fallback), and the table's columns in the rays' dtype."""
    dtype, dev = origins.dtype, origins.device
    R = origins.shape[0]
    i32 = torch.int32
    dx, dy, dz = vec.normalise_safe_c(dirs[:, 0], dirs[:, 1], dirs[:, 2])
    zi = torch.zeros((R,), dtype=i32, device=dev)
    zf = torch.zeros((R,), dtype=dtype, device=dev)
    lanes = dict(
        ox=origins[:, 0], oy=origins[:, 1], oz=origins[:, 2],
        dx=dx, dy=dy, dz=dz,
        sup=(torch.full((R,), NO_SUPPRESS, dtype=i32, device=dev)
             if suppress_id is None else suppress_id.to(i32)),
        bounces=zi if bounces0 is None else bounces0.to(dev, i32),
        through=zi if through0 is None else through0.to(dev, i32),
        status=torch.full((R,), ACTIVE, dtype=i32, device=dev),
        fb_valid=torch.zeros((R,), dtype=torch.bool, device=dev))
    for k in _FIELDS:
        z = zi if k in ("idx", "bounces", "through") else zf
        lanes["res_" + k] = lanes["fb_" + k] = z
    if counters is not None:
        for k in ("levels", "sphere_tests", "front_sphere_tests",
                  "valid_sphere_tests", "mirror", "glass", "walk_steps",
                  "walk_exits"):
            counters.setdefault(k, 0)

    def col(k):
        return torch.tensor([row[k] for row in table.spec], dtype=dtype,
                            device=dev)

    cols = dict(cx=col(0), cy=col(1), cz=col(2), r=col(3), ior=col(10),
                mirror=torch.tensor(table.mirror, dtype=torch.bool,
                                    device=dev),
                glass=torch.tensor(table.glass, dtype=torch.bool,
                                   device=dev))
    return lanes, cols


def _level(lanes, table, cols, *, max_bounces, fast, sweep, counters):
    """One recursion level over ``lanes``; lanes not active pass through
    unchanged.  Returns the new lanes."""
    L = dict(lanes)
    status, bounces, through = L["status"], L["bounces"], L["through"]
    ox, oy, oz, dx, dy, dz, sup = (L[k] for k in ("ox", "oy", "oz", "dx",
                                                  "dy", "dz", "sup"))
    fb_valid = L["fb_valid"]
    cx_t, cy_t, cz_t = cols["cx"], cols["cy"], cols["cz"]
    active = status == ACTIVE
    if counters is not None:
        counters["levels"] += int(active.sum())
        work = sweep_work(torch.stack([ox, oy, oz], 1),
                          torch.stack([dx, dy, dz], 1), sup, table,
                          fast=fast, active=active)
        for k, v in work.items():
            counters[k] += v
    if sweep == "kernel":
        t, idx, found = nearest_hit(
            torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1),
            sup, table, fast=fast)
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        nx, ny, nz = vec.normalise_safe_c(px - cx_t[idx], py - cy_t[idx],
                                          pz - cz_t[idx])
    else:
        h = nearest_hit_c(ox, oy, oz, dx, dy, dz, table.spec, fast=fast,
                          by_abs=False, suppress_id=sup)
        t, idx, found = h.t, h.idx, h.found
        px, py, pz, nx, ny, nz = h.px, h.py, h.pz, h.nx, h.ny, h.nz
    here = dict(idx=idx, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz, t=t,
                bounces=bounces, through=through)

    def select(mask, src, dst):
        """``dst``'s fields (``res_`` or ``fb_``) from ``src`` where
        ``mask``; ``src``: a lanes prefix or the level's ``here``."""
        for k in _FIELDS:
            a = here[k] if src == "here" else L[src + k]
            L[dst + k] = torch.where(mask, a, L[dst + k])

    # The chain fails on no hit or a spent budget: the deepest mirror hit
    # if there is one, else none.
    fail = active & (~found | (bounces > max_bounces))
    select(fail & fb_valid, "fb_", "res_")
    status = torch.where(fail, torch.where(fb_valid, DONE_HIT, DONE_NONE),
                         status)
    live = active & ~fail
    mirror = live & cols["mirror"][idx]
    glass = live & ~mirror & cols["glass"][idx]
    terminal = live & ~mirror & ~glass
    if counters is not None:
        counters["mirror"] += int(mirror.sum())
        counters["glass"] += int(glass.sum())
    select(terminal, "here", "res_")
    status = torch.where(terminal, DONE_HIT, status)

    # Mirror: record the fallback and bounce.
    fb_valid = fb_valid | mirror
    select(mirror, "here", "fb_")
    rlx, rly, rlz = vec.reflect_c(dx, dy, dz, nx, ny, nz)

    # Glass: the walk through the sphere, skipped when no lane refracts.
    if bool(glass.any()):
        ok, epx, epy, epz, edx, edy, edz = _refract_walk_c(
            dx, dy, dz, nx, ny, nz, px, py, pz, cx_t[idx], cy_t[idx],
            cz_t[idx], cols["r"][idx], cols["ior"][idx], relevant=glass,
            counters=counters)
        trapped = glass & ~ok
        select(trapped & fb_valid, "fb_", "res_")
        status = torch.where(trapped, torch.where(fb_valid, DONE_HIT,
                                                  DONE_NONE), status)
        glass = glass & ok
    else:
        epx, epy, epz, edx, edy, edz = px, py, pz, dx, dy, dz

    cont = mirror | glass
    L.update(
        ox=torch.where(mirror, px, torch.where(glass, epx, ox)),
        oy=torch.where(mirror, py, torch.where(glass, epy, oy)),
        oz=torch.where(mirror, pz, torch.where(glass, epz, oz)),
        dx=torch.where(mirror, rlx, torch.where(glass, edx, dx)),
        dy=torch.where(mirror, rly, torch.where(glass, edy, dy)),
        dz=torch.where(mirror, rlz, torch.where(glass, edz, dz)),
        sup=torch.where(cont, table.ids[idx], sup),
        bounces=torch.where(cont, bounces + 1, bounces),
        through=torch.where(glass, through + 1, through),
        status=status, fb_valid=fb_valid)
    return L


def _result(lanes) -> TraceResult:
    r = {k: lanes["res_" + k] for k in _FIELDS}
    return TraceResult(hit=lanes["status"] == DONE_HIT, idx=r["idx"],
                       point=torch.stack([r["px"], r["py"], r["pz"]], -1),
                       normal=torch.stack([r["nx"], r["ny"], r["nz"]], -1),
                       t=r["t"], bounces=r["bounces"], through=r["through"])
