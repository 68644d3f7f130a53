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
from .cuda_intersect import SphereTable, check_rays, nearest_hit
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
    float dtype (float32 or float64): ``trace_whitted``'s level loop.

    ``sweep="kernel"`` takes each level's nearest hit from the nearest-hit
    kernel (float32).  ``counters``: optional dict of ints that gains the
    work done (``levels`` active ray-levels, ``mirror`` and ``glass``
    bounces, ``walk_steps``, ``walk_exits``), from which ``chip_smoke.py``
    counts the kernel's operations; it costs host reads."""
    dtype, dev = origins.dtype, origins.device
    R = origins.shape[0]
    i32 = torch.int32
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = vec.normalise_safe_c(dirs[:, 0], dirs[:, 1], dirs[:, 2])
    sup = (torch.full((R,), NO_SUPPRESS, dtype=i32, device=dev)
           if suppress_id is None else suppress_id.to(i32))
    bounces = (torch.zeros((R,), dtype=i32, device=dev) if bounces0 is None
               else bounces0.to(dev, i32))
    through = (torch.zeros((R,), dtype=i32, device=dev) if through0 is None
               else through0.to(dev, i32))
    status = torch.full((R,), ACTIVE, dtype=i32, device=dev)
    zi = torch.zeros((R,), dtype=i32, device=dev)
    zf = torch.zeros((R,), dtype=dtype, device=dev)
    res = {k: zi if k in ("idx", "bounces", "through") else zf
           for k in _FIELDS}
    fbr = dict(res)
    fb_valid = torch.zeros((R,), dtype=torch.bool, device=dev)
    if counters is not None:
        for k in ("levels", "mirror", "glass", "walk_steps", "walk_exits"):
            counters.setdefault(k, 0)

    rows = table.spec

    def col(k):
        return torch.tensor([row[k] for row in rows], dtype=dtype,
                            device=dev)

    cx_t, cy_t, cz_t, r_t, ior_t = col(0), col(1), col(2), col(3), col(10)
    is_mirror = torch.tensor(table.mirror, dtype=torch.bool, device=dev)
    is_glass = torch.tensor(table.glass, dtype=torch.bool, device=dev)

    def select(mask, a, b):
        return {k: torch.where(mask, a[k], b[k]) for k in b}

    for _ in range(max_bounces + 2):
        active = status == ACTIVE
        if not bool(active.any()):     # nothing left: later levels are no-ops
            break
        if counters is not None:
            counters["levels"] += int(active.sum())
        if sweep == "kernel":
            t, idx, found = nearest_hit(
                torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1),
                sup, table, fast=fast)
            px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
            nx, ny, nz = vec.normalise_safe_c(px - cx_t[idx], py - cy_t[idx],
                                              pz - cz_t[idx])
        else:
            h = nearest_hit_c(ox, oy, oz, dx, dy, dz, rows, fast=fast,
                              by_abs=False, suppress_id=sup)
            t, idx, found = h.t, h.idx, h.found
            px, py, pz, nx, ny, nz = h.px, h.py, h.pz, h.nx, h.ny, h.nz
        here = dict(idx=idx, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz, t=t,
                    bounces=bounces, through=through)

        # The chain fails on no hit or a spent budget: the deepest mirror
        # hit if there is one, else none.
        fail = active & (~found | (bounces > max_bounces))
        res = select(fail & fb_valid, fbr, res)
        status = torch.where(fail, torch.where(fb_valid, DONE_HIT, DONE_NONE),
                             status)
        live = active & ~fail
        mirror = live & is_mirror[idx]
        glass = live & ~mirror & is_glass[idx]
        terminal = live & ~mirror & ~glass
        if counters is not None:
            counters["mirror"] += int(mirror.sum())
            counters["glass"] += int(glass.sum())
        res = select(terminal, here, res)
        status = torch.where(terminal, DONE_HIT, status)

        # Mirror: record the fallback and bounce.
        fb_valid = fb_valid | mirror
        fbr = select(mirror, here, fbr)
        rlx, rly, rlz = vec.reflect_c(dx, dy, dz, nx, ny, nz)

        # Glass: the walk through the sphere, skipped when no lane refracts.
        if bool(glass.any()):
            ok, epx, epy, epz, edx, edy, edz = _refract_walk_c(
                dx, dy, dz, nx, ny, nz, px, py, pz, cx_t[idx], cy_t[idx],
                cz_t[idx], r_t[idx], ior_t[idx], relevant=glass,
                counters=counters)
            trapped = glass & ~ok
            res = select(trapped & fb_valid, fbr, res)
            status = torch.where(trapped, torch.where(fb_valid, DONE_HIT,
                                                      DONE_NONE), status)
            glass = glass & ok
        else:
            epx, epy, epz, edx, edy, edz = px, py, pz, dx, dy, dz

        cont = mirror | glass
        ox = torch.where(mirror, px, torch.where(glass, epx, ox))
        oy = torch.where(mirror, py, torch.where(glass, epy, oy))
        oz = torch.where(mirror, pz, torch.where(glass, epz, oz))
        dx = torch.where(mirror, rlx, torch.where(glass, edx, dx))
        dy = torch.where(mirror, rly, torch.where(glass, edy, dy))
        dz = torch.where(mirror, rlz, torch.where(glass, edz, dz))
        sup = torch.where(cont, table.ids[idx], sup)
        bounces = torch.where(cont, bounces + 1, bounces)
        through = torch.where(glass, through + 1, through)

    return TraceResult(hit=status == DONE_HIT, idx=res["idx"],
                       point=torch.stack([res["px"], res["py"], res["pz"]],
                                         -1),
                       normal=torch.stack([res["nx"], res["ny"], res["nz"]],
                                          -1),
                       t=res["t"], bounces=res["bounces"],
                       through=res["through"])
