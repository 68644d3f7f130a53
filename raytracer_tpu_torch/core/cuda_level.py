"""Per-level path kernel: wrapper, launch count and plain version.

Replaces ``raytracer_tpu/core/pallas_path.py::_level_kernel`` (reached
through ``run_level_kernel``), the hot path of ``trace_path(impl="hybrid")``.
The CUDA kernel is ``csrc/path_level.cu``; it runs the same level code as
the whole-trace kernel (``csrc/path_common.cuh``), so a hybrid trace equals
a whole-trace one bit for bit.

``path_level`` launches the kernel for CUDA tensors and raises on anything
it does not take; for CPU tensors, and only for them, it runs
``path_level_plain`` (``cuda_path.level_plain``, the level the plain whole
trace runs).  Both return a ``cuda_path.Level``; ``want_hit`` adds the hit
plane the guide's observation is built from.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import native
from .cuda_path import (ST_CONT, ST_EMISSIVE, ST_FOUND, ST_MIRROR,  # noqa
                        ST_RUNNING, ST_SMALL, Level, PathTable, check_plane,
                        check_rays, level_plain)

HIT_COLUMNS = 11
path_level_plain = level_plain


def _check(o, d, running, u, table):
    check_rays(o, d, table)
    R, dev = o.shape[0], o.device
    check_plane("running", running, (R,), torch.bool, dev)
    if u is not None:
        check_plane("u", u, (R, 2), torch.float32, dev)


def path_level(o: torch.Tensor, d: torch.Tensor, running: torch.Tensor,
               u: Optional[torch.Tensor], table: PathTable, *,
               fast: bool = False, want_hit: bool = False) -> Level:
    """One level through the kernel on CUDA tensors; the plain version on
    CPU tensors.  ``d``: unit directions; ``running [R]`` bool; ``u [R,
    2]`` the level's uniforms, or None when no diffuse bounce is
    possible."""
    _check(o, d, running, u, table)
    dev = o.device
    if dev.type == "cpu":
        return path_level_plain(o, d, running, u, table, fast=fast,
                                want_hit=want_hit)
    if dev.type != "cuda":
        raise ValueError(f"path_level runs on cuda or cpu, not {dev}")
    lib = _library()
    R = o.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    out = Level(torch.empty(R, dtype=torch.uint8, device=dev),
                torch.empty((R, 6), **f32), torch.empty((R, 3), **f32),
                torch.empty((R, 3), **f32),
                torch.empty((R, HIT_COLUMNS), **f32) if want_hit else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.path_level_launch(
            o.data_ptr(), d.data_ptr(), running.data_ptr(),
            None if u is None else u.data_ptr(), table.spheres.data_ptr(),
            table.flags.data_ptr(), table.emissive.data_ptr(),
            table.inside.data_ptr(), table.light_cut.data_ptr(),
            len(table.spec), len(table.emissive_idx), R, int(fast),
            out.state.data_ptr(), out.rec.data_ptr(), out.o_next.data_ptr(),
            out.d_next.data_ptr(),
            None if out.hit is None else out.hit.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"path_level kernel launch failed: CUDA error "
                           f"{err}")
    path_level.launches += 1
    return out


path_level.launches = 0      # kernel launches in this process


def _library() -> ctypes.CDLL:
    lib = native.load("path_level").lib
    fn = lib.path_level_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, ctypes.c_longlong,
                       i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib
