"""Nearest-hit kernel: wrapper, launch count and plain version, and the
sphere table the Whitted kernels read.

Replaces ``raytracer_tpu/core/pallas_intersect.py::_kernel`` (reached
through ``nearest_hit_pallas``).  The CUDA kernel is ``csrc/nearest_hit.cu``;
its note says what bounds it on an H100 and what its design does about that.
The Whitted tracer's plain level launches it with ``sweep="kernel"``
and on the live lanes of ``impl="compact"`` (the RL env's steps among
them; the shading sweeps inside its own kernel, ``cuda_shade.py``); the
stepwise path tracer (``trace_path(impl="stepwise")``, ``cuda_path.level_stepwise``) once
a bounce level, ``|t|``, nothing suppressed.

``nearest_hit`` launches the kernel for CUDA tensors and raises on anything
it does not take; for CPU tensors, and only for them, it runs
``nearest_hit_plain``, the same function in plain PyTorch
(``core/intersect.py::nearest_hit_c``).  Both take ``[R, 3]`` origins and
unit directions and return ``(t, idx, found)``: the near-root distance
(float32 max where nothing is hit), the sphere index (0 there) and whether
any sphere passed the hit test.  The point and normal are computed by the
caller, as ``nearest_hit_pallas`` computes them.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import native
from .intersect import inside_threshold, nearest_hit_c
from ..scene.types import Scene
from ..trace.path import scene_spec

# The kernels stage the table in at most 48 KB of shared memory, 36 bytes a
# sphere (csrc/sphere.cuh).
MAX_SPHERES = 1024
ROW = 8         # cx cy cz r ior mirror glass T(r) (csrc/sphere.cuh kRow)


@dataclasses.dataclass(frozen=True)
class SphereTable:
    """The scene as the Whitted kernels read it.

    ``spec``: ``scene_spec`` rows (Python floats, exact values of the
    scene's dtype); ``mirror``/``glass``: per-sphere Python bools, the
    ``== 1.0`` material rule with ``enable_mirror``/``enable_glass`` applied;
    ``spheres [N, 8]`` float32 ``cx cy cz r ior mirror glass T(r)``, the
    last the exact inside test's threshold on ``d2``
    (``intersect.inside_threshold``); ``ids [N]`` int32."""
    spec: tuple
    mirror: tuple
    glass: tuple
    spheres: torch.Tensor
    ids: torch.Tensor


def sphere_table(scene: Scene, enable_glass: bool = True,
                 enable_mirror: bool = True) -> SphereTable:
    spec = scene_spec(scene)
    mirror = tuple(enable_mirror and row[7] == 1.0 for row in spec)
    glass = tuple(enable_glass and row[8] == 1.0 for row in spec)
    rows = np.array([(row[0], row[1], row[2], row[3], row[10], m, g, 0.0)
                     for row, m, g in zip(spec, mirror, glass)],
                    dtype=np.float32).reshape(len(spec), ROW)
    rows[:, 7] = inside_threshold(rows[:, 3])
    dev = scene.device
    return SphereTable(
        spec, mirror, glass, spheres=torch.from_numpy(rows).to(dev),
        ids=torch.tensor([row[11] for row in spec], dtype=torch.int32,
                         device=dev))


def check_rays(origins, dirs, suppress_id, table: SphereTable):
    """The checks both Whitted kernels' wrappers make (raise on what the
    kernels do not take)."""
    for name, t in (("origins", origins), ("dirs", dirs)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor (the kernels "
                            f"are float32; use the plain version for "
                            f"float64)")
        if t.dim() != 2 or t.shape[1] != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [R, 3] tensor, "
                             f"got {tuple(t.shape)}")
    R = origins.shape[0]
    dev = origins.device
    if dirs.shape[0] != R or dirs.device != dev:
        raise ValueError("dirs must match origins in length and device")
    if suppress_id is not None:
        if (suppress_id.dtype != torch.int32 or suppress_id.device != dev
                or tuple(suppress_id.shape) != (R,)
                or not suppress_id.is_contiguous()):
            raise ValueError(f"suppress_id must be a contiguous int32 [{R}] "
                             f"tensor on the rays' device")
    n = len(table.spec)
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"scene has {n} spheres; the kernels take "
                         f"1..{MAX_SPHERES}")
    if table.spheres.device != dev or table.ids.device != dev:
        raise ValueError("sphere table must be on the rays' device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the Whitted kernels run on cuda or cpu, not {dev}")


def nearest_hit(origins: torch.Tensor, dirs: torch.Tensor,
                suppress_id: Optional[torch.Tensor], table: SphereTable, *,
                by_abs: bool = False, fast: bool = False):
    """The nearest-hit kernel on CUDA tensors; the plain version on CPU
    tensors.  ``suppress_id``: ``[R]`` int32 or None (no suppression).
    Returns ``(t [R] float32, idx [R] int32, found [R] bool)``."""
    check_rays(origins, dirs, suppress_id, table)
    dev = origins.device
    if dev.type == "cpu":
        return nearest_hit_plain(origins, dirs, suppress_id, table,
                                 by_abs=by_abs, fast=fast)
    lib = _library()
    R = origins.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    found = torch.empty((R,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nearest_hit_launch(
            origins.data_ptr(), dirs.data_ptr(),
            None if suppress_id is None else suppress_id.data_ptr(),
            table.spheres.data_ptr(), table.ids.data_ptr(), len(table.spec),
            R, int(by_abs), int(fast), t.data_ptr(), idx.data_ptr(),
            found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_hit kernel launch failed: CUDA error "
                           f"{err}")
    nearest_hit.launches += 1
    return t, idx, found


nearest_hit.launches = 0      # kernel launches in this process


def _library() -> ctypes.CDLL:
    lib = native.load("nearest_hit").lib
    fn = lib.nearest_hit_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def nearest_hit_plain(origins: torch.Tensor, dirs: torch.Tensor,
                      suppress_id: Optional[torch.Tensor],
                      table: SphereTable, *, by_abs: bool = False,
                      fast: bool = False):
    """Plain PyTorch version of the kernel, on any device and float dtype."""
    h = nearest_hit_c(origins[:, 0], origins[:, 1], origins[:, 2],
                      dirs[:, 0], dirs[:, 1], dirs[:, 2], table.spec,
                      fast=fast, by_abs=by_abs, suppress_id=suppress_id)
    return h.t, h.idx, h.found


def sweep_work(origins: torch.Tensor, dirs: torch.Tensor,
               suppress_id: Optional[torch.Tensor], table: SphereTable, *,
               fast: bool = False,
               active: Optional[torch.Tensor] = None) -> dict:
    """The sweep's work on these rays, as ``csrc/sphere.cuh::test`` does it:
    ``sphere_tests`` (every sphere against every ray), ``front_sphere_tests``
    (``tca >= 0``, where ``d2`` and the inside test are needed) and
    ``valid_sphere_tests`` (inside and not suppressed, where ``thc``, ``t``
    and the metric are needed).  ``active [R]`` bool: count only those rays.
    ``chip_smoke.py`` bounds the Whitted kernels by these counts."""
    ox, oy, oz = origins.unbind(1)
    dx, dy, dz = dirs.unbind(1)
    if active is None:
        active = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    front = valid = 0
    for row, thr in zip(table.spec, table.spheres[:, 7].tolist()):
        lx, ly, lz = row[0] - ox, row[1] - oy, row[2] - oz
        tca = lx * dx + ly * dy + lz * dz
        d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)
        ahead = active & (tca >= 0.0)
        inside = (d2 <= row[3] * row[3]) if fast else (d2 <= thr)
        if suppress_id is not None:
            inside = inside & (suppress_id != row[-1])
        front += int(ahead.sum())
        valid += int((ahead & inside).sum())
    return {"sphere_tests": len(table.spec) * int(active.sum()),
            "front_sphere_tests": front, "valid_sphere_tests": valid}
