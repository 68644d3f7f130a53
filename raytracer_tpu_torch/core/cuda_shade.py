"""Whitted shading kernel: wrapper, launch count and plain version.

``whitted_shade`` shades a wavefront of Whitted termini as
``trace/shade.py::terminal_rgb`` does with ``shadow_max_bounces == 0``
(every reference call site), the misses in ``miss_colour``: the emissive
term, every global light, every point light with its shadow sweep, the
banker's rounding.  On CUDA tensors it launches ``csrc/whitted_shade.cu``,
which does all of it in one pass with the shadow sweeps inside (its note
says what bounds it on an H100 and what its design does about that), and
raises on anything the kernel does not take (float64 included); on CPU
tensors, and only for them, it runs ``whitted_shade_plain``, which is
``terminal_rgb(impl="plain")``.  It replaces no ``pallas_call``: the JAX
package shades in plain jnp, its shadow sweeps through
``nearest_hit_pallas``.

The kernel reads the sphere table for the sweep's geometry and the ids
(``cuda_intersect.SphereTable``: pass the trace's, or None to build one
from the scene, which reads the scene to the host); the glass rule, the
albedo and the emission come from the scene's own columns, so the table's
``enable_glass``/``enable_mirror`` flags cannot change the colours.  The
lights are read on the card: nothing of the call waits for the device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import native
from .cuda_intersect import MAX_SPHERES, SphereTable, sphere_table
from ..scene.types import GlobalLights, PointLights, Scene


def whitted_shade_plain(scene: Scene, glights: GlobalLights,
                        plights: PointLights, res, background,
                        miss_colour=None,
                        table: Optional[SphereTable] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and float dtype:
    ``terminal_rgb(impl="plain")``."""
    from ..trace.shade import terminal_rgb   # trace/shade.py imports this
    return terminal_rgb(scene, glights, plights, res, background,
                        impl="plain", table=table, miss_colour=miss_colour)


def _check(scene, glights, plights, res, table):
    """The columns the kernel reads, as float32 / int32 contiguous tensors
    on the termini's device; raises on what it does not take."""
    for name in ("point", "normal"):
        t = getattr(res, name)
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"res.{name} must be a float32 tensor (the "
                            f"kernel is float32; use impl='plain' for "
                            f"float64)")
    R = res.point.shape[0]
    dev = res.point.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the shading kernel runs on cuda or cpu, not {dev}")
    for name, dtype, shape in (("point", torch.float32, (R, 3)),
                               ("normal", torch.float32, (R, 3)),
                               ("hit", torch.bool, (R,)),
                               ("idx", torch.int32, (R,))):
        t = getattr(res, name)
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != dev):
            raise ValueError(f"res.{name} must be {dtype} {list(shape)} on "
                             f"{dev}, got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")
    n = len(table.spec)
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"scene has {n} spheres; the kernel takes "
                         f"1..{MAX_SPHERES}")
    if scene.num_spheres != n:
        raise ValueError(f"the table has {n} spheres, the scene "
                         f"{scene.num_spheres}")
    cols = [table.spheres, table.ids, scene.colour, scene.emitive,
            scene.transparent, scene.reflective, glights.vector,
            glights.colour, glights.strength, glights.max_angle, plights.id,
            plights.position, plights.colour, plights.strength,
            plights.max_angle, plights.func]
    if any(t.device != dev for t in cols):
        raise ValueError("the scene, its table and the lights must be on "
                         "the termini's device")


def whitted_shade(scene: Scene, glights: GlobalLights, plights: PointLights,
                  res, background, miss_colour=None,
                  table: Optional[SphereTable] = None) -> torch.Tensor:
    """The shading kernel on CUDA tensors; the plain version on CPU
    tensors.  ``res``: a ``TraceResult`` (``hit`` bool, ``idx`` int32,
    ``point``/``normal`` float32 ``[R, 3]``); ``background``,
    ``miss_colour`` (None: the background): three numbers each.  Returns
    ``[R, 3]`` float32 reference-unit RGB."""
    if table is None:
        table = sphere_table(scene)
    _check(scene, glights, plights, res, table)
    dev = res.point.device
    if dev.type == "cpu":
        return whitted_shade_plain(scene, glights, plights, res, background,
                                   miss_colour, table)
    f32, i32 = torch.float32, torch.int32

    def col(t, dtype=f32):
        return t.to(dtype).contiguous()    # no copy where it is already so

    bg = [float(b) for b in background]
    miss = bg if miss_colour is None else [float(c) for c in miss_colour]
    R = res.point.shape[0]
    hit, idx = res.hit.contiguous(), res.idx.contiguous()
    point, normal = res.point.contiguous(), res.normal.contiguous()
    mats = [col(scene.colour), col(scene.emitive), col(scene.transparent),
            col(scene.reflective)]
    gl = [col(glights.vector), col(glights.colour), col(glights.strength),
          col(glights.max_angle)]
    pl = [col(plights.id, i32), col(plights.position), col(plights.colour),
          col(plights.strength), col(plights.max_angle),
          col(plights.func, i32)]
    rgb = torch.empty((R, 3), dtype=f32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whitted_shade_launch(
            hit.data_ptr(), idx.data_ptr(), point.data_ptr(),
            normal.data_ptr(), table.spheres.data_ptr(),
            table.ids.data_ptr(), len(table.spec),
            *(t.data_ptr() for t in mats), *(t.data_ptr() for t in gl),
            glights.count, *(t.data_ptr() for t in pl), plights.count,
            *bg, *miss, R, rgb.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"whitted_shade kernel launch failed: CUDA error "
                           f"{err}")
    whitted_shade.launches += 1
    return rgb


whitted_shade.launches = 0      # kernel launches in this process


def _library() -> ctypes.CDLL:
    lib = native.load("whitted_shade").lib
    fn = lib.whitted_shade_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 6 + [i] + [p] * 8 + [i] + [p] * 6 + [i]
                       + [f] * 6 + [ctypes.c_longlong, p, p])
        fn.restype = ctypes.c_int
    return lib
