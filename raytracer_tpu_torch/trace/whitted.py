"""Wavefront Whitted tracer: the reference's recursive
``Ray.nearestSphereIntersect`` (RL/ray.py:160-231) over ``[R]`` rays.

Counterpart of ``raytracer_tpu/trace/whitted.py::trace_whitted``.  Per
level, for every active ray: the nearest hit by signed t with the
previous sphere's id suppressed; no hit or ``bounces > max_bounces`` ends
the chain with the deepest mirror hit (the reflective fallback) or none;
``reflective == 1.0`` (the reference's ``== True``) bounces and records the
fallback; ``transparent == 1.0`` walks through the sphere (refract in, at
most 10 internal reflections, refract out) or, trapped, ends like a miss;
anything else is the terminal hit handed to shading.  ``max_bounces + 2``
levels.

``impl="kernel"`` runs ``core/cuda_whitted.py::whitted_trace`` (the CUDA
kernel on a card, its plain version for CPU tensors; float32, camera entry
only); ``impl="plain"`` runs the plain level loop
(``whitted_trace_plain``) wherever the tensors are, in float32 or float64,
and may resume a chain (``bounces0``/``through0``).  ``sweep="kernel"``
sends each plain level's sweep through the nearest-hit kernel
(``core/cuda_intersect.py``), as ``use_pallas=True`` does in JAX.
``impl="compact"`` (JAX ``trace_whitted_compact``) runs the plain level
on the live lanes only, compacted between levels
(``whitted_trace_compact``): its sweep is the nearest-hit kernel for rays
on ``cuda`` and the plain sweep on the CPU, and every field equals
``impl="plain"``'s bit for bit.  It is JAX's API, kept for parity: on the
card ``impl="kernel"`` traces the same frame several times faster
(PERF.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import vec
from ..core.intersect import single_sphere_exit_c
from ..scene.types import Scene

# Status codes of a ray lane.
ACTIVE = 0
DONE_HIT = 1    # terminal intersection recorded in the result
DONE_NONE = 2   # chain failed with no reflective fallback: background

WALK_STEPS = 10


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """The reference ``Intersection`` terminus of each ray."""

    hit: torch.Tensor       # [R] bool: a terminal surface was found
    idx: torch.Tensor       # [R] i32: sphere index of the terminus
    point: torch.Tensor     # [R, 3]
    normal: torch.Tensor    # [R, 3]
    t: torch.Tensor         # [R]: the terminus's own segment distance
    bounces: torch.Tensor   # [R] i32: recursion depth at the terminus
    through: torch.Tensor   # [R] i32: transparent spheres passed through


def _refract_walk_c(dx, dy, dz, nhx, nhy, nhz, phx, phy, phz,
                    cx, cy, cz, radius, ior, relevant=None, counters=None):
    """``sphereExitRay`` (RL/ray.py:109-157), component form.

    Returns ``(ok, epx, epy, epz, edx, edy, edz)``; ``ok`` is False where
    the ray is still trapped after 10 internal reflections, or where the
    entry refraction itself reflects totally.  The loop stops as soon as
    every ``relevant`` lane has exited; a lane that has exited is frozen.
    ``counters``: optional dict; ``walk_steps`` and ``walk_exits`` gain the
    relevant lanes' refraction attempts and exits."""
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    rdx, rdy, rdz, tir_in = vec.refract_c(dx, dy, dz, nhx, nhy, nhz, one,
                                          ior)
    _, epx, epy, epz, enx, eny, enz = single_sphere_exit_c(
        phx, phy, phz, rdx, rdy, rdz, cx, cy, cz, radius)
    exited = torch.zeros_like(dx, dtype=torch.bool)
    rel = torch.ones_like(exited) if relevant is None else relevant
    zeros = torch.zeros_like(dx)
    opx = opy = opz = odx = ody = odz = zeros
    for _ in range(WALK_STEPS):
        if bool((exited | ~rel).all()):
            break
        if counters is not None:
            counters["walk_steps"] += int((~exited & rel).sum())
        exdx, exdy, exdz, tir = vec.refract_c(rdx, rdy, rdz,
                                              -enx, -eny, -enz, ior, one)
        newly = ~exited & ~tir
        if counters is not None:
            counters["walk_exits"] += int((newly & rel).sum())
        opx = torch.where(newly, epx, opx)
        opy = torch.where(newly, epy, opy)
        opz = torch.where(newly, epz, opz)
        odx = torch.where(newly, exdx, odx)
        ody = torch.where(newly, exdy, ody)
        odz = torch.where(newly, exdz, odz)
        exited = exited | newly
        # Total internal reflection: reflect and find the next exit point.
        rlx, rly, rlz = vec.reflect_c(rdx, rdy, rdz, enx, eny, enz)
        _, npx, npy, npz, nnx, nny, nnz = single_sphere_exit_c(
            epx, epy, epz, rlx, rly, rlz, cx, cy, cz, radius)
        still = ~exited
        rdx = torch.where(still, rlx, rdx)
        rdy = torch.where(still, rly, rdy)
        rdz = torch.where(still, rlz, rdz)
        epx = torch.where(still, npx, epx)
        epy = torch.where(still, npy, epy)
        epz = torch.where(still, npz, epz)
        enx = torch.where(still, nnx, enx)
        eny = torch.where(still, nny, eny)
        enz = torch.where(still, nnz, enz)
    ok = exited & ~tir_in
    return ok, opx, opy, opz, odx, ody, odz


def trace_whitted(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor,
                  max_bounces: int = 1,
                  suppress_id: Optional[torch.Tensor] = None,
                  bounces0: Optional[torch.Tensor] = None,
                  through0: Optional[torch.Tensor] = None,
                  enable_glass: bool = True, enable_mirror: bool = True, *,
                  impl: str = "kernel", sweep: str = "plain",
                  precision: str = "exact",
                  min_bucket: int = 1024, table=None) -> TraceResult:
    """Trace ``[R]`` rays to their Whitted termini.

    ``origins``/``dirs`` ``[R, 3]`` in the scene's float dtype, on its
    device (dirs need not be normalised).  ``suppress_id``, ``bounces0``,
    ``through0`` resume a chain mid-way (``impl="plain"`` only for the
    last two).  ``enable_glass``/``enable_mirror`` False treat the
    scene's glass / mirror spheres as terminal (``material_flags`` says
    when a scene has none).  ``precision="fast"``: the ``d2 <= r*r`` hit
    test of the TPU kernels in place of ``sqrt(d2) <= r``.
    ``min_bucket``: the smallest compacted wavefront (``"compact"``).
    ``table``: the scene's ``cuda_intersect.sphere_table(scene,
    enable_glass, enable_mirror)`` where the caller has built it (to shade
    with it too); the flags then go unread."""
    if max_bounces < 0:
        raise ValueError(f"max_bounces must be >= 0, got {max_bounces}")
    if impl not in ("kernel", "plain", "compact"):
        raise ValueError(f"unknown impl {impl!r}")
    if sweep not in ("kernel", "plain"):
        raise ValueError(f"unknown sweep {sweep!r}")
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    if impl == "compact" and sweep != "plain":
        raise ValueError("impl='compact' picks its sweep by the rays' "
                         "device; sweep='kernel' goes with impl='plain'")
    if impl == "kernel" and (bounces0 is not None or through0 is not None
                             or sweep != "plain"):
        raise ValueError("the Whitted kernel traces from the camera entry: "
                         "bounces0, through0 and sweep='kernel' need "
                         "impl='plain'")
    # Imported here: both modules import this one.
    from ..core import cuda_intersect, cuda_whitted
    dev = scene.device
    dtype = scene.radius.dtype
    if origins.dtype != dtype:
        raise ValueError(f"rays are {origins.dtype} but the scene is "
                         f"{dtype}: cast both (scene_astype)")
    origins = origins.to(dev).contiguous()
    dirs = dirs.to(dev, dtype).contiguous()
    if suppress_id is not None:
        suppress_id = suppress_id.to(dev, torch.int32).contiguous()
    if table is None:
        table = cuda_intersect.sphere_table(scene, enable_glass,
                                            enable_mirror)
    kw = dict(max_bounces=max_bounces, fast=precision == "fast")
    if impl == "kernel":
        return cuda_whitted.whitted_trace(origins, dirs, suppress_id, table,
                                          **kw)
    if impl == "compact":
        return cuda_whitted.whitted_trace_compact(
            origins, dirs, suppress_id, table, bounces0=bounces0,
            through0=through0, min_bucket=min_bucket,
            sweep="kernel" if dev.type == "cuda" else "plain", **kw)
    return cuda_whitted.whitted_trace_plain(
        origins, dirs, suppress_id, table, bounces0=bounces0,
        through0=through0, sweep=sweep, **kw)
