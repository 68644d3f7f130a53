"""Whole-trace path kernel: wrapper, launch count and plain version.

Replaces ``raytracer_tpu/core/pallas_path.py::_kernel`` (unguided branch,
reached through ``trace_path_pallas_impl``).  The CUDA kernel is
``csrc/path_trace.cu``; its note says what bounds it on an H100 and what
its design does about that.

``path_trace`` launches the kernel for CUDA tensors and raises on anything
it does not take; for CPU tensors, and only for them, it runs
``path_trace_plain``, the same function in plain PyTorch with the op order
of ``raytracer_tpu/trace/path.py::_trace_path_lean_impl``.  Both take
unnormalised directions and normalise them first, and both return
``rgb [R, 3]`` float32 (integer-valued) and per-ray counts ``[R, 4]``
int32: levels running (plus one for a ray still running after the last
level, as the reference counts it), hits, emissive hits, small-light hits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence

import torch

from . import native, vec
from .intersect import nearest_hit_c
from ..trace.path import _direct_lighting_c
from ..trace.sampling import local_to_world_c

# Compile-time capacities of csrc/path_trace.cu (kMaxSpheres, kMaxEmissive,
# kMaxBounces): the wrapper raises above them.
MAX_SPHERES = 64
MAX_EMISSIVE = 64
MAX_BOUNCES = 16
FLAG_EMISSIVE, FLAG_SMALL, FLAG_MIRROR = 1, 2, 4
SMALL_LIGHT_RADIUS = 0.5    # small light: emissive with radius < 0.5


@dataclasses.dataclass(frozen=True)
class PathTable:
    """The scene as the path kernel reads it.

    ``spec``: ``scene_spec`` rows (Python floats, exact float32 values);
    ``spheres [N, 7]`` float32 ``cx cy cz r colr colg colb``; ``flags [N]``
    int32 bits (emissive, small light, mirror at ``mirror_threshold``);
    ``emissive [E]`` int32 indices of the emissive spheres, ascending."""
    spec: tuple
    emissive_idx: tuple
    mirror_threshold: float
    spheres: torch.Tensor
    flags: torch.Tensor
    emissive: torch.Tensor


def _flag_lists(spec, mirror_threshold):
    """Per-sphere (emissive, small light, mirror) Python bools."""
    em = [row[9] > 0 for row in spec]
    sm = [e and row[3] < SMALL_LIGHT_RADIUS for e, row in zip(em, spec)]
    mr = [row[7] > mirror_threshold for row in spec]
    return em, sm, mr


def path_table(spec: Sequence[tuple], emissive_idx: Sequence[int],
               mirror_threshold: float, device) -> PathTable:
    spec = tuple(spec)
    em, sm, mr = _flag_lists(spec, mirror_threshold)
    flags = [FLAG_EMISSIVE * e + FLAG_SMALL * s + FLAG_MIRROR * m
             for e, s, m in zip(em, sm, mr)]
    return PathTable(
        spec, tuple(emissive_idx), float(mirror_threshold),
        spheres=torch.tensor([row[:7] for row in spec], dtype=torch.float32,
                             device=device).reshape(len(spec), 7),
        flags=torch.tensor(flags, dtype=torch.int32, device=device),
        emissive=torch.tensor(emissive_idx, dtype=torch.int32,
                              device=device))


def _check(origins, dirs, uniforms, table, max_bounces):
    for name, t in (("origins", origins), ("dirs", dirs)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.dim() != 2 or t.shape[1] != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [R, 3] tensor, "
                             f"got {tuple(t.shape)}")
    R = origins.shape[0]
    dev = origins.device
    if dirs.shape[0] != R or dirs.device != dev:
        raise ValueError("dirs must match origins in length and device")
    if not 1 <= max_bounces <= MAX_BOUNCES:
        raise ValueError(f"max_bounces must be in [1, {MAX_BOUNCES}], "
                         f"got {max_bounces}")
    if uniforms is not None:
        if uniforms.dtype != torch.float32 or uniforms.device != dev:
            raise TypeError("uniforms must be float32 on the rays' device")
        if (tuple(uniforms.shape) != (max_bounces, R, 2)
                or not uniforms.is_contiguous()):
            raise ValueError(f"uniforms must be a contiguous "
                             f"[{max_bounces}, {R}, 2] tensor, got "
                             f"{tuple(uniforms.shape)}")
    n, e = len(table.spec), len(table.emissive_idx)
    if not 1 <= n <= MAX_SPHERES or e > MAX_EMISSIVE:
        raise ValueError(f"scene has {n} spheres / {e} emissive; the kernel "
                         f"takes 1..{MAX_SPHERES} / at most {MAX_EMISSIVE}")
    for t in (table.spheres, table.flags, table.emissive):
        if t.device != dev:
            raise ValueError("scene table must be on the rays' device")


def path_trace(origins: torch.Tensor, dirs: torch.Tensor,
               uniforms: Optional[torch.Tensor], table: PathTable, *,
               max_bounces: int, background: Sequence[float],
               fast: bool = False):
    """The path kernel on CUDA tensors; the plain version on CPU tensors.

    ``uniforms``: ``[max_bounces, R, 2]`` float32, or None when no diffuse
    bounce is possible (a diffuse lane then reflects, as in the JAX
    tracers).  Returns ``(rgb [R, 3] float32, counts [R, 4] int32)``."""
    _check(origins, dirs, uniforms, table, max_bounces)
    dev = origins.device
    if dev.type == "cpu":
        return path_trace_plain(origins, dirs, uniforms, table,
                                max_bounces=max_bounces,
                                background=background, fast=fast)
    if dev.type != "cuda":
        raise ValueError(f"path_trace runs on cuda or cpu, not {dev}")
    lib = _library()
    R = origins.shape[0]
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((R, 4), dtype=torch.int32, device=dev)
    bg = [float(b) for b in background]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.path_trace_launch(
            origins.data_ptr(), dirs.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            table.spheres.data_ptr(), table.flags.data_ptr(),
            table.emissive.data_ptr(), len(table.spec),
            len(table.emissive_idx), R, max_bounces, bg[0], bg[1], bg[2],
            int(fast), rgb.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"path_trace kernel launch failed: CUDA error "
                           f"{err}")
    path_trace.launches += 1
    return rgb, counts


path_trace.launches = 0      # kernel launches in this process


def _library() -> ctypes.CDLL:
    lib = native.load("path_trace").lib
    fn = lib.path_trace_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, ctypes.c_longlong, i,
                       f, f, f, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def path_trace_plain(origins: torch.Tensor, dirs: torch.Tensor,
                     uniforms: Optional[torch.Tensor], table: PathTable, *,
                     max_bounces: int, background: Sequence[float],
                     fast: bool = False):
    """Plain PyTorch version of the kernel, on any device: the lean
    tracer's levels and reverse fold, op for op."""
    rows = table.spec
    em_flags, sm_flags, mr_flags = _flag_lists(rows, table.mirror_threshold)
    extra_vals = [([row[4] for row in rows], False),
                  ([row[5] for row in rows], False),
                  ([row[6] for row in rows], False),
                  (em_flags, True), (sm_flags, True), (mr_flags, True)]
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = vec.normalise_safe_c(dirs[:, 0], dirs[:, 1], dirs[:, 2])
    running = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    counts = torch.zeros((ox.shape[0], 4), dtype=torch.int32,
                         device=ox.device)
    levels = []
    for lvl in range(max_bounces):
        h = nearest_hit_c(ox, oy, oz, dx, dy, dz, rows, extra_vals,
                          fast=fast)
        px, py, pz, nx, ny, nz = h.px, h.py, h.pz, h.nx, h.ny, h.nz
        ar, ag, ab, em, sm, mr = h.extras
        found = running & h.found
        emis = found & em
        mirror = found & ~emis & mr
        diffuse = found & ~emis & ~mirror
        cont = mirror | diffuse

        dr, dg, db = _direct_lighting_c(rows, table.emissive_idx, px, py, pz,
                                        nx, ny, nz, h.idx, fast)
        rlx, rly, rlz = vec.reflect_c(dx, dy, dz, nx, ny, nz)
        if uniforms is None:
            dfx, dfy, dfz = rlx, rly, rlz
        else:
            u = uniforms[lvl]
            theta = torch.acos(vec.sqrt(u[:, 0]))
            phi = 2.0 * math.pi * u[:, 1]
            dfx, dfy, dfz = local_to_world_c(theta, phi, nx, ny, nz)

        ox = torch.where(cont, px + nx * 0.001, ox)
        oy = torch.where(cont, py + ny * 0.001, oy)
        oz = torch.where(cont, pz + nz * 0.001, oz)
        dx = torch.where(cont, torch.where(mirror, rlx, dfx), dx)
        dy = torch.where(cont, torch.where(mirror, rly, dfy), dy)
        dz = torch.where(cont, torch.where(mirror, rlz, dfz), dz)

        miss = running & ~emis & ~cont
        levels.append((emis, cont, miss, ar, ag, ab, dr, dg, db))
        counts += torch.stack([running, found, emis, found & sm], dim=1)
        running = running & cont
    # A ray still running after the last level makes one more trace() call
    # that the reference counts before its bounce-budget return.
    counts[:, 0] += running

    # Reverse fold, deepest level first.
    bg = [float(b) for b in background]
    vr = torch.full_like(ox, bg[0])
    vg = torch.full_like(ox, bg[1])
    vb = torch.full_like(ox, bg[2])
    for emis, cont, miss, ar, ag, ab, dr, dg, db in reversed(levels):
        cr = torch.trunc(vec.div_scalar(ar * torch.clamp_max(dr + vr, 255.0),
                                        255.0))
        cg = torch.trunc(vec.div_scalar(ag * torch.clamp_max(dg + vg, 255.0),
                                        255.0))
        cb = torch.trunc(vec.div_scalar(ab * torch.clamp_max(db + vb, 255.0),
                                        255.0))
        vr = torch.where(cont, cr, vr)
        vg = torch.where(cont, cg, vg)
        vb = torch.where(cont, cb, vb)
        vr = torch.where(emis, ar, vr)
        vg = torch.where(emis, ag, vg)
        vb = torch.where(emis, ab, vb)
        vr = torch.where(miss, bg[0], vr)
        vg = torch.where(miss, bg[1], vg)
        vb = torch.where(miss, bg[2], vb)
    return torch.stack([vr, vg, vb], dim=-1), counts
