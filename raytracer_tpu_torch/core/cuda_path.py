"""Whole-trace path kernel: wrapper, launch count and plain version.

Replaces ``raytracer_tpu/core/pallas_path.py::_kernel``, unguided and
guided (reached through ``trace_path_pallas_impl``; the guided branch runs
the distilled student inside the kernel, ``_student_mlp``).  Three routes,
each a CUDA kernel whose note says what bounds it on an H100 and what its
design does about that (``guided_route`` picks):

* unguided: ``csrc/path_trace.cu``;
* a bf16 student (``dtype="auto"``, the deployed mode): ``csrc/
  path_guided.cu``, the student on the tensor cores (``csrc/
  student_mma.cuh``) over the guided lanes of a warp, packed together;
* an f32 student (``dtype=None``): ``csrc/path_trace.cu`` with the scalar
  student of ``csrc/student.cuh``.

``path_trace`` launches the kernel for CUDA tensors and raises on anything
it does not take; for CPU tensors, and only for them, it runs
``path_trace_plain``, the same function in plain PyTorch with the op order
of ``raytracer_tpu/trace/path.py::_trace_path_lean_impl``.  Both take
unnormalised directions and normalise them first, and both return
``rgb [R, 3]`` float32 (integer-valued) and per-ray counts ``[R, 4]``
int32: levels running (plus one for a ray still running after the last
level, as the reference counts it), hits, emissive hits, small-light hits;
guided, ``[R, 6]`` with the guided bounces and, for a ray that ended on a
light, its guided bounces again (``fb_success``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import weakref
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import cuda_intersect, native, vec
from .cuda_intersect import SphereTable
from .intersect import NearestHitC, inside_threshold, nearest_hit_c
from ..trace.path import _direct_lighting_c, is_student, observation_c
from ..trace.sampling import fb_action_to_direction_c, local_to_world_c

# Compile-time capacities of csrc/path_common.cuh and path_trace.cu
# (kMaxSpheres, kMaxEmissive, kMaxBounces) and csrc/student.cuh
# (kMaxWidth, at most two hidden layers): the wrappers raise above them.
MAX_SPHERES = 64
MAX_EMISSIVE = 64
MAX_BOUNCES = 16
MAX_STUDENT_WIDTH = 128
MAX_STUDENT_HIDDEN = 2
# csrc/student_mma.cuh: the observation padded to two k-steps of 16, the
# output layer to one n-tile of 8.
MMA_OBS_PAD, MMA_OUT_PAD = 32, 8
OBS_DIM, ACTION_DIM = 22, 2
FLAG_EMISSIVE, FLAG_SMALL, FLAG_MIRROR = 1, 2, 4
SMALL_LIGHT_RADIUS = 0.5    # small light: emissive with radius < 0.5
# csrc/path_common.cuh's light culls: the far cut's margin over
# 0.3 * max |colour|, and the least squared distance either cull takes.
LIGHT_CUT_MARGIN = 2.0 ** -10
CULL_MIN_D2 = 2.0 ** -60
# Level state bits (csrc/path_level.cu).
ST_RUNNING, ST_FOUND, ST_EMISSIVE, ST_SMALL, ST_MIRROR, ST_CONT = (
    1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class PathTable:
    """The scene as the path kernels read it.

    ``spec``: ``scene_spec`` rows (Python floats, exact float32 values);
    ``spheres [N, 12]`` float32 ``cx cy cz r colr colg colb refl transp
    emit ior id`` (the material columns feed the guide's observation);
    ``flags [N]`` int32 bits (emissive, small light, mirror at
    ``mirror_threshold``); ``emissive [E]`` int32 indices of the emissive
    spheres, ascending; ``inside [N]`` float32, each radius's
    ``inside_threshold``; ``light_cut [E]`` float32, each emissive
    sphere's ``light_cut``.  The plain versions read ``spec`` and
    ``emissive_idx``; the kernels read the tensors."""
    spec: tuple
    emissive_idx: tuple
    mirror_threshold: float
    spheres: torch.Tensor
    flags: torch.Tensor
    emissive: torch.Tensor
    inside: torch.Tensor
    light_cut: torch.Tensor


def light_cut(colours) -> np.ndarray:
    """Each light's far cut on ``d2``, float32: ``0.3 * max |colour| * (1 +
    LIGHT_CUT_MARGIN)``, at least ``CULL_MIN_D2``; ``+inf`` where a colour
    is not finite.  Past it ``trunc(w * colour)`` is +-0 in every channel
    (the argument is in ``csrc/path_common.cuh::direct_light``).
    ``colours [E, 3]``."""
    c = np.abs(np.asarray(colours, dtype=np.float64).reshape(-1, 3))
    with np.errstate(invalid="ignore"):
        cut = np.maximum(0.3 * c.max(axis=1, initial=0.0)
                         * (1.0 + LIGHT_CUT_MARGIN), CULL_MIN_D2)
    cut = np.where(np.isfinite(c).all(axis=1), cut, np.inf)
    return cut.astype(np.float32)


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
    rows = np.array([row[:12] for row in spec],
                    dtype=np.float32).reshape(len(spec), 12)
    emissive_idx = tuple(emissive_idx)
    return PathTable(
        spec, emissive_idx, float(mirror_threshold),
        spheres=torch.from_numpy(rows).to(device),
        flags=torch.tensor(flags, dtype=torch.int32, device=device),
        emissive=torch.tensor(emissive_idx, dtype=torch.int32,
                              device=device),
        inside=torch.from_numpy(inside_threshold(rows[:, 3])).to(device),
        light_cut=torch.from_numpy(light_cut(
            rows[list(emissive_idx), 4:7])).to(device))


def check_rays(origins, dirs, table):
    """The checks every path wrapper makes on rays and table."""
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
    n, e = len(table.spec), len(table.emissive_idx)
    if not 1 <= n <= MAX_SPHERES or e > MAX_EMISSIVE:
        raise ValueError(f"scene has {n} spheres / {e} emissive; the kernel "
                         f"takes 1..{MAX_SPHERES} / at most {MAX_EMISSIVE}")
    for t in (table.spheres, table.flags, table.emissive, table.inside,
              table.light_cut):
        if t.device != dev:
            raise ValueError("scene table must be on the rays' device")


def check_plane(name, t, shape, dtype, dev):
    if t.dtype != dtype or t.device != dev:
        raise TypeError(f"{name} must be {dtype} on the rays' device")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {list(shape)} tensor, "
                         f"got {tuple(t.shape)}")


def _check(origins, dirs, uniforms, table, max_bounces, guide, fb_uniforms):
    check_rays(origins, dirs, table)
    R, dev = origins.shape[0], origins.device
    if not 1 <= max_bounces <= MAX_BOUNCES:
        raise ValueError(f"max_bounces must be in [1, {MAX_BOUNCES}], "
                         f"got {max_bounces}")
    if uniforms is not None:
        check_plane("uniforms", uniforms, (max_bounces, R, 2), torch.float32,
                    dev)
    if guide is not None:
        student_dims(guide)
        if uniforms is None:
            raise ValueError("a guided trace needs the uniforms")
        if fb_uniforms is None:
            raise ValueError("a guided trace needs fb_uniforms "
                             f"[{max_bounces}, {R}]")
        check_plane("fb_uniforms", fb_uniforms, (max_bounces, R),
                    torch.float32, dev)


def student_dims(guide):
    """``(n_hidden, h1, h2)`` of a student the kernel takes (widths padded
    to multiples of 8); raises ValueError for anything else."""
    if not is_student(guide):
        raise ValueError("the path kernels take distilled-student guides "
                         "only (fb.distill.DistilledGuide.as_guide_fn)")
    if guide.dtype not in ("bfloat16", None):
        raise ValueError(f"student dtype {guide.dtype!r}: the kernel takes "
                         "bfloat16 or f32 (None)")
    layers = guide.layers
    hidden = [k.shape[1] for k, _ in layers[:-1]]
    if (not 1 <= len(hidden) <= MAX_STUDENT_HIDDEN
            or layers[0][0].shape[0] != OBS_DIM
            or layers[-1][0].shape[1] != ACTION_DIM
            or any(not 1 <= h <= MAX_STUDENT_WIDTH for h in hidden)):
        raise ValueError(
            f"student {OBS_DIM}->{'->'.join(map(str, hidden))}->"
            f"{layers[-1][0].shape[1]} from {layers[0][0].shape[0]} inputs: "
            f"the kernel takes {OBS_DIM} inputs, {ACTION_DIM} outputs and "
            f"1..{MAX_STUDENT_HIDDEN} hidden layers of at most "
            f"{MAX_STUDENT_WIDTH} units")
    pad = [-(-h // 8) * 8 for h in hidden]
    return len(hidden), pad[0], pad[1] if len(pad) == 2 else 0


def student_dims_mma(guide):
    """``(n_hidden, h1, h2)`` of a student for the tensor-core route: the
    widths padded to multiples of 16, the depth of an m16n8k16 k-step."""
    n_hidden, h1, h2 = student_dims(guide)
    return n_hidden, -(-h1 // 16) * 16, -(-h2 // 16) * 16


def guided_route(guide) -> str:
    """The kernel a student takes: ``"bf16_mma"`` (``csrc/path_guided.cu``)
    for a bf16 student, ``"f32"`` (``csrc/path_trace.cu`` with
    ``csrc/student.cuh``) for an f32 one; raises for anything else."""
    student_dims(guide)
    return "bf16_mma" if guide.dtype == "bfloat16" else "f32"


_PACKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PACKED_MMA: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def pack_student(guide, device) -> torch.Tensor:
    """The student in ``csrc/student.cuh``'s layout, float32 on ``device``
    (cached per guide and device): each layer's kernel ``[in, out]`` with
    ``out`` padded by zero units to a multiple of 8 (the output layer to 8)
    and ``in`` to the previous layer's padded width, then its bias."""
    per_dev = _PACKED.setdefault(guide, {})
    device = torch.device(device)
    if device not in per_dev:
        n_hidden, h1, h2 = student_dims(guide)
        outs = [h1, h2][:n_hidden] + [8]
        parts, rows = [], OBS_DIM
        for (k, b), out in zip(guide.layers, outs):
            kp = torch.zeros((rows, out), dtype=torch.float32)
            kp[:k.shape[0], :k.shape[1]] = k
            bp = torch.zeros(out, dtype=torch.float32)
            bp[:b.shape[0]] = b
            parts += [kp.reshape(-1), bp]
            rows = out
        per_dev[device] = torch.cat(parts).to(device)
    return per_dev[device]


def pack_student_mma(guide, device) -> torch.Tensor:
    """A bf16 student in ``csrc/student_mma.cuh``'s layout, bfloat16 on
    ``device`` (cached per guide and device): each layer's kernel ``[K,
    N]``, ``K`` padded with zero rows (22 to 32, a hidden width to the
    previous layer's padded width) and ``N`` with zero units (a hidden
    width to a multiple of 16, the output to 8), stored in 8-wide k-chunks
    (element ``(k, n)`` at ``((k // 8) * N + n) * 8 + k % 8``, the order
    ``ldmatrix`` reads), then its bias ``[N]``."""
    if guided_route(guide) != "bf16_mma":
        raise ValueError(f"student dtype {guide.dtype!r}: the tensor-core "
                         "route takes bfloat16 students only")
    per_dev = _PACKED_MMA.setdefault(guide, {})
    device = torch.device(device)
    if device not in per_dev:
        n_hidden, h1, h2 = student_dims_mma(guide)
        outs = [h1, h2][:n_hidden] + [MMA_OUT_PAD]
        parts, rows = [], MMA_OBS_PAD
        for (k, b), out in zip(guide.layers, outs):
            kp = torch.zeros((rows, out), dtype=torch.float32)
            kp[:k.shape[0], :k.shape[1]] = k
            bp = torch.zeros(out, dtype=torch.float32)
            bp[:b.shape[0]] = b
            parts += [kp.reshape(rows // 8, 8, out).transpose(1, 2)
                      .reshape(-1), bp]
            rows = out
        # The layers hold bf16 values already: the cast is exact.
        per_dev[device] = torch.cat(parts).to(torch.bfloat16).to(device)
    return per_dev[device]


def student_args(guide, route: str, device) -> tuple:
    """The student's launch arguments on a route: its packing's pointer
    (cached per guide and device, so it outlives the launch) and dims;
    ``(None, 0, 0, 0)`` unguided."""
    if route == "bf16_mma":
        return (pack_student_mma(guide, device).data_ptr(),
                *student_dims_mma(guide))
    if route == "f32":
        return pack_student(guide, device).data_ptr(), *student_dims(guide)
    return None, 0, 0, 0


def path_trace(origins: torch.Tensor, dirs: torch.Tensor,
               uniforms: Optional[torch.Tensor], table: PathTable, *,
               max_bounces: int, background: Sequence[float],
               fast: bool = False, guide=None,
               fb_uniforms: Optional[torch.Tensor] = None,
               fb_prob: float = 1.0):
    """The path kernel on CUDA tensors; the plain version on CPU tensors.

    ``uniforms``: ``[max_bounces, R, 2]`` float32, or None when no diffuse
    bounce is possible (a diffuse lane then reflects, as in the JAX
    tracers).  ``guide``: a distilled student (``StudentGuide``, at most
    two hidden layers of at most 128 units), with ``fb_uniforms
    [max_bounces, R]`` float32 and ``fb_prob``; a bf16 student runs on the
    tensor cores, an f32 one as scalar multiply-adds (``guided_route``).
    Returns ``(rgb [R, 3] float32, counts [R, 4] int32)``, guided ``[R,
    6]``."""
    _check(origins, dirs, uniforms, table, max_bounces, guide, fb_uniforms)
    dev = origins.device
    kw = dict(max_bounces=max_bounces, background=background, fast=fast,
              guide=guide, fb_uniforms=fb_uniforms, fb_prob=fb_prob)
    if dev.type == "cpu":
        return path_trace_plain(origins, dirs, uniforms, table, **kw)
    if dev.type != "cuda":
        raise ValueError(f"path_trace runs on cuda or cpu, not {dev}")
    R = origins.shape[0]
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((R, 6 if guide is not None else 4),
                         dtype=torch.int32, device=dev)
    route = "unguided" if guide is None else guided_route(guide)
    bg = [float(b) for b in background]
    head = (origins.data_ptr(), dirs.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            None if fb_uniforms is None else fb_uniforms.data_ptr(),
            float(fb_prob), table.spheres.data_ptr(), table.flags.data_ptr(),
            table.emissive.data_ptr(), table.inside.data_ptr(),
            table.light_cut.data_ptr(), len(table.spec),
            len(table.emissive_idx), R, max_bounces, bg[0], bg[1], bg[2],
            int(fast))
    sargs = student_args(guide, route, dev)
    tail = (rgb.data_ptr(), counts.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "bf16_mma":
            next_tile = torch.zeros(1, dtype=torch.int64, device=dev)
            err = _library("path_guided").path_guided_launch(
                *head, *sargs, *tail, next_tile.data_ptr(), stream)
        else:
            err = _library("path_trace").path_trace_launch(
                *head, *sargs, *tail, stream)
    if err != 0:
        raise RuntimeError(f"path_trace kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    path_trace.launches += 1
    path_trace.route_launches[route] += 1
    return rgb, counts


path_trace.launches = 0      # kernel launches in this process, all routes
# ... and by route (guided_route; "unguided" without a student).
path_trace.route_launches = {"unguided": 0, "f32": 0, "bf16_mma": 0}


# Each library's C functions and their argument types, one letter each:
# p pointer, i int, f float, L long long, l / n pointers to long long / int.
_SIGNATURES = {
    "path_trace": {"path_trace_launch": "ppppfpppppiiLifffipiiippp"},
    "path_guided": {"path_guided_launch": "ppppfpppppiiLifffipiiipppp",
                    "path_guided_occupancy": "iiiln"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "L": ctypes.c_longlong,
           "l": ctypes.POINTER(ctypes.c_longlong),
           "n": ctypes.POINTER(ctypes.c_int)}


def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, its functions typed."""
    lib = native.load(name).lib
    for fn_name, sig in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
    return lib


def guided_occupancy(guide) -> dict:
    """The tensor-core route's launch for this bf16 student on the current
    card: dynamic shared memory a block and resident blocks an SM."""
    smem, per_sm = ctypes.c_longlong(0), ctypes.c_int(0)
    err = _library("path_guided").path_guided_occupancy(
        *student_dims_mma(guide), ctypes.byref(smem), ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"path_guided occupancy query: CUDA error {err}")
    return {"dynamic_smem_bytes": smem.value, "blocks_per_sm": per_sm.value}


class Level(NamedTuple):
    """One bounce level, every lane (``csrc/path_level.cu``'s outputs).
    ``state [R]`` uint8 bits (``ST_*``); ``rec [R, 6]`` albedo (found
    lanes) and direct light (continuing lanes); ``o_next``/``d_next [R,
    3]``: the offset origin and the mirror or cosine direction on
    continuing lanes, the input ray elsewhere; ``hit [R, 11]`` or None:
    point, normal, reflective, transparent, emitive, ior and id on
    continuing lanes.  Zeros where unset."""
    state: torch.Tensor
    rec: torch.Tensor
    o_next: torch.Tensor
    d_next: torch.Tensor
    hit: Optional[torch.Tensor]


def level_plain(o: torch.Tensor, d: torch.Tensor, running: torch.Tensor,
                u: Optional[torch.Tensor], table: PathTable, *,
                fast: bool = False, want_hit: bool = False) -> Level:
    """One bounce level in plain PyTorch, the lean tracer's op order (and
    ``csrc/path_common.cuh``'s): sweep, direct light, reflection, cosine
    bounce from ``u [R, 2]`` (None: none possible), offset origin.  ``d``:
    unit directions; ``running [R]`` bool."""
    ox, oy, oz, dx, dy, dz = o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], \
        d[:, 2]
    rows = table.spec
    em_flags, sm_flags, mr_flags = _flag_lists(rows, table.mirror_threshold)
    extra_vals = [([row[c] for row in rows], False) for c in range(4, 7)] + [
        (em_flags, True), (sm_flags, True), (mr_flags, True)] + [
        ([float(row[c]) for row in rows], False) for c in range(7, 12)]
    h = nearest_hit_c(ox, oy, oz, dx, dy, dz, rows, extra_vals, fast=fast)
    return _finish_level(o, d, running, u, table, h, fast, want_hit)


def level_stepwise(o: torch.Tensor, d: torch.Tensor, running: torch.Tensor,
                   u: Optional[torch.Tensor], table: PathTable, *,
                   sweep: SphereTable, fast: bool = False,
                   want_hit: bool = False) -> Level:
    """One bounce level of JAX ``_level_kernel`` with ``use_pallas=True``
    (``raytracer_tpu/trace/path.py:692-775``): the sweep is one
    ``cuda_intersect.nearest_hit`` call on ``sweep`` (``|t|``, nothing
    suppressed: the kernel on CUDA tensors, ``nearest_hit_plain`` on the
    CPU), the hit point ``o + d·t`` and the normal from the hit sphere's
    centre; the hit sphere's columns are gathered from ``table``, and the
    rest is ``level_plain``'s tensor ops.  Equal to ``level_plain`` bit for
    bit: the kernel returns the plain sweep's ``t``, index and found flag,
    and every column taken from the gather is masked by found or
    continuing, where it is the sweep's selection."""
    t, idx, found = cuda_intersect.nearest_hit(o, d, None, sweep,
                                               by_abs=True, fast=fast)
    i = idx.long()
    rows = table.spheres[i]                       # [R, 12] hit-sphere rows
    flags = table.flags[i]
    px, py, pz = (o[:, c] + d[:, c] * t for c in range(3))
    nx, ny, nz = vec.normalise_safe_c(px - rows[:, 0], py - rows[:, 1],
                                      pz - rows[:, 2])
    extras = ([rows[:, c] for c in range(4, 7)]
              + [(flags & f) != 0 for f in (FLAG_EMISSIVE, FLAG_SMALL,
                                            FLAG_MIRROR)]
              + [rows[:, c] for c in range(7, 12)])
    h = NearestHitC(found, idx, t, px, py, pz, nx, ny, nz, extras)
    return _finish_level(o, d, running, u, table, h, fast, want_hit)


def _finish_level(o, d, running, u, table: PathTable, h: NearestHitC,
                  fast: bool, want_hit: bool) -> Level:
    """The level after its sweep: ``h`` carries the hit and, in
    ``extras``, the hit sphere's albedo, emissive / small-light / mirror
    flags and material columns (refl, transp, emit, ior, id)."""
    ox, oy, oz, dx, dy, dz = o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], \
        d[:, 2]
    px, py, pz, nx, ny, nz = h.px, h.py, h.pz, h.nx, h.ny, h.nz
    ar, ag, ab, em, sm, mr = h.extras[:6]
    found = running & h.found
    emis = found & em
    mirror = found & ~emis & mr
    cont = mirror | (found & ~emis & ~mirror)

    dr, dg, db = _direct_lighting_c(table.spec, table.emissive_idx, px, py,
                                    pz, nx, ny, nz, h.idx, fast)
    rlx, rly, rlz = vec.reflect_c(dx, dy, dz, nx, ny, nz)
    if u is None:
        dfx, dfy, dfz = rlx, rly, rlz
    else:
        theta = torch.acos(vec.sqrt(u[:, 0]))
        phi = 2.0 * math.pi * u[:, 1]
        dfx, dfy, dfz = local_to_world_c(theta, phi, nx, ny, nz)
    o_next = torch.stack([torch.where(cont, p + n * 0.001, c) for p, n, c in
                          ((px, nx, ox), (py, ny, oy), (pz, nz, oz))], -1)
    d_next = torch.stack([torch.where(cont, torch.where(mirror, r, f), c)
                          for r, f, c in ((rlx, dfx, dx), (rly, dfy, dy),
                                          (rlz, dfz, dz))], -1)
    state = (running * ST_RUNNING + found * ST_FOUND + emis * ST_EMISSIVE
             + (found & sm) * ST_SMALL + mirror * ST_MIRROR
             + cont * ST_CONT).to(torch.uint8)
    rec = torch.stack([torch.where(found, c, 0.0) for c in (ar, ag, ab)]
                      + [torch.where(cont, c, 0.0) for c in (dr, dg, db)], -1)
    hit = None
    if want_hit:
        hit = torch.stack([torch.where(cont, c, 0.0) for c in
                           (px, py, pz, nx, ny, nz, *h.extras[6:])], -1)
    return Level(state, rec, o_next, d_next, hit)


def fold_levels(levels, background) -> torch.Tensor:
    """The reverse fold, deepest level first, over ``(state, rec)`` pairs:
    ``trunc(albedo · min(255, direct + child) / 255)`` on continuing
    lanes, the light's colour on emissive ones, the background on a miss.
    Returns ``rgb [R, 3]``."""
    bg = [float(b) for b in background]
    state = levels[0][0]
    v = [torch.full(state.shape, b, dtype=torch.float32,
                    device=state.device) for b in bg]
    for st, rec in reversed(levels):
        emis = (st & ST_EMISSIVE) != 0
        cont = (st & ST_CONT) != 0
        miss = ((st & ST_RUNNING) != 0) & ~emis & ~cont
        for c in range(3):
            a, dl = rec[:, c], rec[:, 3 + c]
            comb = torch.trunc(vec.div_scalar(
                a * torch.clamp_max(dl + v[c], 255.0), 255.0))
            v[c] = torch.where(cont, comb, v[c])
            v[c] = torch.where(emis, a, v[c])
            v[c] = torch.where(miss, bg[c], v[c])
    return torch.stack(v, dim=-1)


def trace_levels(level_fn, origins: torch.Tensor, dirs: torch.Tensor,
                 uniforms: Optional[torch.Tensor], table: PathTable, *,
                 max_bounces: int, background: Sequence[float],
                 fast: bool = False, guide=None,
                 fb_uniforms: Optional[torch.Tensor] = None,
                 fb_prob: float = 1.0,
                 guide_max_level: Optional[int] = None):
    """The tracer as a loop of ``level_fn`` calls (``level_plain``, the
    level kernel's wrapper for the hybrid, ``level_stepwise`` for the
    stepwise tracer), with the guide between levels and the reverse fold:
    the lean tracer's semantics.  ``guide`` may be any ``obs [R, 22] ->
    action [R, 2]`` callable; it runs on every lane's observation (the same
    product for every caller) and is taken where the lane is diffuse and
    its fb uniform is below ``fb_prob``.  ``guide_max_level=K``: levels
    ``>= K`` run no guide and bounce by cosine sampling on the same
    uniforms; ``fb_used`` counts the guided levels only.  No host
    synchronisation between levels.  Returns ``(rgb [R, 3], counts [R, 4
    or 6])``."""
    R, dev = origins.shape[0], origins.device
    o = origins
    d = torch.stack(vec.normalise_safe_c(dirs[:, 0], dirs[:, 1], dirs[:, 2]),
                    dim=-1)
    running = torch.ones(R, dtype=torch.bool, device=dev)
    guided = guide is not None
    counts = torch.zeros((R, 6 if guided else 4), dtype=torch.int32,
                         device=dev)
    term_emis = torch.zeros(R, dtype=torch.bool, device=dev)
    levels = []
    for lvl in range(max_bounces):
        guided_level = guided and (guide_max_level is None
                                   or lvl < guide_max_level)
        lv = level_fn(o, d, running, None if uniforms is None
                      else uniforms[lvl], table, fast=fast,
                      want_hit=guided_level)
        st = lv.state
        emis = (st & ST_EMISSIVE) != 0
        cont = (st & ST_CONT) != 0
        d_next = lv.d_next
        if guided_level:
            use_fb = (cont & ((st & ST_MIRROR) == 0)
                      & (fb_uniforms[lvl] < fb_prob))
            h = lv.hit
            obs = observation_c(h[:, 0], h[:, 1], h[:, 2], d[:, 0], d[:, 1],
                                d[:, 2], *h[:, 3:].unbind(1), lvl,
                                max_bounces)
            act = torch.clamp(guide(obs), -1.0, 1.0)
            g = fb_action_to_direction_c(act[:, 0], act[:, 1], h[:, 3],
                                         h[:, 4], h[:, 5])
            d_next = torch.where(use_fb[:, None], torch.stack(g, dim=-1),
                                 d_next)
            counts[:, 4] += use_fb
        counts[:, 0] += running
        counts[:, 1] += (st & ST_FOUND) != 0
        counts[:, 2] += emis
        counts[:, 3] += (st & ST_SMALL) != 0
        term_emis |= emis
        levels.append((st, lv.rec))
        o, d, running = lv.o_next, d_next, cont
    # A ray still running after the last level makes one more trace() call
    # that the reference counts before its bounce-budget return.
    counts[:, 0] += running
    if guided:
        counts[:, 5] = torch.where(term_emis, counts[:, 4], 0)
    return fold_levels(levels, background), counts


def path_trace_plain(origins: torch.Tensor, dirs: torch.Tensor,
                     uniforms: Optional[torch.Tensor], table: PathTable, *,
                     max_bounces: int, background: Sequence[float],
                     fast: bool = False, guide=None,
                     fb_uniforms: Optional[torch.Tensor] = None,
                     fb_prob: float = 1.0):
    """Plain PyTorch version of the kernel, on any device: the lean
    tracer's levels and reverse fold, op for op (``trace_levels`` over
    ``level_plain``)."""
    return trace_levels(level_plain, origins, dirs, uniforms, table,
                        max_bounces=max_bounces, background=background,
                        fast=fast, guide=guide, fb_uniforms=fb_uniforms,
                        fb_prob=fb_prob)
