"""Stochastic path tracer: the chandelier renderers' recursive tracer
(FB/fb_vs_traditional_complex.py:299-389; chandelier copy :460-554) and
the guided FB tracer (:486-601; chandelier copy :620-737) as a wavefront
over ``[R]`` rays.

Counterpart of ``raytracer_tpu/trace/path.py`` with the semantics of its
``_trace_path_lean_impl`` (bit-identical to its fused scan).  Per level:
nearest hit by ``|t|`` without suppression; a miss, or the bounce budget,
gives the background; an emissive hit gives the sphere's colour; otherwise

* direct = Σ over emissive spheres of ``trunc(0.3·max(0,cosθ)/d²·colour)``,
  skipping the hit sphere (no shadow test);
* indirect = mirror reflect when ``reflective > mirror_threshold``, else a
  cosine bounce θ = arccos(√u₀), φ = 2πu₁ from the level's uniforms, or,
  with a guide and where the level's fb uniform is below ``fb_prob``, the
  guide's action on the 22-D observation (``make_observation``), clipped
  to [-1, 1] and mapped θ = (a₀+1)π/4, φ = a₁π;
* combine ``trunc(albedo · min(255, direct + indirect) / 255)``.

``impl="kernel"`` runs ``core/cuda_path.py::path_trace`` (the CUDA kernel,
with the student inside it when guided, on a card; its plain version for
CPU tensors); ``impl="hybrid"`` runs one ``core/cuda_level.py::path_level``
launch a level with the guide between levels as PyTorch matmuls and the
fold on tensors (JAX ``_trace_path_hybrid_impl``); ``impl="stepwise"``
(also ``"stepwise-pallas"``: the same route here) runs one
``core/cuda_intersect.py::nearest_hit`` launch a level for the sweep and
the rest of the level as tensor ops, the guide between levels (JAX
``_trace_path_stepwise`` with ``use_pallas=True``), and alone takes
``guide_max_level``; ``impl="plain"`` runs the plain PyTorch version
wherever the tensors are.  The kernel impl takes a distilled student
(``fb/distill.py::StudentGuide``); the others take any ``obs [R, 22] ->
action [R, 2]`` callable, the full agent's
(``fb/inference.py::TrainedFBAgent.as_guide_fn``) among them.

Randomness comes in as planes, in the JAX schedule: ``uniforms[L, R, 2]``
and, when guided, ``fb_uniforms[L, R]``: level ``l``'s ``k_diff, k_fb =
split(keys[l])``, then ``uniform(k_diff, (R, 2))`` and ``uniform(k_fb,
(R,))``.  Without them a ``torch.Generator`` draws them on the rays'
device, uniforms first.  They are read only when a diffuse bounce is
possible.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core import vec
from ..scene.types import Scene


@dataclasses.dataclass(frozen=True)
class PathStats:
    """The reference renderers' counters (complex.py:270-276), as int64
    0-d tensors: frame totals (~31 M at 800x600@8spp) pass float32's exact
    integer range.  ``fb_success`` counts the guided bounces of lanes that
    ended on an emissive hit, as the JAX tracers do."""

    total_rays: torch.Tensor
    total_intersections: torch.Tensor
    light_hits: torch.Tensor
    small_light_hits: torch.Tensor
    fb_used: torch.Tensor
    fb_success: torch.Tensor

    @staticmethod
    def from_counts(counts: torch.Tensor) -> "PathStats":
        """Sum per-ray counts in int64: ``[R, 4]`` (running, found,
        emissive, small light) or, guided, ``[R, 6]`` (and fb used, fb
        success)."""
        s = counts.sum(dim=0, dtype=torch.int64)
        if s.shape[0] == 6:
            return PathStats(*s)
        z = torch.zeros((), dtype=torch.int64, device=counts.device)
        return PathStats(s[0], s[1], s[2], s[3], z, z.clone())

    def as_dict(self) -> dict:
        return {f.name: int(getattr(self, f.name))
                for f in dataclasses.fields(self)}


def scene_spec(scene: Scene) -> tuple:
    """Per-sphere rows ``(cx, cy, cz, r, colr, colg, colb, refl, transp,
    emit, ior, id)`` as Python floats, exact images of the float32 table.
    Radius-0 padding rows are kept, as in the JAX package."""
    c = scene.centre.detach().cpu().numpy()
    r = scene.radius.detach().cpu().numpy()
    col = scene.colour.detach().cpu().numpy()
    rf = scene.reflective.detach().cpu().numpy()
    tr = scene.transparent.detach().cpu().numpy()
    em = scene.emitive.detach().cpu().numpy()
    io = scene.ior.detach().cpu().numpy()
    sid = scene.id.detach().cpu().numpy()
    return tuple(
        (float(c[s, 0]), float(c[s, 1]), float(c[s, 2]), float(r[s]),
         float(col[s, 0]), float(col[s, 1]), float(col[s, 2]),
         float(rf[s]), float(tr[s]), float(em[s]), float(io[s]),
         int(sid[s]))
        for s in range(c.shape[0]))


def emissive_indices(scene: Scene) -> tuple:
    """Indices of the emissive spheres, ascending."""
    em = scene.emitive.detach().cpu().numpy() > 0
    return tuple(int(i) for i in np.nonzero(em)[0])


def no_diffuse_possible(scene: Scene, mirror_threshold: float) -> bool:
    """True when every real (radius > 0) sphere is emissive or mirrors at
    this threshold: then no diffuse bounce can fire and no uniform is read
    (the chandelier traditional configuration, mirror_threshold=0.0)."""
    real = scene.radius.detach().cpu().numpy() > 0
    em = scene.emitive.detach().cpu().numpy() > 0
    mirror = scene.reflective.detach().cpu().numpy() > mirror_threshold
    return bool((em | mirror)[real].all())


def _direct_lighting_c(rows, emissive_idx, px, py, pz, nx, ny, nz, idx,
                       fast: bool = False):
    """Direct term at the hit points: Σ over the emissive spheres
    (``emissive_idx``) of ``trunc(0.3·max(0,cosθ)/d²·colour)`` per
    channel, skipping the hit sphere ``idx``.  Each term is integer-valued,
    so the sum is exact in any order.  ``fast``: one ``rsqrt`` in place of
    the sqrt and divides.  Returns ``(dr, dg, db)``."""
    dr = torch.zeros_like(px)
    dg = torch.zeros_like(px)
    db = torch.zeros_like(px)
    for s in emissive_idx:
        cx, cy, cz = rows[s][0], rows[s][1], rows[s][2]
        tx, ty, tz = cx - px, cy - py, cz - pz
        d2 = tx * tx + ty * ty + tz * tz
        if fast:
            inv = torch.rsqrt(torch.clamp_min(d2, 1e-30))
            ldotn = tx * nx + ty * ny + tz * nz
            w = torch.clamp_min(ldotn * inv, 0.0) * (inv * inv) * 0.3
        else:
            dist = vec.sqrt(d2)
            den = torch.clamp_min(dist, 1e-20)
            cosang = (tx / den) * nx + (ty / den) * ny + (tz / den) * nz
            w = (torch.clamp_min(cosang, 0.0)
                 / torch.clamp_min(dist * dist, 1e-30) * 0.3)
        w = torch.where(idx != s, w, 0.0)
        dr = dr + torch.trunc(w * rows[s][4])
        dg = dg + torch.trunc(w * rows[s][5])
        db = db + torch.trunc(w * rows[s][6])
    return dr, dg, db


def make_observation(point, normal, ray_dir, bounce_count, colour,
                     scene: Scene, idx, max_bounces: int) -> torch.Tensor:
    """22-D FB observation (FB/fb_vs_traditional_complex.py:446-467):
    pos, incoming dir, normal, material (reflective, transparent, emitive,
    ior), colour/255, bounce/max, through = 0, id/100, pad (0.5, 0.5, 0.5).
    ``point``/``normal``/``ray_dir``/``colour`` ``[R, 3]``,
    ``bounce_count [R]``, ``idx [R]`` hit-sphere indices."""
    dtype = point.dtype
    idx = idx.long()
    col = lambda t: t[idx].to(dtype)[:, None]
    zero = torch.zeros_like(point[:, :1])
    return torch.cat([
        point, ray_dir, normal,
        col(scene.reflective), col(scene.transparent), col(scene.emitive),
        col(scene.ior),
        vec.div_scalar(colour.to(dtype), 255.0),
        vec.div_scalar(bounce_count.to(dtype), float(max_bounces))[:, None],
        zero,
        vec.div_scalar(scene.id[idx].to(dtype), 100.0)[:, None],
        torch.full_like(point, 0.5),
    ], dim=-1)


def observation_c(px, py, pz, dx, dy, dz, nx, ny, nz, refl, transp, emit,
                  ior, sid, lvl: int, max_bounces: int) -> torch.Tensor:
    """``make_observation`` as the path tracers build it, from components
    and the hit sphere's material columns: colour 0 (the tracers pass
    zeros), bounce ``lvl``.  Returns ``[R, 22]``."""
    zero = torch.zeros_like(px)
    half = torch.full_like(px, 0.5)
    frac = vec.div_scalar(torch.full_like(px, float(lvl)), float(max_bounces))
    return torch.stack([px, py, pz, dx, dy, dz, nx, ny, nz, refl, transp,
                        emit, ior, zero, zero, zero, frac, zero,
                        vec.div_scalar(sid, 100.0), half, half, half], dim=-1)


def is_student(guide_fn) -> bool:
    """True for a distilled student guide (``fb/distill.py::StudentGuide``):
    it carries the layers the kernels read."""
    return (getattr(guide_fn, "layers", None) is not None
            and hasattr(guide_fn, "dtype"))


def trace_path(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor, *,
               max_bounces: int = 3, mirror_threshold: float = 0.9,
               background=(2.0, 2.0, 5.0),
               uniforms: Optional[torch.Tensor] = None,
               fb_uniforms: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               guide_fn=None, fb_prob: float = 1.0, impl: str = "kernel",
               guide_max_level: Optional[int] = None,
               precision: str = "exact"):
    """Trace ``[R]`` rays to integer-valued sample colours ``[R, 3]``.

    ``origins``/``dirs`` ``[R, 3]`` on the scene's device (dirs need not be
    normalised).  Returns ``(rgb, PathStats)``.  ``guide_fn``: a guide
    ``obs [R, 22] -> action [R, 2]``, taken on a diffuse bounce where the
    level's fb uniform is below ``fb_prob``.  ``guide_max_level=K``
    (stepwise only, the full agent's deployment knob): the guide runs on
    the first ``K`` levels, deeper diffuse bounces sample the cosine lobe
    on the same draws.  ``precision="fast"``: the squared-radius hit test
    and rsqrt direct lighting (rare 1-ulp integer flips at the trunc
    sites; the goldens stay on "exact")."""
    if max_bounces < 1:
        raise ValueError(f"max_bounces must be >= 1, got {max_bounces}")
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    if impl not in ("kernel", "plain", "hybrid", "stepwise",
                    "stepwise-pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    stepwise = impl in ("stepwise", "stepwise-pallas")
    if guide_max_level is not None and not stepwise:
        raise ValueError("guide_max_level requires impl='stepwise'")
    if guide_fn is not None and impl == "kernel" and not is_student(guide_fn):
        raise ValueError(
            "impl='kernel' takes distilled-student guides only "
            "(fb.distill.DistilledGuide.as_guide_fn); full agents use "
            "impl='stepwise', 'hybrid' or 'plain'")
    from ..core import cuda_path    # imports this module's helpers
    dev = scene.device
    origins = origins.to(dev, torch.float32).contiguous()
    dirs = dirs.to(dev, torch.float32).contiguous()
    R = origins.shape[0]
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 mirror_threshold, dev)
    if no_diffuse_possible(scene, mirror_threshold):
        # No lane can be diffuse: no draw is read and the guide never fires.
        uniforms = fb_uniforms = guide_fn = None
    else:
        uniforms = _plane("uniforms", uniforms, (max_bounces, R, 2),
                          generator, dev)
        fb_uniforms = None if guide_fn is None else _plane(
            "fb_uniforms", fb_uniforms, (max_bounces, R), generator, dev)
    kw = dict(max_bounces=max_bounces,
              background=tuple(float(b) for b in background),
              fast=precision == "fast", guide=guide_fn,
              fb_uniforms=fb_uniforms, fb_prob=float(fb_prob))
    if impl == "hybrid":
        # JAX _trace_path_hybrid_impl: one level kernel a level, the guide
        # and the fb gate between levels as tensor ops, the fold after.
        from ..core import cuda_level
        rgb, counts = cuda_path.trace_levels(cuda_level.path_level, origins,
                                             dirs, uniforms, table, **kw)
    elif stepwise:
        # JAX _trace_path_stepwise: one nearest-hit sweep a level, the rest
        # of the level, the guide and the fb gate as tensor ops.
        from ..core.cuda_intersect import sphere_table
        level = functools.partial(cuda_path.level_stepwise,
                                  sweep=sphere_table(scene))
        rgb, counts = cuda_path.trace_levels(
            level, origins, dirs, uniforms, table,
            guide_max_level=guide_max_level, **kw)
    else:
        fn = (cuda_path.path_trace if impl == "kernel"
              else cuda_path.path_trace_plain)
        rgb, counts = fn(origins, dirs, uniforms, table, **kw)
    return rgb, PathStats.from_counts(counts)


def _plane(name, plane, shape, generator, dev):
    """A draw plane as given, else drawn by ``generator``."""
    if plane is not None:
        return plane.to(dev, torch.float32).contiguous()
    if generator is None:
        raise ValueError(f"a diffuse bounce is possible: pass {name} "
                         f"{list(shape)} or a generator")
    return torch.rand(shape, generator=generator, device=dev)

