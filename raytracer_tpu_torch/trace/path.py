"""Stochastic path tracer: the chandelier renderers' recursive tracer
(FB/fb_vs_traditional_complex.py:299-389; chandelier copy :460-554) as a
wavefront over ``[R]`` rays.

Counterpart of ``raytracer_tpu/trace/path.py`` with the semantics of its
``_trace_path_lean_impl`` (bit-identical to its fused scan).  Per level:
nearest hit by ``|t|`` without suppression; a miss, or the bounce budget,
gives the background; an emissive hit gives the sphere's colour; otherwise

* direct = Σ over emissive spheres of ``trunc(0.3·max(0,cosθ)/d²·colour)``,
  skipping the hit sphere (no shadow test);
* indirect = mirror reflect when ``reflective > mirror_threshold``, else a
  cosine bounce θ = arccos(√u₀), φ = 2πu₁ from the level's uniforms;
* combine ``trunc(albedo · min(255, direct + indirect) / 255)``.

``impl="kernel"`` runs ``core/cuda_path.py::path_trace`` (the CUDA kernel
on a card, its plain version for CPU tensors); ``impl="plain"`` runs the
plain PyTorch version wherever the tensors are.

Randomness comes in as planes, in the JAX schedule: ``uniforms[L, R, 2]``,
level ``l`` being the JAX tracer's ``uniform(split(keys[l])[0], (R, 2))``.
Without them a ``torch.Generator`` draws them on the rays' device.  They
are read only when a diffuse bounce is possible.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import vec
from ..scene.types import Scene


@dataclasses.dataclass(frozen=True)
class PathStats:
    """The reference renderers' counters (complex.py:270-276), as int64
    0-d tensors: frame totals (~31 M at 800x600@8spp) pass float32's exact
    integer range.  ``fb_used``/``fb_success`` stay 0 until guided tracing
    is ported."""

    total_rays: torch.Tensor
    total_intersections: torch.Tensor
    light_hits: torch.Tensor
    small_light_hits: torch.Tensor
    fb_used: torch.Tensor
    fb_success: torch.Tensor

    @staticmethod
    def from_counts(counts: torch.Tensor) -> "PathStats":
        """Sum ``[R, 4]`` per-ray counts (running, found, emissive, small
        light) in int64."""
        s = counts.sum(dim=0, dtype=torch.int64)
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


def trace_path(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor, *,
               max_bounces: int = 3, mirror_threshold: float = 0.9,
               background=(2.0, 2.0, 5.0),
               uniforms: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               guide_fn=None, impl: str = "kernel",
               precision: str = "exact"):
    """Trace ``[R]`` rays to integer-valued sample colours ``[R, 3]``.

    ``origins``/``dirs`` ``[R, 3]`` on the scene's device (dirs need not be
    normalised).  Returns ``(rgb, PathStats)``.  ``precision="fast"``: the
    squared-radius hit test and rsqrt direct lighting (rare 1-ulp integer
    flips at the trunc sites; the goldens stay on "exact")."""
    if max_bounces < 1:
        raise ValueError(f"max_bounces must be >= 1, got {max_bounces}")
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if guide_fn is not None:
        raise NotImplementedError(
            "guided path tracing arrives with slice 3 of the port")
    from ..core import cuda_path    # imports this module's helpers
    dev = scene.device
    origins = origins.to(dev, torch.float32).contiguous()
    dirs = dirs.to(dev, torch.float32).contiguous()
    R = origins.shape[0]
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 mirror_threshold, dev)
    if no_diffuse_possible(scene, mirror_threshold):
        uniforms = None
    elif uniforms is None:
        if generator is None:
            raise ValueError("a diffuse bounce is possible: pass uniforms "
                             "[max_bounces, R, 2] or a generator")
        uniforms = torch.rand((max_bounces, R, 2), generator=generator,
                              device=dev)
    else:
        uniforms = uniforms.to(dev, torch.float32).contiguous()
    fn = cuda_path.path_trace if impl == "kernel" else \
        cuda_path.path_trace_plain
    rgb, counts = fn(origins, dirs, uniforms, table,
                     max_bounces=max_bounces,
                     background=tuple(float(b) for b in background),
                     fast=precision == "fast")
    return rgb, PathStats.from_counts(counts)
