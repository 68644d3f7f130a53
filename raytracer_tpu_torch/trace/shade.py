"""Whitted terminal shading: the reference's ``Intersection.terminalRGB``
(RL/ray.py:37-65) with its light falloff (RL/light.py:3-37).

Counterpart of ``raytracer_tpu/trace/shade.py``.  Per terminal hit:

* the emissive term ``colour * emitive``;
* every global light: linear angular falloff of the angle between the
  normal and the light's direction, no shadow test;
* every point light: lit only if a shadow ray toward it ends on the sphere
  carrying the light's id.  With ``shadow_max_bounces == 0`` (every
  reference call site) that is one nearest-hit sweep by signed t with the
  shaded sphere's id suppressed: a mirror blocker ends on itself and a
  glass blocker ends in none, both occluding; otherwise the shadow ray is
  traced by ``trace_whitted``;
* ``background + round(albedo * light / 255)`` per channel, Python's
  banker's rounding (``torch.round``).

``impl="kernel"`` shades through the Whitted shading kernel
(``core/cuda_shade.py::whitted_shade``, one launch with the shadow sweeps
inside; its plain version for CPU tensors; float32), or, with
``shadow_max_bounces > 0``, traces the shadow rays through the Whitted
kernel; ``impl="plain"`` keeps everything in plain PyTorch, in any float
dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import cuda_intersect, cuda_shade, vec
from ..core.intersect import nearest_hit_c
from ..scene.types import GlobalLights, PointLights, Scene
from .whitted import TraceResult, trace_whitted

NO_ID = -2 ** 31 + 1      # terminus id of a shadow ray that ends in none


def incidence(angle: torch.Tensor, max_angle: torch.Tensor) -> torch.Tensor:
    """Linear angular falloff (RL/light.py:3-9): 0 beyond ``max_angle``,
    else ``(max_angle - angle) / max_angle``."""
    rel = (max_angle - angle) / max_angle
    return torch.where(angle > max_angle, 0.0, rel)


def terminal_rgb(scene: Scene, glights: GlobalLights, plights: PointLights,
                 res: TraceResult, background, shadow_max_bounces: int = 0,
                 *, impl: str = "plain",
                 table: Optional[cuda_intersect.SphereTable] = None,
                 miss_colour=None) -> torch.Tensor:
    """Shade a wavefront of termini.  Returns raw reference-unit RGB
    ``[R, 3]`` (may exceed 255, as the reference's ``Colour`` does); lanes
    with ``res.hit`` False get ``miss_colour`` (None: ``background``).
    ``table``: the scene's ``cuda_intersect.sphere_table`` where the caller
    has one (the trace's), so that none is built from the scene here."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "kernel" and shadow_max_bounces == 0:
        return cuda_shade.whitted_shade(scene, glights, plights, res,
                                        background, miss_colour, table)
    dtype, dev = res.point.dtype, res.point.device
    bg = torch.as_tensor(background, dtype=dtype, device=dev)
    miss = (bg if miss_colour is None
            else torch.as_tensor(miss_colour, dtype=dtype, device=dev))
    px, py, pz = res.point[:, 0], res.point[:, 1], res.point[:, 2]
    nx, ny, nz = res.normal[:, 0], res.normal[:, 1], res.normal[:, 2]
    alb_r = scene.colour[:, 0].to(dtype)[res.idx]
    alb_g = scene.colour[:, 1].to(dtype)[res.idx]
    alb_b = scene.colour[:, 2].to(dtype)[res.idx]
    emitivity = scene.emitive.to(dtype)[res.idx]

    il_r = alb_r * emitivity                                 # RL/ray.py:41
    il_g = alb_g * emitivity
    il_b = alb_b * emitivity

    # Global lights (RL/ray.py:43-45); light values stay 0-d tensors of the
    # rays' dtype, so scalar arithmetic rounds in that dtype.
    gvec = glights.vector.to(dtype)
    gcol = glights.colour.to(dtype)
    for g in range(glights.count):
        ang = vec.angle_between_c(nx, ny, nz, gvec[g, 0], gvec[g, 1],
                                  gvec[g, 2])
        rel = (incidence(ang, glights.max_angle[g].to(dtype))
               * glights.strength[g].to(dtype))
        il_r = il_r + rel * gcol[g, 0]
        il_g = il_g + rel * gcol[g, 1]
        il_b = il_b + rel * gcol[g, 2]

    # Point lights with shadow rays (RL/ray.py:47-62).
    if plights.count:
        self_id = scene.id[res.idx]
        if table is None:
            table = cuda_intersect.sphere_table(scene)
        light_ids = plights.id.tolist()
        funcs = plights.func.tolist()
        ppos = plights.position.to(dtype)
        pcol = plights.colour.to(dtype)
        transparent = scene.transparent.to(dtype)
        reflective = scene.reflective.to(dtype)
    for p in range(plights.count):
        tx, ty, tz = ppos[p, 0] - px, ppos[p, 1] - py, ppos[p, 2] - pz
        if shadow_max_bounces == 0:
            sdx, sdy, sdz = vec.normalise_safe_c(tx, ty, tz)
            sh = nearest_hit_c(px, py, pz, sdx, sdy, sdz, table.spec,
                               by_abs=False, suppress_id=self_id)
            sidx, sfound = sh.idx, sh.found
            glass_rule = ((transparent[sidx] == 1.0)
                          & (reflective[sidx] != 1.0))
            terminus_id = torch.where(sfound & ~glass_rule, scene.id[sidx],
                                      NO_ID)
        else:
            sres = trace_whitted(scene, res.point,
                                 torch.stack([tx, ty, tz], -1),
                                 max_bounces=shadow_max_bounces,
                                 suppress_id=self_id, impl=impl)
            terminus_id = torch.where(sres.hit, scene.id[sres.idx], NO_ID)
        # Skip a light whose id is the shaded sphere's own (RL/ray.py:48).
        lit = ((terminus_id == light_ids[p]) & (self_id != light_ids[p])
               & res.hit)
        ang = vec.angle_between_c(nx, ny, nz, tx, ty, tz)
        rel = (incidence(ang, plights.max_angle[p].to(dtype))
               * plights.strength[p].to(dtype))
        if funcs[p] == 0:   # linear distance term; func -1: none
            rel = rel / vec.magnitude_c(tx, ty, tz)
        rel = torch.where(lit, rel, 0.0)
        il_r = il_r + rel * pcol[p, 0]
        il_g = il_g + rel * pcol[p, 1]
        il_b = il_b + rel * pcol[p, 2]

    # Colour.illuminate (RL/colour.py:21-28), then the background.
    sh_r = bg[0] + torch.round(vec.div_scalar(alb_r * il_r, 255.0))
    sh_g = bg[1] + torch.round(vec.div_scalar(alb_g * il_g, 255.0))
    sh_b = bg[2] + torch.round(vec.div_scalar(alb_b * il_b, 255.0))
    shaded = torch.stack([sh_r, sh_g, sh_b], -1)
    return torch.where(res.hit[:, None], shaded, miss[None, :])
