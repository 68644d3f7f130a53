"""The output5 experiment tracers, as a wavefront over ``[R]`` rays.

Counterpart of ``raytracer_tpu/trace/output5_style.py`` (the per-method
tracers of RL/output5.py's ``CustomSceneExperiment``): iterative
*additive* path tracing.  Per bounce the surface shading is accumulated
with 255-clamps, then the next direction comes from the method's policy:

* ``traditional`` (:609-828): the blue global light and the custom scene's
  sun with a shadow sweep, albedo multiply; cosine diffuse, mirror on a
  truthy reflective, 50/50 reflect-or-pass-through glass; an emissive hit
  returns (255, 255, 200) outright; final brightness floor 80;
* ``rl`` (:830-918): sun-biased sampling (θ~U[0,π/4], φ~U[π/2,3π/2], the
  env tangent frame); lights accumulate and the walk continues; +30 a
  channel where the brightness is below 30;
* ``fb`` (:979-1165): ambient ``trunc(albedo*0.2) + (40, 40, 100)`` plus
  sun diffuse ``trunc(albedo*cos*0.8)`` behind a shadow sweep that skips
  emissive blockers; lights accumulate and the walk continues; the
  heuristic agent's strategy mix frozen at ``exploration_rate``; additive
  brightness boost to 50.

Each level's sweep is ``core/cuda_intersect.py::nearest_hit`` (``|t|``,
nothing suppressed): the nearest-hit kernel on the card.  The shading's
shadow test toward the sun is the JAX package's ``[R, N]`` broadcast
(``sphere_ts``), here as tensor ops.  Randomness comes in as planes, in
the JAX schedule (``keys = split(key, L)``, each level's ``k1, k2, k3 =
split(keys[l], 3)``): ``uniforms [L, R, 2]`` (traditional: ``uniform(k1,
(R, 2))``, the cosine bounce) or ``[L, R, 3]`` (rl and fb: ``uniform(k1,
(R, 3))``), and, traditional only, ``glass_uniforms [L, R]``
(``uniform(k2, (R,))``).  A ``torch.Generator`` draws planes not given.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import cuda_intersect, vec
from ..scene.types import Scene
from . import sampling

SUN_POS = (-0.6, 0.2, 6.0)
SUN_COLOUR = (255.0, 255.0, 204.0)
GLOBAL_DIR = (3.0, 1.0, -0.75)
GLOBAL_COLOUR = (20.0, 20.0, 255.0)
METHODS = ("traditional", "rl", "fb")


class Hit:
    """A sweep's result with the hit point and normal (JAX
    ``NearestHit``): ``found``, ``idx``, ``t [R]``, ``point``/``normal``
    ``[R, 3]``."""

    def __init__(self, o, d, t, idx, found, scene: Scene):
        self.found, self.idx, self.t = found, idx.long(), t
        self.point = o + d * t[:, None]
        c = scene.centre[self.idx]
        self.normal = torch.stack(vec.normalise_safe_c(
            *(self.point - c).unbind(-1)), dim=-1)


def sweep(scene: Scene, table, o, d, impl: str) -> Hit:
    """The level's nearest hit by ``|t|``, nothing suppressed, on
    ``table`` (``cuda_intersect.sphere_table(scene)``): ``impl="kernel"``
    the kernel's wrapper (its plain version for CPU tensors), ``"plain"``
    the plain version anywhere."""
    fn = (cuda_intersect.nearest_hit if impl == "kernel"
          else cuda_intersect.nearest_hit_plain)
    t, idx, found = fn(o.contiguous(), d.contiguous(), None, table,
                       by_abs=True)
    return Hit(o, d, t, idx, found, scene)


def _const(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def _sun_blocked(scene: Scene, hit: Hit, skip_emissive: bool):
    """One shadow sweep toward the sun over every sphere but the hit one
    (and, ``skip_emissive``, the lights: the fb tracer's filter,
    :1060-1062), the near root's distance from the hit point against the
    sun's (JAX ``sphere_ts`` broadcast).  Returns ``(blocked [R],
    to_sun_n [R, 3], sun_dist [R])``."""
    sun = _const(SUN_POS, hit.point)
    to_sun = sun[None] - hit.point
    sun_dist = vec.magnitude(to_sun)
    to_sun_n = vec.normalise_safe(to_sun)
    o = hit.point + hit.normal * 0.001
    L = scene.centre.to(o.dtype)[None] - o[:, None, :]           # [R, N, 3]
    tca = vec.dot(L, to_sun_n[:, None, :].expand_as(L))
    d2 = torch.clamp_min(vec.dot(L, L) - tca * tca, 0.0)
    r = scene.radius.to(o.dtype)[None]
    thc = vec.sqrt(torch.clamp_min(r * r - d2, 0.0))
    t = tca - thc
    valid = (tca >= 0.0) & (vec.sqrt(d2) <= r)
    n = scene.centre.shape[0]
    excl = torch.arange(n, device=o.device)[None, :] == hit.idx[:, None]
    if skip_emissive:
        excl = excl | (scene.emitive > 0)[None, :]
    valid = valid & ~excl
    sp = o[:, None, :] + to_sun_n[:, None, :] * t[..., None]
    sdist = vec.magnitude(sp - hit.point[:, None, :])
    blocked = (valid & (sdist < sun_dist[:, None])).any(dim=-1)
    return blocked, to_sun_n, sun_dist


def _shade_level(scene: Scene, hit: Hit):
    """Per-bounce 'original-like' lighting (RL/output5.py:663-729)."""
    gdir = vec.normalise_safe(_const(GLOBAL_DIR, hit.point))
    gcol = _const(GLOBAL_COLOUR, hit.point)
    scol = _const(SUN_COLOUR, hit.point)
    gcos = torch.clamp_min(vec.dot(hit.normal, gdir.expand_as(hit.normal)),
                           0.0)
    global_contrib = torch.trunc(gcol[None] * gcos[:, None] * 0.3)
    blocked, to_sun_n, sun_dist = _sun_blocked(scene, hit, False)
    atten = torch.clamp_max(torch.full_like(sun_dist, 100.0)
                            / torch.clamp_min(sun_dist * sun_dist, 1e-20),
                            1.0)
    cos = torch.clamp_min(vec.dot(hit.normal, to_sun_n), 0.0)
    sun_contrib = torch.trunc(scol[None] * (cos * 0.9 * atten)[:, None])
    sun_contrib = torch.where(blocked[:, None], 0.0, sun_contrib)
    combined = torch.clamp_max(global_contrib + sun_contrib, 255.0)
    albedo = scene.colour[hit.idx].to(hit.point.dtype)
    return torch.trunc(vec.div_scalar(albedo * combined, 255.0))


def _shade_level_fb(scene: Scene, hit: Hit):
    """The fb method's per-bounce lighting (:1070-1105)."""
    albedo = scene.colour[hit.idx].to(hit.point.dtype)
    blocked, to_sun_n, _ = _sun_blocked(scene, hit, True)
    cos = torch.clamp_min(vec.dot(hit.normal, to_sun_n), 0.0)
    ambient = torch.clamp_max(torch.trunc(albedo * 0.2)
                              + _const((40.0, 40.0, 100.0), albedo)[None],
                              255.0)
    diffuse = torch.where(~blocked[:, None],
                          torch.trunc(albedo * (cos * 0.8)[:, None]), 0.0)
    return torch.clamp_max(ambient + diffuse, 255.0)


def draw_planes(method: str, max_bounces: int, n: int, generator,
                device, dtype=torch.float32):
    """A generator's ``(uniforms, glass_uniforms)`` for ``method``."""
    k = 2 if method == "traditional" else 3
    u = torch.rand((max_bounces, n, k), generator=generator, device=device,
                   dtype=dtype)
    g = (torch.rand((max_bounces, n), generator=generator, device=device,
                    dtype=dtype) if method == "traditional" else None)
    return u, g


def trace_output5(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor,
                  *, max_bounces: int = 5, method: str = "traditional",
                  exploration_rate: float = 0.3,
                  uniforms: Optional[torch.Tensor] = None,
                  glass_uniforms: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  impl: str = "kernel"):
    """Returns ``(rgb [R, 3], stats)`` with ``stats = {"light_hits",
    "steps", "reward"}`` (0-d tensors), on the rays' device and dtype (the
    scene moves there).  ``impl``: the sweep, ``"kernel"`` or ``"plain"``
    as ``sweep``'s; the kernel takes float32 rays only (float64 needs
    ``"plain"``)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    dev, dtype = origins.device, origins.dtype
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    scene = scene.to(dev)
    table = cuda_intersect.sphere_table(scene)
    R = origins.shape[0]
    if uniforms is None:
        if generator is None:
            raise ValueError("pass uniforms (and, traditional, "
                             "glass_uniforms) or a generator")
        uniforms, glass_uniforms = draw_planes(method, max_bounces, R,
                                               generator, dev, dtype)
    k = 2 if method == "traditional" else 3
    if tuple(uniforms.shape) != (max_bounces, R, k):
        raise ValueError(f"uniforms must be [{max_bounces}, {R}, {k}], got "
                         f"{tuple(uniforms.shape)}")
    if method == "traditional" and (glass_uniforms is None or tuple(
            glass_uniforms.shape) != (max_bounces, R)):
        raise ValueError(f"traditional needs glass_uniforms "
                         f"[{max_bounces}, {R}]")
    uniforms = uniforms.to(dev, dtype)
    d = vec.normalise_safe(dirs.to(dtype))
    o = origins
    bg = _const((2.0, 2.0, 5.0), o)
    emissive = scene.emitive > 0
    acc = torch.zeros((R, 3), dtype=dtype, device=dev)
    out = torch.zeros((R, 3), dtype=dtype, device=dev)
    running = torch.ones(R, dtype=torch.bool, device=dev)
    done_set = torch.zeros(R, dtype=torch.bool, device=dev)
    light_hits = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for lvl in range(max_bounces):
        hit = sweep(scene, table, o, d, impl)
        miss = running & ~hit.found
        if method == "traditional" and lvl == 0:
            # A miss at level 0 is the background; later, acc stands.
            out = torch.where(miss[:, None], bg[None], out)
            done_set = done_set | miss
        running = running & hit.found
        emis = running & emissive[hit.idx]
        if method == "traditional":
            # An emissive hit returns (255, 255, 200) outright (:652-657).
            out = torch.where(emis[:, None],
                              _const((255.0, 255.0, 200.0), o)[None], out)
            done_set = done_set | emis
            running = running & ~emis
            shade = _shade_level(scene, hit)
            acc = torch.where(running[:, None],
                              torch.clamp_max(acc + shade, 255.0), acc)
        else:
            # RL / FB: the light's colour accumulates and the walk goes on.
            lc = scene.colour[hit.idx].to(dtype)
            acc = torch.where(emis[:, None],
                              torch.clamp_max(acc + lc, 255.0), acc)
            if method == "fb":
                shade = _shade_level_fb(scene, hit)
                acc = torch.where((running & ~emis)[:, None],
                                  torch.clamp_max(acc + shade, 255.0), acc)
        off = hit.point + hit.normal * 0.001
        if method == "traditional":
            refl = scene.reflective[hit.idx] > 0          # truthy rule
            transp = ~refl & (scene.transparent[hit.idx] > 0)
            mirror_d = torch.stack(vec.reflect_c(*d.unbind(-1),
                                                 *hit.normal.unbind(-1)), -1)
            diff_d = sampling.cosine_weighted(uniforms[lvl], hit.normal,
                                              "renderer")
            through = glass_uniforms[lvl].to(dev, dtype) >= 0.5
            glass_d = torch.where(through[:, None], d, mirror_d)
            glass_o = torch.where(through[:, None], hit.point + d * 0.001,
                                  off)
            new_d = torch.where(refl[:, None], mirror_d,
                                torch.where(transp[:, None], glass_d,
                                            diff_d))
            new_o = torch.where(transp[:, None], glass_o, off)
        else:
            u = uniforms[lvl]
            if method == "rl":
                seek = torch.ones(R, dtype=torch.bool, device=dev)
            else:
                seek = u[:, 2] >= exploration_rate
            theta = torch.where(seek, vec.div_scalar(u[:, 0] * math.pi, 4.0),
                                vec.div_scalar(u[:, 0] * math.pi, 2.0))
            phi = torch.where(seek, math.pi / 2 + u[:, 1] * math.pi,
                              u[:, 1] * 2.0 * math.pi)
            new_d = torch.stack(sampling.local_to_world_c(
                theta, phi, *hit.normal.unbind(-1), "env"), -1)
            new_o = off
        o = torch.where(running[:, None], new_o, o)
        d = torch.where(running[:, None], new_d, d)
        light_hits = light_hits + emis.sum()
        steps = steps + (running | emis | miss).sum()

    if method == "traditional":
        dark = (acc == 0.0).all(dim=-1)
        bright = vec.div_scalar(acc.sum(dim=-1), 3.0)
        scale = torch.full_like(bright, 80.0) / torch.clamp_min(bright, 1.0)
        boosted = torch.clamp_max(torch.trunc(acc * scale[:, None]), 255.0)
        final = torch.where((bright < 80.0)[:, None], boosted, acc)
        final = torch.clamp_max(final, 255.0)
        final = torch.where(dark[:, None], bg[None], final)
        rgb = torch.where(done_set[:, None], out, final)
    elif method == "rl":
        final = torch.clamp_max(acc, 255.0)
        bright = vec.div_scalar(final.sum(dim=-1), 3.0)
        rgb = torch.where((bright < 30.0)[:, None],
                          torch.clamp_max(final + 30.0, 255.0), final)
    else:  # fb: additive boost to brightness 50 (:1146-1159)
        dark = (acc == 0.0).all(dim=-1)
        bright = vec.div_scalar(acc.sum(dim=-1), 3.0)
        boost = torch.clamp_min(50.0 - bright, 0.0)
        boosted = torch.clamp_max(acc + boost[:, None], 255.0)
        final = torch.where((bright < 50.0)[:, None], boosted,
                            torch.clamp_max(acc, 255.0))
        rgb = torch.where(dark[:, None], bg[None], final)
    return rgb, {"light_hits": light_hits, "steps": steps,
                 "reward": light_hits * 10.0}
