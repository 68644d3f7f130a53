"""Nearest ray-sphere hit, component form.

Counterpart of ``raytracer_tpu/core/intersect.py``: ``nearest_hit_c`` is
its general sweep (suppressed ids, the signed-t or ``|t|`` metric, the
exact ``sqrt(d2) <= r`` or the fast ``d2 <= r*r`` test), and also carries
``trace/path.py::_lean_sweep``'s in-sweep attribute selection for the
path tracers (``|t|``, no suppression): per-sphere values chosen under the
same ``better`` mask as the hit, so no gather follows the sweep.  Same op
order per sphere as the JAX sweep; the strict ``<`` keeps the first
minimum, like ``argmin``.  ``single_sphere_exit_c`` is the far-root hit
of the refraction walk.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import vec

# Sentinel suppress id meaning "no suppressed sphere" (camera rays).
NO_SUPPRESS = -2 ** 31


class NearestHitC(NamedTuple):
    found: torch.Tensor
    idx: torch.Tensor
    t: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    extras: list


def nearest_hit_c(ox, oy, oz, dx, dy, dz, rows: Sequence[tuple],
                  extra_vals: Sequence[Tuple[Sequence, bool]] = (),
                  fast: bool = False, *, by_abs: bool = True,
                  suppress_id: Optional[torch.Tensor] = None) -> NearestHitC:
    """Sweep every sphere of ``rows`` (``scene_spec`` rows: ``cx cy cz r``
    first and the id last, as Python floats that are exact values of the
    rays' dtype).

    ``extra_vals``: ``(per-sphere values, is_bool)`` pairs selected in the
    sweep; lanes with no valid hit keep zeros / False.  ``fast`` swaps the
    ``sqrt(d2) <= r`` test for ``d2 <= r*r``.  ``by_abs``: order hits by
    ``|t|`` (the path tracers) or by signed ``t`` (the Whitted tracer).
    ``suppress_id``: ``[R]`` int32; a sphere whose id equals it is skipped
    (``NO_SUPPRESS`` skips none)."""
    dtype = ox.dtype
    big = torch.finfo(dtype).max
    best_m = torch.full_like(ox, big)
    best_t = torch.full_like(ox, big)
    best_i = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    bcx = torch.zeros_like(ox)
    bcy = torch.zeros_like(ox)
    bcz = torch.zeros_like(ox)
    extras = [torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
              if is_bool else torch.zeros_like(ox)
              for _, is_bool in extra_vals]
    found = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    for s, row in enumerate(rows):
        cx, cy, cz, r = row[0], row[1], row[2], row[3]
        lx, ly, lz = cx - ox, cy - oy, cz - oz            # L = centre - o
        tca = lx * dx + ly * dy + lz * dz
        d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)
        thc = vec.sqrt(torch.clamp_min(r * r - d2, 0.0))
        t = tca - thc
        inside = (d2 <= r * r) if fast else (vec.sqrt(d2) <= r)
        valid = (tca >= 0.0) & inside
        if suppress_id is not None:
            valid = valid & (suppress_id != row[-1])
        m = torch.abs(t) if by_abs else t
        better = valid & (m < best_m)
        best_m = torch.where(better, m, best_m)
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, s, best_i)
        bcx = torch.where(better, cx, bcx)
        bcy = torch.where(better, cy, bcy)
        bcz = torch.where(better, cz, bcz)
        extras = [torch.where(better, vals[s], e)
                  for (vals, _), e in zip(extra_vals, extras)]
        found = found | valid
    px = ox + dx * best_t
    py = oy + dy * best_t
    pz = oz + dz * best_t
    nx, ny, nz = vec.normalise_safe_c(px - bcx, py - bcy, pz - bcz)
    return NearestHitC(found, best_i, best_t, px, py, pz, nx, ny, nz, extras)


def single_sphere_exit_c(ox, oy, oz, dx, dy, dz, cx, cy, cz, radius):
    """Far-root (``point=1``) hit against one known sphere per ray, as the
    refraction walk marches inside it.  Returns ``(valid, px, py, pz, nx,
    ny, nz)``."""
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)
    dist = vec.sqrt(d2)
    thc = vec.sqrt(torch.clamp_min(radius * radius - d2, 0.0))
    t = tca + thc
    valid = (tca >= 0.0) & (dist <= radius)
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
    nx, ny, nz = vec.normalise_safe_c(px - cx, py - cy, pz - cz)
    return valid, px, py, pz, nx, ny, nz
