"""Nearest ray-sphere hit, component form.

Counterpart of ``raytracer_tpu/core/intersect.py::nearest_hit_c`` with the
path tracers' settings: the ``|t|`` metric (``by_abs=True``) and no id
suppression (the path tracers avoid self-hits with a 0.001 normal offset).
It also carries ``trace/path.py::_lean_sweep``'s in-sweep attribute
selection: per-sphere values chosen under the same ``better`` mask as the
hit, so no gather follows the sweep.  Same op order per sphere as the JAX
sweep; the strict ``<`` keeps the first minimum, like ``argmin``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from . import vec


class NearestHitC(NamedTuple):
    found: torch.Tensor
    idx: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    extras: list


def nearest_hit_c(ox, oy, oz, dx, dy, dz, rows: Sequence[tuple],
                  extra_vals: Sequence[Tuple[Sequence, bool]] = (),
                  fast: bool = False) -> NearestHitC:
    """Sweep every sphere of ``rows`` (``scene_spec`` rows: ``cx cy cz r``
    first, as Python floats that are exact float32 values).

    ``extra_vals``: ``(per-sphere values, is_bool)`` pairs selected in the
    sweep; lanes with no valid hit keep zeros / False.  ``fast`` swaps the
    ``sqrt(d2) <= r`` test for ``d2 <= r*r``."""
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
        thc = torch.sqrt(torch.clamp_min(r * r - d2, 0.0))
        t = tca - thc
        inside = (d2 <= r * r) if fast else (torch.sqrt(d2) <= r)
        valid = (tca >= 0.0) & inside
        m = torch.abs(t)
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
    return NearestHitC(found, best_i, px, py, pz, nx, ny, nz, extras)
