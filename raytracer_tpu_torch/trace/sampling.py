"""Hemisphere sampling, component form.

Counterpart of ``raytracer_tpu/trace/sampling.py::local_to_world_c`` in the
"renderer" tangent convention (FB/fb_vs_traditional_complex.py:355-366):
the tangent is ``(1, 0, 0)`` when ``|n.z| > 0.9``, else
``cross((0, 0, 1), n) = (-ny, nx, 0)``; the bitangent is
``normalise(cross(n, t))``.  Same op order as the JAX code.  The env and
trainer conventions belong to the RL slice.
"""
from __future__ import annotations

import torch

from ..core import vec


def _cross_c(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def tangent_frame_c(nx, ny, nz):
    """Returns ``(tx, ty, tz, bx, by, bz)``, renderer convention."""
    zero = torch.zeros_like(nx)
    one = torch.ones_like(nx)
    above = torch.abs(nz) > 0.9
    tx = torch.where(above, one, -ny)
    ty = torch.where(above, zero, nx)
    tz = zero
    tx, ty, tz = vec.normalise_safe_c(tx, ty, tz)
    cx, cy, cz = _cross_c(nx, ny, nz, tx, ty, tz)
    bx, by, bz = vec.normalise_safe_c(cx, cy, cz)
    return tx, ty, tz, bx, by, bz


def local_to_world_c(theta, phi, nx, ny, nz):
    """Direction at polar ``theta`` / azimuth ``phi`` about ``n``, in world
    space.  Returns ``(wx, wy, wz)``."""
    tx, ty, tz, bx, by, bz = tangent_frame_c(nx, ny, nz)
    st = torch.sin(theta)
    lx = st * torch.cos(phi)
    ly = st * torch.sin(phi)
    lz = torch.cos(theta)
    return vec.normalise_safe_c(lx * tx + ly * bx + lz * nx,
                                lx * ty + ly * by + lz * ny,
                                lx * tz + ly * bz + lz * nz)
