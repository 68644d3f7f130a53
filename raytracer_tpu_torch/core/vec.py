"""Vector math on xyz components.

Counterpart of the component (``*_c``) helpers of
``raytracer_tpu/core/vec.py``: the same operations in the same order, one
rounding per operation, so results are bit-identical on the CPU and match
the CUDA kernel (built with ``-fmad=false``) on the card.  Sums associate
left to right, as the reference's ``x*x + y*y + z*z`` does.
"""
from __future__ import annotations

import torch


def div_scalar(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once.  On CUDA, PyTorch divides by a Python scalar
    as a multiply by its reciprocal (two roundings), so the divisor goes in
    as a tensor on ``a``'s device."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def dot_c(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def magnitude_c(x, y, z):
    return torch.sqrt(dot_c(x, y, z, x, y, z))


def normalise_safe_c(x, y, z, eps: float = 1e-20):
    m = torch.clamp_min(magnitude_c(x, y, z), eps)
    return x / m, y / m, z / m


def reflect_c(vx, vy, vz, nx, ny, nz):
    """Reflect ``v`` in ``n``: normalise both, reflect, renormalise."""
    vx, vy, vz = normalise_safe_c(vx, vy, vz)
    nx, ny, nz = normalise_safe_c(nx, ny, nz)
    s = 2.0 * dot_c(vx, vy, vz, nx, ny, nz)
    return normalise_safe_c(vx - nx * s, vy - ny * s, vz - nz * s)
