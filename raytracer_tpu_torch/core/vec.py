"""Vector math on xyz components.

Counterpart of the component (``*_c``) helpers of
``raytracer_tpu/core/vec.py``: the same operations in the same order, one
rounding per operation, so results are bit-identical on the CPU and match
the CUDA kernels (built with ``-fmad=false``) on the card.  Sums associate
left to right, as the reference's ``x*x + y*y + z*z`` does.
"""
from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as IEEE ``sqrtf``/``sqrt`` on the card
    and in the JAX package.  PyTorch's CPU ``sqrt`` is not: on vectors of
    more than a few dozen elements about 0.6% of its float32 and float64
    results are one ulp off, so CPU tensors take numpy's."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def div_scalar(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once.  On CUDA, PyTorch divides by a Python scalar
    as a multiply by its reciprocal (two roundings), so the divisor goes in
    as a tensor on ``a``'s device."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def dot_c(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def magnitude_c(x, y, z):
    return sqrt(dot_c(x, y, z, x, y, z))


def normalise_safe_c(x, y, z, eps: float = 1e-20):
    m = torch.clamp_min(magnitude_c(x, y, z), eps)
    return x / m, y / m, z / m


def dot(a, b):
    """``[..., 3]`` dot product, summed left to right."""
    return dot_c(*a.unbind(-1), *b.unbind(-1))


def magnitude(v):
    return sqrt(dot(v, v))


def normalise_safe(v, eps: float = 1e-20):
    return v / torch.clamp_min(magnitude(v), eps)[..., None]


def reflect_c(vx, vy, vz, nx, ny, nz):
    """Reflect ``v`` in ``n``: normalise both, reflect, renormalise."""
    vx, vy, vz = normalise_safe_c(vx, vy, vz)
    nx, ny, nz = normalise_safe_c(nx, ny, nz)
    s = 2.0 * dot_c(vx, vy, vz, nx, ny, nz)
    return normalise_safe_c(vx - nx * s, vy - ny * s, vz - nz * s)


def angle_between_c(ax, ay, az, bx, by, bz):
    """``arccos(a.b / (|a||b|))`` with the cosine clamped to [-1, 1]."""
    c = (dot_c(ax, ay, az, bx, by, bz)
         / (magnitude_c(ax, ay, az) * magnitude_c(bx, by, bz)))
    return torch.acos(torch.clamp(c, -1.0, 1.0))


def refract_c(vx, vy, vz, nx, ny, nz, eta_a, eta_b):
    """Snell refraction of ``v`` through the surface with normal ``n``, from
    medium ``eta_a`` into ``eta_b`` (tensors).  Returns ``(dx, dy, dz,
    tir)``; ``tir`` marks total internal reflection, where the direction is
    garbage.  cosI is ``|v.n|`` clamped; the normal is not flipped."""
    vx, vy, vz = normalise_safe_c(vx, vy, vz)
    nx, ny, nz = normalise_safe_c(nx, ny, nz)
    eta = eta_a / eta_b
    cos_i = torch.abs(torch.clamp(dot_c(vx, vy, vz, nx, ny, nz), -1.0, 1.0))
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    f = eta * cos_i - sqrt(torch.clamp_min(k, 0.0))
    ox, oy, oz = normalise_safe_c(vx * eta + nx * f, vy * eta + ny * f,
                                  vz * eta + nz * f)
    return ox, oy, oz, tir


def euler_rotation_matrix(ax: float, ay: float, az: float) -> np.ndarray:
    """The reference's Euler rotation matrix (RL/vector.py:117-127) as
    float64 numpy: ``angle.x`` rotates in the xy plane, ``angle.y`` about
    the y axis, ``angle.z`` banks; applied as the row-vector product
    ``v @ R``."""
    a, b, c = ax, ay, az
    sin, cos = np.sin, np.cos
    return np.array([
        [cos(c) * cos(b) * cos(a) - sin(c) * sin(a),
         cos(c) * cos(b) * sin(a) + sin(c) * cos(a),
         -cos(c) * sin(b)],
        [-sin(c) * cos(b) * cos(a) - cos(c) * sin(a),
         -sin(c) * cos(b) * sin(a) + cos(c) * cos(a),
         sin(c) * sin(b)],
        [sin(b) * cos(a), sin(b) * sin(a), cos(b)],
    ], dtype=np.float64)


def rotate_euler(v: torch.Tensor, ax: float, ay: float,
                 az: float) -> torch.Tensor:
    """``v @ R`` for ``[..., 3]`` vectors, the matrix rounded once to
    ``v``'s dtype and each output a left-to-right sum of three products."""
    m = euler_rotation_matrix(ax, ay, az)
    x, y, z = v.unbind(-1)
    r = [[torch.tensor(m[i, j], dtype=v.dtype, device=v.device)
          for j in range(3)] for i in range(3)]
    return torch.stack([x * r[0][j] + y * r[1][j] + z * r[2][j]
                        for j in range(3)], dim=-1)
