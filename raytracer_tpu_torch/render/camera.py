"""Cameras: the notebooks' planar grid and the perspective pinholes of the
JAX package's ``variant="fb"`` and ``variant="env"``.

Counterpart of ``raytracer_tpu/render/camera.py``.  ``grid_rays`` is built
in float64 numpy exactly as the JAX package builds it and cast once.
``perspective_rays(variant="fb")`` serves the FB comparison renderers
(FB/fb_vs_traditional_complex.py:285-297), which apply the aspect ratio
twice (once to screen_x, once through half_width = half_height *
aspect): a reference bug kept knowingly.  ``variant="env"`` is the gym
env's pinhole (RL/ray_tracer_env.py:121-142): the aspect applied once,
and an optional Euler rotation of the normalised directions.

Rounding follows the JAX function as it runs on its TPU, where 64-bit mode
is off: ``tan(fov/2)`` and ``tan(fov/2) * aspect`` are numpy float64 values
rounded once to float32, and every tensor operation is float32.  (With
JAX's 64-bit mode on, the numpy float64 scalar promotes the directions to
float64 instead; the port does not follow that mode.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core import vec
from ..core.vec import div_scalar


def grid_rays(ray_count: int = 100, ray_step: float = 0.01,
              multiple: int = 1, origin=(0.0, 0.0, 1.0),
              dtype=torch.float32, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Notebook grid rays (RL/Planets 1.ipynb cell 0): ``(origins [H*W, 3],
    dirs [H*W, 3], H, W)``.

    ``X = [-N..N] * step``, ``Y = [N..-N] * step`` with ``N = ray_count *
    multiple`` and ``step = ray_step / multiple``; directions ``(X, Y, -1)``
    unnormalised (the tracer normalises them); the image is ``(2N+1) x
    (2N+1)``, row-major with Y outer (top row first)."""
    dev = resolve_device(device)
    n = ray_count * multiple
    step = ray_step / multiple
    # The reference's list construction: r*step for integer r.
    xs = np.array([r * step for r in range(-n, 0)] +
                  [r * step for r in range(0, n + 1)])
    ys = np.array([r * step for r in range(n, 0, -1)] +
                  [-r * step for r in range(0, n + 1)])
    X, Y = np.meshgrid(xs, ys)
    dirs = np.stack([X, Y, np.full_like(X, -1.0)], axis=-1).reshape(-1, 3)
    h, w = len(ys), len(xs)
    o = torch.from_numpy(np.asarray(origin, dtype=np.float64)).to(dtype)
    origins = o.to(dev).expand(h * w, 3).contiguous()
    return origins, torch.from_numpy(dirs).to(dtype).to(dev), h, w


def perspective_rays(width: int, height: int, *, fov: float = 60.0,
                     origin=(0.0, 0.0, 0.0), variant: str = "fb",
                     sample_xy: Optional[torch.Tensor] = None,
                     camera_angle: Optional[Tuple[float, float, float]] = None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays through every pixel, float32.

    ``sample_xy``: optional ``[..., H, W, 2]`` sub-pixel offsets in [0, 1)
    (spp jitter; leading dimensions are kept, samples outermost); pixel
    centres (0.5, 0.5) by default.  ``camera_angle``: Euler angles that
    rotate the normalised directions (``core/vec.py::rotate_euler``).
    Returns ``(origins, dirs)``, each ``[N, 3]`` with ``N`` = samples x H
    x W; dirs unnormalised unless rotated (the tracer normalises them)."""
    if variant not in ("fb", "env"):
        raise ValueError(f"unknown perspective variant {variant!r}")
    dev = resolve_device(device) if sample_xy is None else sample_xy.device
    f32 = torch.float32
    aspect = width / height
    fov_rad = np.radians(fov)
    half_height = float(np.float32(np.tan(fov_rad / 2)))
    half_width = float(np.float32(np.tan(fov_rad / 2) * aspect))
    px = torch.arange(width, dtype=f32, device=dev)[None, :]
    py = torch.arange(height, dtype=f32, device=dev)[:, None]
    if sample_xy is None:
        sx = torch.tensor(0.5, dtype=f32, device=dev)
        sy = sx
    else:
        sx = sample_xy[..., 0].to(f32)
        sy = sample_xy[..., 1].to(f32)
    if variant == "fb":
        ndc_x = div_scalar(px + sx, width)
        ndc_y = div_scalar(py + sy, height)
        screen_x = (2.0 * ndc_x - 1.0) * aspect
        screen_y = 1.0 - 2.0 * ndc_y
        screen_x = screen_x * half_width
        screen_y = screen_y * half_height
    else:
        screen_x = (div_scalar(2.0 * (px + sx), width) - 1.0) * aspect \
            * half_height
        screen_y = (1.0 - div_scalar(2.0 * (py + sy), height)) * half_height
    screen_x, screen_y = torch.broadcast_tensors(screen_x, screen_y)
    dirs = torch.stack([screen_x, screen_y, torch.full_like(screen_x, -1.0)],
                       dim=-1).reshape(-1, 3)
    if camera_angle is not None and any(a != 0 for a in camera_angle):
        x, y, z = vec.normalise_safe_c(*dirs.unbind(-1))
        dirs = vec.rotate_euler(torch.stack([x, y, z], -1), *camera_angle)
    origins = torch.tensor(origin, dtype=f32, device=dev).expand_as(dirs)
    return origins, dirs
