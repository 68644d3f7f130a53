"""Path-traced frame renderer (FB/fb_vs_traditional_complex.py:391-422;
chandelier copy :739-771).

Counterpart of ``raytracer_tpu/render/path_renderer.py::render_path``.  Per
pixel, ``spp`` jittered perspective samples; the integer sample colours are
summed, **integer-divided** by spp (``//`` in the reference), then mapped
by ``min(1, c/255)``.  All samples of all pixels trace as one wavefront of
``spp x H x W`` rays, samples outermost.

Randomness comes in as planes, in the JAX schedule: ``jitter[spp, H, W, 2]``
(the JAX renderer's ``uniform(split(key)[0], (spp, H, W, 2))``) and, when a
diffuse bounce is possible, ``uniforms[max_bounces, R, 2]`` and, guided,
``fb_uniforms[max_bounces, R]``.  Planes not passed are drawn by
``generator`` on the device, jitter first.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.vec import div_scalar
from ..scene.types import Scene
from ..trace.path import trace_path
from .camera import perspective_rays


def _camera_bundle(jitter: torch.Tensor, *, width, height, fov,
                   camera_position):
    """Rays for every sample of every pixel: ``[spp*H*W, 3]`` each."""
    return perspective_rays(width, height, fov=fov, origin=camera_position,
                            sample_xy=jitter)


def _assemble(rgb: torch.Tensor, *, spp, height, width) -> torch.Tensor:
    # Integer //spp average of integer sample colours (reference quirk).
    sample_sum = rgb.reshape(spp, height, width, 3).sum(dim=0)
    pixel = torch.floor(div_scalar(sample_sum, spp))
    return torch.clamp_max(div_scalar(pixel, 255.0), 1.0)


def render_path(scene: Scene, *, width: int, height: int, spp: int = 4,
                max_bounces: int = 3, fov: float = 60.0,
                camera_position=(0.0, 2.0, 0.0),
                mirror_threshold: float = 0.9,
                background=(2.0, 2.0, 5.0),
                jitter: Optional[torch.Tensor] = None,
                uniforms: Optional[torch.Tensor] = None,
                fb_uniforms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                guide_fn=None, fb_prob: float = 1.0, impl: str = "kernel",
                guide_max_level: Optional[int] = None,
                precision: str = "exact", device=None):
    """Render a ``[H, W, 3]`` unit-range image and its ``PathStats``.

    Runs on ``device`` (``cuda`` by default; the scene moves there).
    ``impl``: "kernel" (the CUDA path kernel, with a student guide inside
    it; its plain version for a CPU device), "hybrid" (one level kernel a
    bounce, the guide between levels), "stepwise" (one nearest-hit kernel
    a bounce, the guide between levels) or "plain" (the plain PyTorch
    version anywhere).  ``guide_fn``: a distilled student
    (``fb.registry.guide_for``) or, except for "kernel", any guide such as
    the full agent's (``TrainedFBAgent.as_guide_fn``), taken on diffuse
    bounces with probability ``fb_prob``; ``guide_max_level`` (stepwise
    only): the guide on the first that many levels only."""
    if guide_max_level is not None and impl not in ("stepwise",
                                                    "stepwise-pallas"):
        raise ValueError("guide_max_level requires impl='stepwise' "
                         "(see trace_path)")
    dev = resolve_device(device)
    scene = scene.to(dev)
    if jitter is None:
        if generator is None:
            raise ValueError("pass jitter [spp, H, W, 2] or a generator")
        jitter = torch.rand((spp, height, width, 2), generator=generator,
                            device=dev)
    elif tuple(jitter.shape) != (spp, height, width, 2):
        raise ValueError(f"jitter must be [{spp}, {height}, {width}, 2], "
                         f"got {tuple(jitter.shape)}")
    origins, dirs = _camera_bundle(jitter.to(dev), width=width,
                                   height=height, fov=fov,
                                   camera_position=camera_position)
    rgb, stats = trace_path(scene, origins, dirs, max_bounces=max_bounces,
                            mirror_threshold=mirror_threshold,
                            background=background, uniforms=uniforms,
                            fb_uniforms=fb_uniforms, generator=generator,
                            guide_fn=guide_fn, fb_prob=fb_prob, impl=impl,
                            guide_max_level=guide_max_level,
                            precision=precision)
    img = _assemble(rgb, spp=spp, height=height, width=width)
    return img, stats
