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

``spp_chunk`` (JAX ``_render_path_chunked``): the ``spp`` samples trace as
``spp // spp_chunk`` independent sub-renders of ``spp_chunk x H x W`` rays,
so only one chunk's wavefront is live; the integer sample sums add up and
one ``floor(total / spp)`` makes the image.  Chunk ``c`` takes the jitter
rows ``[c*spp_chunk, (c+1)*spp_chunk)`` and ``uniforms[c]`` /
``fb_uniforms[c]`` of ``[chunks, max_bounces, R_chunk, ...]`` planes (JAX:
``keys = split(key, chunks)``, then each chunk's ``k_jit, k_trace =
split(k)``); a generator draws each chunk's planes in turn.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.vec import div_scalar
from ..scene.types import Scene
from ..trace.path import PathStats, trace_path
from ..utils.profiling import span, spanned
from .camera import perspective_rays


def _camera_bundle(jitter: torch.Tensor, *, width, height, fov,
                   camera_position):
    """Rays for every sample of every pixel: ``[spp*H*W, 3]`` each."""
    return perspective_rays(width, height, fov=fov, origin=camera_position,
                            sample_xy=jitter)


def _average(sample_sum: torch.Tensor, spp: int) -> torch.Tensor:
    # Integer //spp average of integer sample colours (reference quirk).
    pixel = torch.floor(div_scalar(sample_sum, spp))
    return torch.clamp_max(div_scalar(pixel, 255.0), 1.0)


@spanned("raytracer.render")
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
                precision: str = "exact", spp_chunk: Optional[int] = None,
                device=None):
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
    only): the guide on the first that many levels only; ``spp_chunk``
    ("kernel" and "plain" only, dividing ``spp``): the chunked render of
    the module note."""
    if guide_max_level is not None and impl not in ("stepwise",
                                                    "stepwise-pallas"):
        raise ValueError("guide_max_level requires impl='stepwise' "
                         "(see trace_path)")
    if spp_chunk is not None and impl not in ("kernel", "plain"):
        raise ValueError(f"impl={impl!r} traces the full wavefront; "
                         "spp_chunk applies to impl='kernel' or 'plain'")
    with span("raytracer.render_setup"):
        dev = resolve_device(device)
        scene = scene.to(dev)
    chunked = spp_chunk is not None and spp_chunk < spp
    if chunked and spp % spp_chunk:
        raise ValueError(f"spp={spp} not divisible by spp_chunk={spp_chunk}")
    per = spp_chunk if chunked else spp
    chunks = spp // per
    if jitter is None and generator is None:
        raise ValueError("pass jitter [spp, H, W, 2] or a generator")
    if jitter is not None and tuple(jitter.shape) != (spp, height, width, 2):
        raise ValueError(f"jitter must be [{spp}, {height}, {width}, 2], "
                         f"got {tuple(jitter.shape)}")
    for name, plane in (("uniforms", uniforms), ("fb_uniforms", fb_uniforms)):
        if chunked and plane is not None and plane.shape[0] != chunks:
            raise ValueError(f"{name} must hold one plane a chunk "
                             f"[{chunks}, ...], got {tuple(plane.shape)}")
    total, stats = None, []
    for c in range(chunks):
        with span("raytracer.camera"):
            if jitter is None:
                jit_c = torch.rand((per, height, width, 2),
                                   generator=generator, device=dev)
            else:
                jit_c = jitter[c * per:(c + 1) * per].to(dev)
            origins, dirs = _camera_bundle(jit_c, width=width, height=height,
                                           fov=fov,
                                           camera_position=camera_position)
        rgb, st = trace_path(
            scene, origins, dirs, max_bounces=max_bounces,
            mirror_threshold=mirror_threshold, background=background,
            uniforms=_chunk_plane(uniforms, c, chunked),
            fb_uniforms=_chunk_plane(fb_uniforms, c, chunked),
            generator=generator, guide_fn=guide_fn, fb_prob=fb_prob,
            impl=impl, guide_max_level=guide_max_level, precision=precision)
        with span("raytracer.image"):
            sums = rgb.reshape(per, height, width, 3).sum(dim=0)
            total = sums if total is None else total + sums
        stats.append(st)
    with span("raytracer.image"):
        if chunks == 1:
            return _average(total, spp), stats[0]
        return _average(total, spp), PathStats(
            *(sum(getattr(s, f.name) for s in stats)
              for f in dataclasses.fields(PathStats)))


def _chunk_plane(plane, c: int, chunked: bool):
    """Chunk ``c``'s draw plane: ``plane[c]`` of a chunked render's
    ``[chunks, ...]`` planes, else the plane (or None) as given."""
    return plane[c] if chunked and plane is not None else plane
