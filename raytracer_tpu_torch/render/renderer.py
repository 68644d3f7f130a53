"""Whitted frame renderer: camera rays, wavefront trace, shading, image.

Counterpart of ``raytracer_tpu/render/renderer.py::render_whitted`` (the
reference's per-pixel loops of RL/output5.py and the Planets/Marbles
notebook cells).  Two output conventions, both the reference's:
``mode="unit"`` is ``min(1, c/255)`` per channel (RL/output5.py:514-518);
``mode="raw"`` is the raw reference-unit colour, which may exceed 255.
Misses take ``miss_colour`` (Marbles 4's sky) and hits are shaded on
``background``.

``impl``: ``"kernel"`` traces through the whole-trace Whitted kernel and
shades through the Whitted shading kernel, its shadow sweeps inside
(float32; float64 raises); ``"plain"`` runs plain PyTorch in float32 or
float64 (the reference-parity goldens run float64 this way); ``"compact"``
traces the plain level on the live lanes only, compacted between levels,
each level's sweep the nearest-hit kernel and the shading the shading
kernel on ``cuda``, plain on the CPU (one host read a level; the image
equals ``"plain"``'s bit for
bit; it is JAX's API, kept for parity: on the card the whole-trace kernel
is several times faster, PERF.md §5); ``"auto"`` is ``"kernel"`` for rays on ``cuda`` and ``"plain"`` for
rays on the CPU.  The JAX package's ``impl="pallas"`` maps to ``"kernel"``
and ``"fused"`` to ``"plain"``; ``sweep="kernel"`` (with ``impl="plain"``)
is its ``use_pallas=True``.

``shade_flat`` is the trace-and-shade body of a flat wavefront, shared
with the frame renderer (``render/animation.py``) and the sharded renders
(``parallel/mesh.py``), as JAX's ``_shade_flat`` is.

``render_grid`` is the notebooks' grid frame of a library scene from its
``params`` (the grid camera, the bounces, the background and sky): the
CLI's ``render`` and the benchmark's Whitted cell call it.

Spans (``utils/profiling.py::span``, recorded under a ``torch.profiler``
session): ``raytracer.camera`` (``grid_rays``), ``raytracer.whitted_trace``
(the ``trace_whitted`` call), ``raytracer.shade`` (``terminal_rgb`` and the
misses' colour), ``raytracer.image`` (``finish``); ``raytracer.render``
holds a ``render_grid`` call.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import cuda_intersect
from ..core.device import resolve_device
from ..core.vec import div_scalar
from ..scene.types import GlobalLights, PointLights, Scene
from ..trace.shade import terminal_rgb
from ..trace.whitted import trace_whitted
from ..utils.profiling import span
from .camera import grid_rays


def material_flags(scene: Scene):
    """Does the scene hold any exactly-1.0 transparent / reflective sphere
    (the only values the Whitted tracer's ``== True`` rule reacts to)?
    ``(enable_glass, enable_mirror)``, read on the host."""
    return (bool((scene.transparent == 1.0).any()),
            bool((scene.reflective == 1.0).any()))


def shade_flat(scene: Scene, glights: GlobalLights, plights: PointLights,
               origins: torch.Tensor, dirs: torch.Tensor, *,
               max_bounces: int, background, miss_colour,
               enable_glass: bool, enable_mirror: bool, impl: str = "auto",
               sweep: str = "plain") -> torch.Tensor:
    """Flat ``[R, 3]`` reference-unit shading of a ray wavefront on the
    rays' device (the scene and lights move there): hits shaded on
    ``background``, misses ``miss_colour`` (None: the background)."""
    dev = origins.device
    if impl == "auto":
        impl = "kernel" if dev.type == "cuda" else "plain"
    if impl not in ("kernel", "plain", "compact"):
        raise ValueError(f"unknown impl {impl!r}")
    scene, glights, plights = scene.to(dev), glights.to(dev), plights.to(dev)
    background = tuple(float(b) for b in background)
    if miss_colour is not None:
        miss_colour = tuple(float(c) for c in miss_colour)
    with span("raytracer.whitted_trace"):
        # One table for the trace and the shading.  Its mirror and glass
        # columns follow the flags, which material_flags sets False only
        # where no sphere has the value (so they equal the scene's
        # reflective == 1 and transparent == 1 either way); the shading
        # reads only the table's geometry and ids.
        table = cuda_intersect.sphere_table(scene, enable_glass,
                                            enable_mirror)
        res = trace_whitted(scene, origins, dirs, max_bounces, impl=impl,
                            sweep=sweep, table=table)
    # Compact shades through the shading kernel on the card, as the
    # kernel route does.
    shade_impl = ("plain" if impl == "plain"
                  or (impl == "compact" and dev.type != "cuda")
                  else "kernel")
    with span("raytracer.shade"):
        return terminal_rgb(scene, glights, plights, res, background,
                            impl=shade_impl, table=table,
                            miss_colour=miss_colour)


def finish(flat: torch.Tensor, height: int, width: int,
           mode: str) -> torch.Tensor:
    """The first ``height * width`` shaded rays as an ``[H, W, 3]`` image in
    ``mode`` ("unit": ``min(1, c/255)``; "raw")."""
    img = flat[:height * width].reshape(height, width, 3)
    if mode == "unit":
        return torch.clamp_max(div_scalar(img, 255.0), 1.0)
    return img


def render_whitted(scene: Scene, glights: GlobalLights, plights: PointLights,
                   origins: torch.Tensor, dirs: torch.Tensor, height: int,
                   width: int, *, max_bounces: int = 5,
                   background=(0.0, 0.0, 0.0),
                   miss_colour: Optional[tuple] = None, mode: str = "unit",
                   chunk_rays: Optional[int] = None, impl: str = "auto",
                   sweep: str = "plain",
                   n_valid: Optional[int] = None) -> torch.Tensor:
    """Render an ``[H, W, 3]`` frame on the rays' device (the scene and
    lights move there).

    ``chunk_rays``: trace and shade in chunks of this many rays, the last
    one padded with copies of its last ray (bounded memory for mega
    frames).  ``n_valid``: only the first ``n_valid == height * width``
    rays form the image (a padded wavefront)."""
    if mode not in ("unit", "raw"):
        raise ValueError(f"unknown mode {mode!r}")
    n = origins.shape[0]
    n_out = n if n_valid is None else n_valid
    if n_out != height * width:
        raise ValueError(f"n_valid/ray count {n_out} != {height}x{width}")
    enable_glass, enable_mirror = material_flags(scene)
    kw = dict(max_bounces=max_bounces, background=background,
              miss_colour=miss_colour, enable_glass=enable_glass,
              enable_mirror=enable_mirror, impl=impl, sweep=sweep)
    if chunk_rays is None or chunk_rays >= n:
        flat = shade_flat(scene, glights, plights, origins, dirs, **kw)
    else:
        parts = []
        for i in range(0, n, chunk_rays):
            o, d = origins[i:i + chunk_rays], dirs[i:i + chunk_rays]
            pad = chunk_rays - o.shape[0]
            if pad:                        # edge padding, as JAX pads
                o = torch.cat([o, o[-1:].expand(pad, 3)])
                d = torch.cat([d, d[-1:].expand(pad, 3)])
            parts.append(shade_flat(scene, glights, plights, o, d, **kw))
        flat = torch.cat(parts)
    with span("raytracer.image"):
        return finish(flat, height, width, mode)


def render_grid(scene: Scene, glights: GlobalLights, plights: PointLights,
                params: dict, *, eye=None, multiple: Optional[int] = None,
                device=None, mode: str = "unit") -> torch.Tensor:
    """The notebooks' grid frame of a library scene, ``[H, W, 3]`` on
    ``device``: ``grid_rays(params["ray_count"], params["ray_step"],
    multiple or params["multiple"])`` from ``eye`` (three numbers or a
    ``[3]`` tensor; ``params["camera_position"]`` by default), built on the
    device, then ``render_whitted`` with ``params``' ``max_bounces``,
    ``background`` and ``sky_colour`` (misses; the background without
    one): the kernels on ``cuda``, plain PyTorch on the CPU.  No
    randomness is drawn."""
    dev = resolve_device(device)
    with span("raytracer.render"):
        with span("raytracer.camera"):
            origins, dirs, h, w = grid_rays(
                params["ray_count"], params["ray_step"],
                multiple or params.get("multiple", 1),
                origin=params["camera_position"] if eye is None else eye,
                device=dev)
        return render_whitted(scene, glights, plights, origins, dirs, h, w,
                              max_bounces=params["max_bounces"],
                              background=params["background"],
                              miss_colour=params.get("sky_colour"),
                              mode=mode)
