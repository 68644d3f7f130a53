"""Camera paths and multi-frame rendering: the serving path.

Counterpart of ``raytracer_tpu/render/animation.py``: look-at cameras
(the env camera's single-aspect NDC mapping, RL/ray_tracer_env.py:121-134,
with its fixed ``(x, y, -1)`` direction generalised to an orthonormal
look-at basis), orbit and dolly paths, and turntables through the Whitted
and path tracers.

JAX maps one compiled program over the frames (``lax.map``), one dispatch
for the sequence.  The port loops over the frames on the host: each
Whitted frame is ``render/renderer.py::shade_flat`` on that frame's rays
(the Whitted kernel and the shading kernel, its shadow sweeps inside, on
``cuda``; the plain route on the CPU), so every frame equals the
single-frame ``render_whitted`` of the same rays bit for bit, JAX's own
contract.  Each path frame is one ``trace_path`` through ``impl``
("kernel": ``csrc/path_trace.cu`` unguided or with an f32 student,
``csrc/path_guided.cu`` with a bf16 student).

The camera builds on the rays' device in float32, one rounding per written
operation, as JAX's runs with 64-bit mode off; ``orbit_eyes`` and
``lerp_eyes`` build in numpy float64 and cast once, as JAX's do.

Randomness comes in as planes, in the JAX schedule of
``render_path_frames`` (``keys = split(key, F)``, then each frame's
``k_jit, k_trace = split(k)``): ``jitter [F, spp, H, W, 2]``,
``uniforms [F, max_bounces, R, 2]`` and, guided, ``fb_uniforms [F,
max_bounces, R]`` with ``R = spp * H * W``.  A ``torch.Generator`` draws
the planes not passed, frame by frame: jitter, uniforms, fb plane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import vec
from ..core.device import resolve_device
from ..core.vec import div_scalar
from ..scene.types import GlobalLights, PointLights, Scene
from ..trace.path import PathStats, trace_path
from .path_renderer import _average
from .renderer import finish, material_flags, shade_flat


# ``jnp.cross`` and ``jnp.linalg.norm`` are jitted XLA programs even when
# their caller runs eagerly, and XLA on the CPU contracts a product and the
# add after it into one fused multiply-add.  The port does the same: an fma
# is one rounding of the exact ``a * b + c`` (float64 holds the float32
# product exactly).


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _cross(a, b):
    """``jnp.cross`` on ``[..., 3]``: ``a1 b2 - a2 b1`` as
    ``fma(a1, b2, -(a2 b1))``, and so on."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
                        _fma(a0, b1, -(a1 * b0))], -1)


def _norm(v):
    """``jnp.linalg.norm(v, axis=-1)``: ``sqrt(fma(z, z, fma(y, y,
    x * x)))``."""
    x, y, z = v.unbind(-1)
    return vec.sqrt(_fma(z, z, _fma(y, y, x * x)))


def _unit(v):
    """``v / jnp.linalg.norm(v, axis=-1, keepdims=True)``."""
    return v / _norm(v)[..., None]


def _look_at(width, height, eye, target, fov, up, sample_xy):
    """Directions ``[F, ..., H*W, 3]`` for eyes/targets ``[F, 3]``."""
    dev = eye.device
    f32 = torch.float32
    fwd = _unit(target - eye)
    right = _unit(_cross(fwd, up.expand_as(fwd)))
    cam_up = _cross(right, fwd)
    aspect = width / height
    half = float(np.tan(np.radians(fov) / 2))
    px = torch.arange(width, dtype=f32, device=dev)[None, :]
    py = torch.arange(height, dtype=f32, device=dev)[:, None]
    if sample_xy is None:
        ox_s = oy_s = torch.tensor(0.5, dtype=f32, device=dev)
    else:
        ox_s = sample_xy[..., 0].to(f32)
        oy_s = sample_xy[..., 1].to(f32)
    sx = (div_scalar(2.0 * (px + ox_s), width) - 1.0) * aspect * half
    sy = (1.0 - div_scalar(2.0 * (py + oy_s), height)) * half
    sx, sy = torch.broadcast_tensors(sx, sy)
    lead = (1,) * sx.dim()
    F = eye.shape[0]
    right, cam_up, fwd = (t.reshape(F, *lead, 3) for t in (right, cam_up,
                                                          fwd))
    dirs = sx[..., None] * right + sy[..., None] * cam_up + fwd
    return _unit(dirs).reshape(F, -1, 3)


def look_at_rays(width: int, height: int, *, eye, target, fov: float = 60.0,
                 up=(0.0, 1.0, 0.0), sample_xy: Optional[torch.Tensor] = None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective rays from ``eye`` toward ``target``, float32:
    ``(origins [N, 3], dirs [N, 3])``, dirs unit length, ``N`` = samples x
    H x W.  ``sample_xy``: optional ``[..., H, W, 2]`` sub-pixel offsets in
    [0, 1) (spp jitter, samples outermost); pixel centres by default.  On
    ``sample_xy``'s device, else ``device`` (``cuda`` by default)."""
    dev = resolve_device(device) if sample_xy is None else sample_xy.device
    eye_t, target_t = (_point(v, dev).reshape(1, 3) for v in (eye, target))
    up_t = torch.tensor(up, dtype=torch.float32, device=dev)
    dirs = _look_at(width, height, eye_t, target_t, fov, up_t,
                    sample_xy)[0]
    return eye_t[0].expand_as(dirs), dirs


def orbit_eyes(center, radius: float, y: float, n_frames: int, *,
               start_angle: float = 0.0, sweep: float = 2 * np.pi,
               device=None) -> torch.Tensor:
    """``[F, 3]`` float32 camera positions on a horizontal circle of
    ``radius`` around ``center`` at height ``y`` (a turntable).  Frame 0
    sits at ``start_angle`` (0: the +z side, where the canonical scenes'
    cameras look down -z); a full turn leaves out its endpoint, a partial
    ``sweep`` keeps both."""
    center = np.asarray(center, np.float64)
    closed = abs(sweep - 2 * np.pi) < 1e-12
    ang = start_angle + (np.linspace(0.0, sweep, n_frames,
                                     endpoint=not closed)
                         if n_frames > 1 else np.array([0.0]))
    xs = center[0] + radius * np.sin(ang)
    zs = center[2] + radius * np.cos(ang)
    ys = np.full_like(xs, y)
    return torch.from_numpy(np.stack([xs, ys, zs], axis=-1)).to(
        torch.float32).to(resolve_device(device))


def lerp_eyes(start, end, n_frames: int, device=None) -> torch.Tensor:
    """``[F, 3]`` float32 linear dolly path from ``start`` to ``end``
    inclusive."""
    t = np.linspace(0.0, 1.0, max(n_frames, 1))[:, None]
    path = ((1 - t) * np.asarray(start, np.float64)
            + t * np.asarray(end, np.float64))
    return torch.from_numpy(path).to(torch.float32).to(
        resolve_device(device))


def turntable(scene: Scene, camera_position, n_frames: int, *,
              target=None, radius: Optional[float] = None,
              y: Optional[float] = None, sweep: float = 2 * np.pi,
              device=None):
    """The CLI's ``animate`` orbit (JAX ``cmd_animate``): ``n_frames`` eyes
    around ``target`` (default ``scene_focus``), at ``radius`` (default the
    camera's horizontal distance to the target, or 3.0 where that is 0)
    and height ``y`` (default the camera's).  Returns ``(eyes [F, 3],
    target, radius, y)``, the target float64 numpy."""
    target = (scene_focus(scene) if target is None
              else np.asarray(target, float))
    cam = np.asarray(camera_position, float)
    if radius is None:
        radius = float(np.hypot(*(cam - target)[[0, 2]])) or 3.0
    y = float(cam[1]) if y is None else y
    eyes = orbit_eyes(target, radius, y, n_frames, sweep=sweep,
                      device=device)
    return eyes, target, radius, y


def _point(v, dev) -> torch.Tensor:
    """A point (or points) as float32 on ``dev``, rounded once from float64
    as ``jnp.asarray(v, float32)`` rounds it."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float64))
    return v.to(torch.float32).to(dev)


def _targets(eyes: torch.Tensor, target) -> torch.Tensor:
    """``target`` (a point or ``[F, 3]``) as float32 ``[F, 3]`` on the
    eyes' device."""
    target = _point(target, eyes.device)
    return target.expand_as(eyes) if target.dim() == 1 else target


def camera_path_rays(eyes: torch.Tensor, target, width: int, height: int,
                     *, fov: float = 60.0, up=(0.0, 1.0, 0.0)
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for every frame of a camera path on the eyes' device: ``eyes
    [F, 3]`` all looking at ``target`` (a point or ``[F, 3]``).  Returns
    ``(origins [F, R, 3], dirs [F, R, 3])``."""
    eyes = eyes.to(torch.float32)
    up_t = torch.tensor(up, dtype=torch.float32, device=eyes.device)
    dirs = _look_at(width, height, eyes, _targets(eyes, target), fov, up_t,
                    None)
    return eyes[:, None, :].expand_as(dirs), dirs


def render_whitted_frames(scene: Scene, glights: GlobalLights,
                          plights: PointLights, origins: torch.Tensor,
                          dirs: torch.Tensor, height: int, width: int, *,
                          max_bounces: int = 5, background=(0.0, 0.0, 0.0),
                          miss_colour: Optional[tuple] = None,
                          mode: str = "unit",
                          impl: str = "auto") -> torch.Tensor:
    """``[F, H, W, 3]`` frames from ``origins``/``dirs`` ``[F, R, 3]``, on
    the rays' device, one frame live at a time; each equals
    ``render_whitted`` of that frame's rays with the same ``impl``."""
    if mode not in ("unit", "raw"):
        raise ValueError(f"unknown mode {mode!r}")
    enable_glass, enable_mirror = material_flags(scene)
    kw = dict(max_bounces=max_bounces, background=background,
              miss_colour=miss_colour, enable_glass=enable_glass,
              enable_mirror=enable_mirror, impl=impl)
    return torch.stack([
        finish(shade_flat(scene, glights, plights, origins[f].contiguous(),
                          dirs[f].contiguous(), **kw), height, width, mode)
        for f in range(origins.shape[0])])


def render_path_frames(scene: Scene, eyes: torch.Tensor, target, *,
                       width: int, height: int, spp: int = 4,
                       max_bounces: int = 3, fov: float = 60.0,
                       mirror_threshold: float = 0.9,
                       background=(2.0, 2.0, 5.0), guide_fn=None,
                       fb_prob: float = 1.0,
                       jitter: Optional[torch.Tensor] = None,
                       uniforms: Optional[torch.Tensor] = None,
                       fb_uniforms: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       impl: str = "kernel", device=None):
    """A path-traced camera path: ``[F, H, W, 3]`` unit-range frames and
    the frames' summed ``PathStats``, on ``device`` (``cuda`` by default;
    the scene moves there).

    ``eyes [F, 3]`` look at ``target`` (a point or ``[F, 3]``) with the
    look-at camera and per-sample jitter; pixels are the integer
    ``floor(sum / spp)`` average (``render_path``).  Each frame is one
    ``trace_path`` through ``impl`` (a student ``guide_fn`` runs inside the
    path kernel); draws as in the module note."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    eyes = eyes.to(dev, torch.float32)
    targets = _targets(eyes, target)
    if jitter is None and generator is None:
        raise ValueError("pass jitter [F, spp, H, W, 2] or a generator")
    if jitter is not None and tuple(jitter.shape[1:]) != (spp, height,
                                                          width, 2):
        raise ValueError(f"jitter must be [F, {spp}, {height}, {width}, 2],"
                         f" got {tuple(jitter.shape)}")
    up = torch.tensor((0.0, 1.0, 0.0), dtype=torch.float32, device=dev)
    frames, stats = [], []
    for f in range(eyes.shape[0]):
        jit = (torch.rand((spp, height, width, 2), generator=generator,
                          device=dev) if jitter is None
               else jitter[f].to(dev, torch.float32))
        d = _look_at(width, height, eyes[f:f + 1], targets[f:f + 1], fov, up,
                     jit)[0]
        rgb, st = trace_path(
            scene, eyes[f].expand_as(d), d, max_bounces=max_bounces,
            mirror_threshold=mirror_threshold, background=background,
            uniforms=None if uniforms is None else uniforms[f],
            fb_uniforms=None if fb_uniforms is None else fb_uniforms[f],
            generator=generator, guide_fn=guide_fn, fb_prob=fb_prob,
            impl=impl)
        frames.append(_average(rgb.reshape(spp, height, width, 3).sum(0),
                               spp))
        stats.append(st)
    return torch.stack(frames), PathStats(
        *(sum(getattr(s, fl.name) for s in stats)
          for fl in dataclasses.fields(PathStats)))


def scene_focus(scene: Scene) -> np.ndarray:
    """Default look-at target: the per-axis median centre of the scene's
    non-wall spheres (radius < 50; the canonical scenes' room spheres are
    r = 99 or 1000), float64 on the host.  Median, not mean: one distant
    backdrop sphere must not drag the target out of the cluster."""
    c = scene.centre.detach().cpu().numpy().astype(np.float64)
    r = scene.radius.detach().cpu().numpy().astype(np.float64)
    live = (r > 0) & (r < 50.0)
    if not live.any():
        live = r > 0
    return np.median(c[live], axis=0)
