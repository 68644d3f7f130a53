"""Multi-device renders over a grid of devices.

Counterpart of ``raytracer_tpu/parallel/mesh.py``, over ``torch.device``s
and not over a JAX mesh: a ``Mesh`` is a ``[dp, tp]`` grid of devices.

* Rendering is data parallel over the ray axis: the rays split into ``dp``
  contiguous shards (the last padded by copies of the final ray, as JAX
  pads), each traced and shaded on its row's first device with the scene
  copied there; the shards are gathered onto the first device and the
  padding cropped.  Frames split over ``dp`` the same way.
* A guide's wide layers split their kernel's last axis over a row's
  ``tp`` devices, as JAX's placement does (``shard_fb_params``); the
  blocks concatenate on the input's device.  The guide runs on its own device: observations of a shard on
  another device go there and back.

Each shard runs the single-device code (``render/renderer.py::
shade_flat``, ``render/animation.py``, ``trace/path.py::trace_path``), so
a sharded render equals the unsharded one on the same rays and planes; the
kernels launch on the shard's device, with their tables built there.
``make_mesh(devices=["cpu"] * 8)`` runs the split on the CPU, and
``devices=["cuda:0"] * 2`` on one card.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from ..fb.networks import Dense
from ..render.animation import render_whitted_frames
from ..render.camera import perspective_rays
from ..render.path_renderer import _average
from ..render.renderer import finish, material_flags, shade_flat
from ..trace.path import PathStats, is_student, trace_path


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device of data-parallel row ``i`` and tensor-
    parallel column ``j``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def rows(self) -> List[torch.device]:
        """Each dp row's first device: where its shard renders."""
        return [row[0] for row in self.devices]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``[dp, tp]`` mesh with ``dp = n // tp`` over ``devices`` (the
    visible CUDA devices by default; raises without a card), the first
    ``n_devices`` of them."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs) or n % tp:
        raise ValueError(f"{n} devices of {len(devs)} do not make rows of "
                         f"tp={tp}")
    devs = devs[:n]
    return Mesh(tuple(tuple(devs[i:i + tp]) for i in range(0, n, tp)))


def _pad_split(a: torch.Tensor, parts: int, axis: int = 0):
    """``a`` padded along ``axis`` to a multiple of ``parts`` by copies of
    its last entry, then split into ``parts`` contiguous blocks."""
    n = a.shape[axis]
    pad = (-n) % parts
    if pad:
        last = a.narrow(axis, n - 1, 1)
        a = torch.cat([a, last.expand(*(pad if i == axis else s
                                         for i, s in enumerate(last.shape)))],
                      dim=axis)
    return list(a.chunk(parts, dim=axis))


def shard_rays(mesh: Mesh, *arrays):
    """The ray-wavefront ``arrays`` padded to a multiple of ``dp`` by edge
    replication (a zero direction would NaN in normalisation; a duplicated
    live ray is safe and cropped after) and split into ``dp`` contiguous
    shards, shard ``i`` on row ``i``'s device.  Returns ``(one list of
    shards an array, the original length)``."""
    n0 = arrays[0].shape[0]
    out = [[s.to(dev).contiguous() for s, dev in
            zip(_pad_split(a, len(mesh.rows)), mesh.rows)] for a in arrays]
    return out, n0


def replicate(mesh: Mesh, obj):
    """``obj`` (a tensor or a record with ``.to``: a scene, lights) copied
    to each dp row's device, one copy a row."""
    return [obj.to(dev) for dev in mesh.rows]


class ShardedDense(nn.Module):
    """A ``Dense`` whose kernel's last (output) axis splits into
    ``len(devices)`` blocks, as JAX's ``P(..., "tp")`` splits it: block
    ``j`` and its bias on ``devices[j]``, ``x @ kernel_j + bias_j``
    computed there, the blocks interleaved back into the layer's output
    order on ``x``'s device.  Each output column is computed as in the
    whole layer; the sum order of the product may differ."""

    def __init__(self, dense: Dense, devices: Sequence[torch.device]):
        super().__init__()
        tp = len(devices)
        self.in_shape, self.out_shape = dense.in_shape, dense.out_shape
        k = dense.kernel.detach().reshape(math.prod(self.in_shape),
                                          *self.out_shape)
        self.kernels = nn.ParameterList(
            nn.Parameter(kj.reshape(k.shape[0], -1).to(d), requires_grad=False)
            for kj, d in zip(k.chunk(tp, dim=-1), devices))
        self.biases = nn.ParameterList(
            nn.Parameter(bj.reshape(-1).to(d), requires_grad=False)
            for bj, d in zip(dense.bias.detach().chunk(tp, dim=-1), devices))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = self.out_shape[:-1]
        blocks = [torch.matmul(x.to(k.device), k).add_(b).to(x.device)
                  .reshape(*x.shape[:-1], *lead, -1)
                  for k, b in zip(self.kernels, self.biases)]
        return torch.cat(blocks, -1).reshape(*x.shape[:-1], -1)


def shard_fb_params(mesh: Mesh, module: nn.Module,
                    min_dim: int = 128) -> nn.Module:
    """A copy of an FB network with tensor-parallel placement, JAX's rule:
    each ``Dense`` whose kernel's last axis is at least ``min_dim`` wide
    and divisible by ``tp`` splits that axis over the first row's ``tp``
    devices (``ShardedDense``; its bias splits with it, where JAX splits
    only a bias of two or more axes); every other parameter stays on the
    module's device."""
    tp = mesh.shape["tp"]
    out = copy.deepcopy(module)
    for name, child in list(out.named_modules()):
        if not isinstance(child, Dense):
            continue
        width = child.out_shape[-1]
        if width >= min_dim and width % tp == 0:
            parent, _, attr = name.rpartition(".")
            holder = out.get_submodule(parent) if parent else out
            setattr(holder, attr, ShardedDense(child, mesh.devices[0]))
    return out


def render_whitted_sharded(mesh: Mesh, scene, glights, plights, origins,
                           dirs, height: int, width: int, *,
                           max_bounces: int = 5, background=(0.0, 0.0, 0.0),
                           miss_colour=None, mode: str = "unit",
                           impl: str = "auto") -> torch.Tensor:
    """Data-parallel Whitted render: each contiguous ray shard traced and
    shaded on its row's device through ``shade_flat``, the shards gathered
    onto the first device, the padding cropped (``n_valid``)."""
    if mode not in ("unit", "raw"):
        raise ValueError(f"unknown mode {mode!r}")
    if origins.shape[0] != height * width:
        raise ValueError(f"ray count {origins.shape[0]} != {height}x{width}")
    enable_glass, enable_mirror = material_flags(scene)
    (o, d), _ = shard_rays(mesh, origins, dirs)
    kw = dict(max_bounces=max_bounces, background=background,
              miss_colour=miss_colour, enable_glass=enable_glass,
              enable_mirror=enable_mirror, impl=impl)
    first = mesh.rows[0]
    flat = torch.cat([shade_flat(scene, glights, plights, oi, di,
                                 **kw).to(first) for oi, di in zip(o, d)])
    return finish(flat, height, width, mode)


def render_whitted_frames_sharded(mesh: Mesh, scene, glights, plights,
                                  origins, dirs, height: int, width: int, *,
                                  max_bounces: int = 5,
                                  background=(0.0, 0.0, 0.0),
                                  miss_colour=None, mode: str = "unit",
                                  impl: str = "auto") -> torch.Tensor:
    """Frame-parallel serving: ``origins``/``dirs`` ``[F, R, 3]`` split over
    ``dp`` in contiguous groups (``F`` padded by copies of the last frame,
    cropped after), each row rendering its frames through
    ``render_whitted_frames``; gathered onto the first device."""
    f0 = origins.shape[0]
    (o, d), _ = shard_rays(mesh, origins, dirs)
    first = mesh.rows[0]
    frames = [render_whitted_frames(
        scene, glights, plights, oi, di, height, width,
        max_bounces=max_bounces, background=background,
        miss_colour=miss_colour, mode=mode, impl=impl).to(first)
        for oi, di in zip(o, d)]
    return torch.cat(frames)[:f0]


def _on_guide_device(guide_fn):
    """``guide_fn`` called on its own device (an agent's ``device``, where
    its networks are), the observations moved there and back.  A student
    (or any guide without a ``device``) runs where the observations are."""
    dev = getattr(guide_fn, "device", None)
    if guide_fn is None or dev is None or is_student(guide_fn):
        return guide_fn
    return lambda obs: guide_fn(obs.to(dev)).to(obs.device)


def render_path_sharded(mesh: Mesh, scene, *, width: int, height: int,
                        spp: int = 4, max_bounces: int = 3, fov: float = 60.0,
                        camera_position=(0.0, 2.0, 0.0),
                        mirror_threshold: float = 0.9,
                        background=(2.0, 2.0, 5.0), guide_fn=None,
                        fb_prob: float = 1.0,
                        jitter: Optional[torch.Tensor] = None,
                        uniforms: Optional[torch.Tensor] = None,
                        fb_uniforms: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        impl: str = "stepwise"):
    """Data-parallel path-traced render: the ``spp * H * W`` sample
    wavefront splits over ``dp`` (padded as ``shard_rays`` pads), each
    shard traced on its row's device through ``trace_path(impl=...)``; the
    image assembles on the first device and the shards' ``PathStats`` sum
    (padding rays included, as JAX's do).

    Draws (JAX: ``k_jit, k_trace = split(key)``): ``jitter [spp, H, W,
    2]``, then the trace planes over the PADDED wavefront, ``uniforms
    [max_bounces, Rp, 2]`` and, guided, ``fb_uniforms [max_bounces, Rp]``
    (JAX's ``trace_path`` sees the padded length); a generator on the first
    device draws those not given, in that order."""
    first = mesh.rows[0]
    dp = len(mesh.rows)
    if jitter is None:
        if generator is None:
            raise ValueError("pass jitter [spp, H, W, 2] or a generator")
        jitter = torch.rand((spp, height, width, 2), generator=generator,
                            device=first)
    origins, dirs = perspective_rays(width, height, fov=fov,
                                     origin=camera_position,
                                     sample_xy=jitter.to(first))
    (o, d), n0 = shard_rays(mesh, origins, dirs)
    rp = n0 + (-n0) % dp
    planes = []
    for name, plane, shape in (
            ("uniforms", uniforms, (max_bounces, rp, 2)),
            ("fb_uniforms", fb_uniforms, (max_bounces, rp))):
        if plane is None and generator is not None and (
                name == "uniforms" or guide_fn is not None):
            plane = torch.rand(shape, generator=generator, device=first)
        if plane is not None and tuple(plane.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} (the padded "
                             f"wavefront), got {tuple(plane.shape)}")
        planes.append([None] * dp if plane is None
                      else [p.to(dev) for p, dev in
                            zip(plane.chunk(dp, dim=1), mesh.rows)])
    guide = _on_guide_device(guide_fn)
    rgbs, stats = [], []
    for i, dev in enumerate(mesh.rows):
        rgb, st = trace_path(
            scene.to(dev), o[i], d[i], max_bounces=max_bounces,
            mirror_threshold=mirror_threshold, background=background,
            uniforms=planes[0][i], fb_uniforms=planes[1][i],
            guide_fn=guide, fb_prob=fb_prob, impl=impl)
        rgbs.append(rgb.to(first))
        stats.append(PathStats(*(getattr(st, f.name).to(first)
                                 for f in dataclasses.fields(PathStats))))
    rgb = torch.cat(rgbs)[:n0]
    img = _average(rgb.reshape(spp, height, width, 3).sum(0), spp)
    return img, PathStats(*(sum(getattr(s, f.name) for s in stats)
                            for f in dataclasses.fields(PathStats)))
