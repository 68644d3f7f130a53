"""Struct-of-arrays sphere scene as PyTorch tensors.

Counterpart of ``raytracer_tpu/scene/types.py``: the same ``Scene`` fields,
the same ``SphereSpec``/``SceneBuilder`` API and the same construction
(sphere values gathered as float64 numpy, then cast once; light values
rounded once to float32, then cast), so the tables are bit-identical to
the JAX package's.  ``GlobalLights``/``PointLights`` are the Whitted
tracer's lights.

Material semantics are those of the JAX package: floats are stored and
each tracer applies its own rule (the path tracers threshold
``reflective`` against ``mirror_threshold``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence

import numpy as np
import torch

from ..core.device import resolve_device


class _Record:
    """Frozen dataclass of tensors: ``replace`` and ``to``."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class Scene(_Record):
    """Sphere-only scene as stacked tensors (all shape [N] or [N, 3])."""

    centre: torch.Tensor       # [N, 3] f32
    radius: torch.Tensor       # [N]    f32
    colour: torch.Tensor       # [N, 3] f32, RGB in 0..255 reference units
    reflective: torch.Tensor   # [N]    f32
    transparent: torch.Tensor  # [N]    f32
    emitive: torch.Tensor      # [N]    f32
    ior: torch.Tensor          # [N]    f32, refractive index
    id: torch.Tensor           # [N]    i32

    @property
    def num_spheres(self) -> int:
        return self.centre.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centre.device


@dataclasses.dataclass(frozen=True)
class GlobalLights(_Record):
    """Directional lights (reference RL/light.py:12-22).  ``vector`` is the
    direction the light comes from; shading compares the surface normal
    with it under a linear angular falloff."""

    vector: torch.Tensor     # [G, 3] f32
    colour: torch.Tensor     # [G, 3] f32
    strength: torch.Tensor   # [G]    f32
    max_angle: torch.Tensor  # [G]    f32 (radians)

    @property
    def count(self) -> int:
        return self.vector.shape[0]


@dataclasses.dataclass(frozen=True)
class PointLights(_Record):
    """Point lights (reference RL/light.py:25-37).  ``id`` matches the
    emitting sphere's id; ``func == -1``: no distance term, ``func == 0``:
    divide by the distance (linear, a reference quirk kept)."""

    id: torch.Tensor         # [P]    i32
    position: torch.Tensor   # [P, 3] f32
    colour: torch.Tensor     # [P, 3] f32
    strength: torch.Tensor   # [P]    f32
    max_angle: torch.Tensor  # [P]    f32
    func: torch.Tensor       # [P]    i32

    @property
    def count(self) -> int:
        return self.id.shape[0]


def empty_global_lights(device=None) -> GlobalLights:
    dev = resolve_device(device)
    z = torch.zeros((0,), device=dev)
    return GlobalLights(vector=torch.zeros((0, 3), device=dev),
                        colour=torch.zeros((0, 3), device=dev),
                        strength=z, max_angle=z.clone())


def empty_point_lights(device=None) -> PointLights:
    dev = resolve_device(device)
    z = torch.zeros((0,), device=dev)
    zi = torch.zeros((0,), dtype=torch.int32, device=dev)
    return PointLights(id=zi, position=torch.zeros((0, 3), device=dev),
                       colour=torch.zeros((0, 3), device=dev),
                       strength=z, max_angle=z.clone(), func=zi.clone())


@dataclasses.dataclass
class SphereSpec:
    centre: Sequence[float]
    radius: float
    colour: Sequence[float] = (128, 128, 128)
    reflective: float = 0.0
    transparent: float = 0.0
    emitive: float = 0.0
    ior: float = 1.0
    id: int = 0


class SceneBuilder:
    """Accumulates sphere and light specs on the host and emits the tensor
    scene and light tables."""

    def __init__(self) -> None:
        self.spheres: List[SphereSpec] = []
        self._glights: List[dict] = []
        self._plights: List[dict] = []

    def add_sphere(self, centre, radius, colour=(128, 128, 128), *,
                   reflective=0.0, transparent=0.0, emitive=0.0,
                   ior=1.0, id=0) -> "SceneBuilder":
        self.spheres.append(SphereSpec(centre, radius, colour,
                                       float(reflective), float(transparent),
                                       float(emitive), float(ior), int(id)))
        return self

    def add_global_light(self, vector, colour, strength=1.0,
                         max_angle=np.pi / 2) -> "SceneBuilder":
        self._glights.append(dict(vector=vector, colour=colour,
                                  strength=float(strength),
                                  max_angle=float(max_angle)))
        return self

    def add_point_light(self, id, position, colour, strength=1.0,
                        max_angle=np.pi / 2, func=0) -> "SceneBuilder":
        self._plights.append(dict(id=int(id), position=position,
                                  colour=colour, strength=float(strength),
                                  max_angle=float(max_angle), func=int(func)))
        return self

    def build(self, device=None, dtype=torch.float32):
        """``(scene, global_lights, point_lights)`` on ``device``."""
        dev = resolve_device(device)
        scene = build_scene(self.spheres, device=dev, dtype=dtype)
        if self._glights:
            gl = GlobalLights(**{k: _f32([g[k] for g in self._glights], dev)
                                 for k in ("vector", "colour", "strength",
                                           "max_angle")})
        else:
            gl = empty_global_lights(dev)
        if self._plights:
            pl = PointLights(
                id=_i32([p["id"] for p in self._plights], dev),
                func=_i32([p["func"] for p in self._plights], dev),
                **{k: _f32([p[k] for p in self._plights], dev)
                   for k in ("position", "colour", "strength", "max_angle")})
        else:
            pl = empty_point_lights(dev)
        return scene, scene_astype(gl, dtype), scene_astype(pl, dtype)


def _f32(vals, dev):
    return torch.from_numpy(np.asarray(vals, dtype=np.float64)).to(
        torch.float32).to(dev)


def _i32(vals, dev):
    return torch.tensor(vals, dtype=torch.int32, device=dev)


def build_scene(specs: Sequence[SphereSpec], device=None,
                dtype=torch.float32) -> Scene:
    dev = resolve_device(device)

    def arr(vals):
        # float64 first, then one rounding: the JAX package's construction.
        a = torch.from_numpy(np.asarray(vals, dtype=np.float64))
        return a.to(dtype).to(dev)

    return Scene(
        centre=arr([s.centre for s in specs]),
        radius=arr([s.radius for s in specs]),
        colour=arr([s.colour for s in specs]),
        reflective=arr([s.reflective for s in specs]),
        transparent=arr([s.transparent for s in specs]),
        emitive=arr([s.emitive for s in specs]),
        ior=arr([s.ior for s in specs]),
        id=_i32([s.id for s in specs], dev),
    )


def scene_astype(obj, dtype):
    """Cast the float fields of a ``Scene``, ``GlobalLights`` or
    ``PointLights`` (float64 for the reference-parity tests); integer
    fields stay int32."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dtype)
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


def _from_numpy(cls, d: Mapping[str, np.ndarray], dev):
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(d[f.name])
        if f.name in ("id", "func"):
            a = a.astype(np.int32)
        out[f.name] = torch.from_numpy(a.copy()).to(dev)
    floats = {str(v.dtype) for k, v in out.items() if k not in ("id", "func")}
    if floats not in ({"torch.float32"}, {"torch.float64"}):
        raise ValueError(f"{cls.__name__} float fields must all be float32 "
                         f"or all float64, got {sorted(floats)}")
    return cls(**out)


def _to_numpy(obj) -> dict:
    return {f.name: getattr(obj, f.name).cpu().numpy()
            for f in dataclasses.fields(obj)}


def scene_from_numpy(d: Mapping[str, np.ndarray], device=None) -> Scene:
    """The port's ``Scene`` from a mapping of field name to numpy array (for
    example ``{f: np.asarray(getattr(jax_scene, f)) ...}``).  Values are
    kept exactly: float fields must be float32 or float64."""
    return _from_numpy(Scene, d, resolve_device(device))


def scene_to_numpy(scene: Scene) -> dict:
    """Inverse of :func:`scene_from_numpy`."""
    return _to_numpy(scene)


def lights_from_numpy(gl: Mapping[str, np.ndarray],
                      pl: Mapping[str, np.ndarray], device=None):
    """``(GlobalLights, PointLights)`` from mappings of field name to numpy
    array, kept exactly, as :func:`scene_from_numpy`."""
    dev = resolve_device(device)
    return _from_numpy(GlobalLights, gl, dev), _from_numpy(PointLights, pl,
                                                           dev)


def lights_to_numpy(gl: GlobalLights, pl: PointLights):
    """Inverse of :func:`lights_from_numpy`."""
    return _to_numpy(gl), _to_numpy(pl)
