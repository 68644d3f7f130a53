"""Struct-of-arrays sphere scene as PyTorch tensors.

Counterpart of ``raytracer_tpu/scene/types.py``: the same ``Scene`` fields,
the same ``SphereSpec``/``SceneBuilder`` API and the same construction
(values gathered as float64 numpy, then cast once to float32), so the
tables are bit-identical to the JAX package's.  Lights (``GlobalLights``,
``PointLights``) belong to the Whitted tracer and come with its slice.

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

_FLOAT_FIELDS = ("centre", "radius", "colour", "reflective", "transparent",
                 "emitive", "ior")


@dataclasses.dataclass(frozen=True)
class Scene:
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

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        return Scene(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


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
    """Accumulates sphere specs on the host and emits the tensor scene."""

    def __init__(self) -> None:
        self.spheres: List[SphereSpec] = []

    def add_sphere(self, centre, radius, colour=(128, 128, 128), *,
                   reflective=0.0, transparent=0.0, emitive=0.0,
                   ior=1.0, id=0) -> "SceneBuilder":
        self.spheres.append(SphereSpec(centre, radius, colour,
                                       float(reflective), float(transparent),
                                       float(emitive), float(ior), int(id)))
        return self

    def build(self, device=None) -> Scene:
        return build_scene(self.spheres, device=device)


def build_scene(specs: Sequence[SphereSpec], device=None) -> Scene:
    dev = resolve_device(device)

    def arr(vals):
        # float64 first, then one rounding: the JAX package's construction.
        a = torch.from_numpy(np.asarray(vals, dtype=np.float64))
        return a.to(torch.float32).to(dev)

    return Scene(
        centre=arr([s.centre for s in specs]),
        radius=arr([s.radius for s in specs]),
        colour=arr([s.colour for s in specs]),
        reflective=arr([s.reflective for s in specs]),
        transparent=arr([s.transparent for s in specs]),
        emitive=arr([s.emitive for s in specs]),
        ior=arr([s.ior for s in specs]),
        id=torch.tensor([s.id for s in specs], dtype=torch.int32,
                        device=dev),
    )


def scene_astype(scene: Scene, dtype) -> Scene:
    """Cast the float fields of a scene."""
    return scene.replace(**{k: getattr(scene, k).to(dtype)
                            for k in _FLOAT_FIELDS})


def scene_from_numpy(d: Mapping[str, np.ndarray], device=None) -> Scene:
    """The port's ``Scene`` from a mapping of field name to numpy array (for
    example ``{f: np.asarray(getattr(jax_scene, f)) ...}``).  Values are
    kept exactly: float fields must already be float32."""
    dev = resolve_device(device)
    out = {}
    for k in _FLOAT_FIELDS:
        a = np.asarray(d[k])
        if a.dtype != np.float32:
            raise ValueError(f"scene field {k!r} is {a.dtype}, not float32")
        out[k] = torch.from_numpy(a.copy()).to(dev)
    out["id"] = torch.from_numpy(
        np.asarray(d["id"]).astype(np.int32)).to(dev)
    return Scene(**out)


def scene_to_numpy(scene: Scene) -> dict:
    """Inverse of :func:`scene_from_numpy`."""
    return {f.name: getattr(scene, f.name).cpu().numpy()
            for f in dataclasses.fields(scene)}
