"""The 8-template multi-scene family of the FB learner.

The port's own copy of ``raytracer_tpu/scene/templates.py``: complex_scene,
cornell_box, mirror_maze, glass_gallery, simple_challenging, many_lights,
occluded_lights and chandelier_scene (the scene-type names of the
reference's training report,
``fb_multi_scene_training_20260216_164713/final_training_report.json``).
``chandelier_variation`` rebuilds ``ChandelierSceneGenerator``
(FB/train_chandelier_only.py:46-180) and ``complex_variation``
``ComplexSceneGenerator`` (FB/train_complex_only.py:168-239); the other
six were designed fresh to the names in the JAX package.  Every variation
draws from ``random.Random(variation)`` in JAX's order, so every template
and variation equals JAX's sphere for sphere.

``pad_scene`` keeps one sphere count across variations (the trainers pad
to 64): dummies at z = 1e9 with radius 0 and id -999999.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Tuple

import torch

from .complex import build_complex
from .types import Scene, SceneBuilder, SphereSpec, build_scene

DUMMY_CENTRE = (0.0, 0.0, 1e9)
DUMMY_ID = -999999


def pad_scene(scene: Scene, n: int) -> Scene:
    """Pad to ``n`` spheres with dummies: centre (0, 0, 1e9), radius 0,
    colour 0, no material, ior 1, id -999999.  A dummy fails the hit test
    for every ray not passing through it; in float32 a ray within ~1e-4 rad
    of +z from the scene does pass (its ``d2`` rounds to 0), as in the JAX
    package."""
    cur = scene.num_spheres
    if cur >= n:
        return scene
    k = n - cur

    def pad(a, v):
        return torch.cat([a, torch.full((k,) + tuple(a.shape[1:]), v,
                                        dtype=a.dtype, device=a.device)])

    centre = torch.tensor(DUMMY_CENTRE, dtype=scene.centre.dtype,
                          device=scene.device).expand(k, 3)
    return Scene(centre=torch.cat([scene.centre, centre]),
                 radius=pad(scene.radius, 0.0),
                 colour=pad(scene.colour, 0.0),
                 reflective=pad(scene.reflective, 0.0),
                 transparent=pad(scene.transparent, 0.0),
                 emitive=pad(scene.emitive, 0.0),
                 ior=pad(scene.ior, 1.0),
                 id=pad(scene.id, DUMMY_ID))


# ---------------------------------------------------------------------------
# Faithful variation generators
# ---------------------------------------------------------------------------

def chandelier_variation(variation: int = 0, seed: int | None = None
                         ) -> List[SphereSpec]:
    """FB/train_chandelier_only.py:46-180 rebuilt: 20–29 lights, radius
    0.08–0.16, mirror floor every 3rd variation, positional jitter above
    variation 5."""
    rng = random.Random(seed if seed is not None else variation)
    sid = 1000
    specs: List[SphereSpec] = []

    def add(centre, radius, colour, *, refl=0.0, transp=0.0, emit=0.0,
            ior=1.0, id=0):
        specs.append(SphereSpec(centre, radius, colour, refl, transp, emit,
                                ior, id))

    floor_refl = 0.95 if variation % 3 == 0 else 0.1
    add((0, -100, 0), 99, (220, 220, 230), refl=floor_refl, id=sid + 1)
    add((0, 100, 0), 99, (240, 240, 255), refl=0.95, id=sid + 2)
    add((0, 0, -100), 99, (210, 210, 230), refl=0.1, id=sid + 3)
    add((-100, 0, 0), 99, (200, 200, 220), refl=0.1, id=sid + 4)
    add((100, 0, 0), 99, (220, 200, 200), refl=0.1, id=sid + 5)
    add((0, 10, 5), 1.2, (255, 255, 240), emit=1.0, id=sid + 6)

    num_lights = 20 + (variation % 10)
    light_radius = 0.08 + 0.02 * (variation % 5)
    cx, cy, cz, cr = 0.0, 4.0, 8.0, 2.0
    for i in range(num_lights):
        theta = (i * 137.5) % 360 * math.pi / 180
        phi = (i * 90) % 360 * math.pi / 180
        x = cx + cr * math.sin(phi) * math.cos(theta)
        y = cy + cr * math.sin(phi) * math.sin(theta)
        z = cz + cr * math.cos(phi)
        if variation > 5:
            x += rng.uniform(-0.3, 0.3)
            y += rng.uniform(-0.3, 0.3)
            z += rng.uniform(-0.3, 0.3)
        r = max(180, min(255, int(200 + 55 * math.sin(theta + variation))))
        g = max(180, min(255, int(200 + 55 * math.cos(phi + variation))))
        b_ = max(180, min(255, int(200 + 55 * math.sin(phi + theta + variation))))
        add((x, y, z), light_radius, (r, g, b_), emit=1.0, id=sid + 10 + i)

    glass_x = 1.5 + 0.2 * (variation % 3)
    add((glass_x, 3, 7), 0.6, (255, 255, 255), refl=0.1, transp=0.9,
        ior=1.5, id=sid + 40)
    add((-1.5, -1.2, 6), 0.7, (200, 200, 220), refl=0.95, id=sid + 41)
    add((0, 1 + 0.2 * (variation % 2), 4), 0.5, (255, 240, 240), refl=0.1,
        transp=0.9, ior=1.5, id=sid + 42)
    return specs


def complex_variation(variation: int = 0) -> List[SphereSpec]:
    """FB/train_complex_only.py:168-239 rebuilt: perturb lights ±0.3 and
    non-wall objects ±0.2 with colour jitter (seeded by variation); add a
    small light every 5th variation, remove one every 7th."""
    b = SceneBuilder()
    build_complex(b)
    specs = b.spheres
    rng = random.Random(variation)

    for s in specs:
        if s.emitive:
            dx, dy, dz = (rng.uniform(-0.3, 0.3) for _ in range(3))
            s.centre = (s.centre[0] + dx, s.centre[1] + dy, s.centre[2] + dz)
            s.colour = tuple(max(180, min(255, int(c) + rng.randint(-20, 20)))
                             for c in s.colour)
    for s in specs:
        if not s.emitive and s.id not in (1, 2, 3, 4, 5, 6):
            dx, dy, dz = (rng.uniform(-0.2, 0.2) for _ in range(3))
            s.centre = (s.centre[0] + dx, s.centre[1] + dy, s.centre[2] + dz)
            s.colour = tuple(max(100, min(255, int(c) + rng.randint(-15, 15)))
                             for c in s.colour)

    if variation % 5 == 0:
        b.add_sphere((rng.uniform(-2, 2), rng.uniform(-1, 3),
                      rng.uniform(0, 5)), 0.15, (255, 240, 200),
                     emitive=1.0, id=999 + variation)
    elif variation % 7 == 0:
        small = [s for s in specs if s.emitive and s.radius < 0.5]
        if small:
            specs.remove(rng.choice(small))
    return specs


# ---------------------------------------------------------------------------
# Designed-fresh templates (originals unrecoverable)
# ---------------------------------------------------------------------------

def cornell_box_variation(variation: int = 0) -> List[SphereSpec]:
    """Cornell-style box out of wall spheres: red/green side walls, white
    floor/ceiling/back, one ceiling light, two boxes-as-spheres."""
    rng = random.Random(variation)
    specs = []
    add = lambda *a, **k: specs.append(SphereSpec(*a, **k))
    add((0, -101, 4), 100, (240, 240, 240), id=1)
    add((0, 103, 4), 100, (240, 240, 240), id=2)
    add((0, 1, -102), 100, (240, 240, 240), id=3)
    add((-103, 1, 4), 100, (230, 60, 60), id=4)        # red wall
    add((103, 1, 4), 100, (60, 200, 60), id=5)         # green wall
    ly = 2.6 + rng.uniform(-0.1, 0.1)
    add((0, ly, 4), 0.35, (255, 250, 230), emitive=1.0, id=20)
    add((-0.8 + rng.uniform(-0.2, 0.2), -0.4, 3.2), 0.6,
        (235, 235, 235), reflective=(0.95 if variation % 2 else 0.0), id=10)
    add((0.9 + rng.uniform(-0.2, 0.2), -0.55, 4.8), 0.45,
        (235, 235, 235), id=11)
    return specs


def mirror_maze_variation(variation: int = 0) -> List[SphereSpec]:
    """A corridor of facing mirrors with one light only reachable via
    multi-bounce reflection."""
    rng = random.Random(variation)
    specs = []
    add = lambda *a, **k: specs.append(SphereSpec(*a, **k))
    add((0, -101, 4), 100, (210, 210, 215), id=1)
    n = 6 + variation % 3
    for i in range(n):
        z = 2.0 + i * 1.2
        x = 1.4 if i % 2 == 0 else -1.4
        add((x + rng.uniform(-0.1, 0.1), 0.4, z), 0.7, (230, 230, 240),
            reflective=0.95, id=10 + i)
    add((0, 0.8, 2.0 + n * 1.2 + 0.8), 0.25, (255, 245, 220),
        emitive=1.0, id=40)
    add((0, 3.2, 3.0), 0.15, (255, 255, 235), emitive=1.0, id=41)
    return specs


def glass_gallery_variation(variation: int = 0) -> List[SphereSpec]:
    """Rows of glass spheres between the camera and the lights."""
    rng = random.Random(variation)
    specs = []
    add = lambda *a, **k: specs.append(SphereSpec(*a, **k))
    add((0, -101, 4), 100, (215, 215, 220), id=1)
    for i in range(8 + variation % 4):
        t = i * 0.8 - 3.0
        add((t + rng.uniform(-0.1, 0.1), 0.2 + 0.3 * (i % 3), 3.5 + (i % 4)),
            0.45, (255, 255, 255), reflective=0.1, transparent=0.95,
            ior=1.5, id=10 + i)
    add((0, 2.5, 8.0), 0.4, (255, 250, 235), emitive=1.0, id=40)
    add((-2.0, 1.8, 6.0), 0.12, (255, 235, 205), emitive=1.0, id=41)
    return specs


def simple_challenging_variation(variation: int = 0) -> List[SphereSpec]:
    """Minimal scene, tiny far light — simple geometry, hard target."""
    rng = random.Random(variation)
    specs = []
    add = lambda *a, **k: specs.append(SphereSpec(*a, **k))
    add((0, -101, 4), 100, (200, 205, 200), id=1)
    add((0, 0, 4), 0.8, (190, 160, 220), id=2)
    add((rng.uniform(-3, 3), 3.5, rng.uniform(6, 9)), 0.1,
        (255, 250, 230), emitive=1.0, id=40)
    return specs


def many_lights_variation(variation: int = 0) -> List[SphereSpec]:
    """Dozens of small lights scattered through the volume."""
    rng = random.Random(variation)
    specs = []
    add = lambda *a, **k: specs.append(SphereSpec(*a, **k))
    add((0, -101, 4), 100, (205, 205, 210), id=1)
    add((0, 0.2, 4.2), 0.7, (220, 220, 225), reflective=0.95, id=2)
    for i in range(24 + variation % 8):
        add((rng.uniform(-4, 4), rng.uniform(0.2, 4.5), rng.uniform(1.5, 9)),
            0.1, (int(rng.uniform(200, 255)), int(rng.uniform(200, 255)),
                  int(rng.uniform(180, 255))), emitive=1.0, id=40 + i)
    return specs


def occluded_lights_variation(variation: int = 0) -> List[SphereSpec]:
    """Lights hidden behind large diffuse blockers."""
    rng = random.Random(variation)
    specs = []
    add = lambda *a, **k: specs.append(SphereSpec(*a, **k))
    add((0, -101, 4), 100, (205, 205, 205), id=1)
    for i in range(3):
        x = (i - 1) * 2.4 + rng.uniform(-0.2, 0.2)
        add((x, 1.2, 5.0), 0.9, (170, 170, 185), id=10 + i)      # blocker
        add((x, 1.2, 6.4), 0.15, (255, 245, 225), emitive=1.0, id=40 + i)
    add((0, 4.0, 3.0), 0.2, (255, 255, 240), emitive=1.0, id=50)
    return specs


TEMPLATES: Dict[str, Callable[[int], List[SphereSpec]]] = {
    "complex_scene": complex_variation,
    "cornell_box": cornell_box_variation,
    "mirror_maze": mirror_maze_variation,
    "glass_gallery": glass_gallery_variation,
    "simple_challenging": simple_challenging_variation,
    "many_lights": many_lights_variation,
    "occluded_lights": occluded_lights_variation,
    "chandelier_scene": chandelier_variation,
}


def generate_scene(scene_type: str, variation: int = 0,
                   pad_to: int | None = None,
                   device=None) -> Tuple[Scene, str]:
    """``(scene, "<type>_v<variation>")`` on ``device`` (``cuda`` by
    default), padded to ``pad_to`` spheres when given."""
    specs = TEMPLATES[scene_type](variation)
    scene = build_scene(specs, device=device)
    if pad_to is not None:
        scene = pad_scene(scene, pad_to)
    return scene, f"{scene_type}_v{variation}"
