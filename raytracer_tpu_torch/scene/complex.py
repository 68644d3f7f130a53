"""The "complex scene": the port's own copy of
``raytracer_tpu/scene/complex.py`` (a re-design of the reference's missing
``complex_scene.py``, FB/fb_vs_traditional_complex.py:27,
FB/train_complex_only.py:45): six big room spheres with ids 1-6, three
lights (one medium, two small), mirrors, glass and diffuse feature
spheres, a golden-angle ring and floating accents: 54 spheres, 3
emissive.  The same SceneBuilder calls in the same order, so the tables
equal JAX's sphere for sphere.

``create_complex_scene()`` gives ``(scene, global_lights, point_lights)``
on ``device`` (``cuda`` by default), ``create_camera_for_scene()`` the
camera position, ``create_lights_for_scene()`` the lights.
"""
from __future__ import annotations

import math

import numpy as np

from .types import SceneBuilder

_GOLD = 137.50776405003785     # golden angle, degrees


def build_complex(builder: SceneBuilder) -> SceneBuilder:
    b = builder
    # Room: six big matte spheres, ids 1-6 (floor/ceiling/4 walls).
    b.add_sphere((0, -101, 0), 100, (190, 190, 200), id=1)
    b.add_sphere((0, 103, 0), 100, (230, 230, 245), id=2)
    b.add_sphere((0, 0, -106), 100, (205, 200, 220), id=3)
    b.add_sphere((0, 0, 112), 100, (210, 215, 225), id=4)
    b.add_sphere((-106, 0, 0), 100, (200, 190, 190), id=5)
    b.add_sphere((106, 0, 0), 100, (190, 200, 195), id=6)

    # Three lights: one medium + two small (radius 0.08-0.15).
    b.add_sphere((0, 4.5, 4), 0.5, (255, 250, 235), emitive=1.0, id=50)
    b.add_sphere((-2.2, 2.8, 2.5), 0.12, (255, 235, 200), emitive=1.0, id=51)
    b.add_sphere((2.4, 3.1, 6.0), 0.10, (220, 235, 255), emitive=1.0, id=52)

    # A field of mid-size feature spheres: mirrors, glass, diffuse.
    b.add_sphere((0.0, 0.2, 3.0), 0.8, (235, 235, 240), reflective=0.95, id=10)
    b.add_sphere((-1.8, -0.2, 4.2), 0.6, (255, 255, 255), reflective=0.1,
                 transparent=0.95, ior=1.5, id=11)
    b.add_sphere((1.9, 0.1, 4.8), 0.65, (255, 255, 250), reflective=0.1,
                 transparent=0.95, ior=1.5, id=12)
    b.add_sphere((-0.9, 1.2, 6.2), 0.5, (210, 160, 120), id=13)
    b.add_sphere((1.1, 1.4, 2.2), 0.45, (150, 190, 230), id=14)
    b.add_sphere((-2.8, 0.6, 6.8), 0.55, (200, 140, 170), reflective=0.95, id=15)
    b.add_sphere((2.9, 0.8, 3.3), 0.5, (160, 210, 160), id=16)
    b.add_sphere((0.2, -0.6, 6.5), 0.7, (230, 210, 150), id=17)

    # A golden-angle ring of small diffuse spheres on the "floor" plane —
    # fills the object count to the artifact's 54 total.
    for i in range(28):
        t = math.radians((i * _GOLD) % 360)
        r = 1.6 + 0.09 * i
        x = r * math.cos(t)
        z = 4.5 + 0.55 * r * math.sin(t)
        cr = int(120 + 100 * abs(math.sin(t * 1.7)))
        cg = int(120 + 100 * abs(math.cos(t * 2.3)))
        cb = int(120 + 100 * abs(math.sin(t * 3.1 + 1)))
        b.add_sphere((x, -0.85 + 0.02 * (i % 5), z), 0.18 + 0.02 * (i % 4),
                     (cr, cg, cb), id=100 + i)

    # A few floating accent spheres.
    for i in range(9):
        t = math.radians((i * 77.0) % 360)
        b.add_sphere((2.4 * math.cos(t), 1.8 + 0.35 * math.sin(2 * t),
                      4.5 + 1.9 * math.sin(t)), 0.22,
                     (140 + 12 * i, 230 - 11 * i, 160 + 9 * i), id=140 + i)
    return b


def create_complex_scene(device=None):
    """Scene + lights; 54 spheres, 3 emissive (matching the artifact)."""
    b = SceneBuilder()
    build_complex(b)
    _add_lights(b)
    return b.build(device=device)


def create_camera_for_scene():
    return (0.0, 2.0, 0.0)


def _add_lights(b: SceneBuilder):
    b.add_global_light((0.3, 1.0, -0.2), (40, 40, 60), strength=0.3,
                       max_angle=float(np.radians(90)))
    b.add_point_light(50, (0, 4.5, 4), (255, 250, 235), strength=2.0,
                      max_angle=float(np.pi), func=0)
    b.add_point_light(51, (-2.2, 2.8, 2.5), (255, 235, 200), strength=1.0,
                      max_angle=float(np.pi), func=0)
    b.add_point_light(52, (2.4, 3.1, 6.0), (220, 235, 255), strength=1.0,
                      max_angle=float(np.pi), func=0)


def create_lights_for_scene(device=None):
    b = SceneBuilder()
    _add_lights(b)
    _, gl, pl = b.build(device=device)
    return gl, pl
