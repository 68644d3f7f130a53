"""RL training scene factories: the reference's scene constructors.

Counterpart of ``raytracer_tpu/env/scenes.py``, the same spheres and lights
through the port's ``SceneBuilder``:

* ``training_scene_v1``       — RL/train_raytracer.py:18-71 (`create_scene`)
* ``training_scene_optimized``— RL/train_raytracer_improved.py:52-93
                                (`create_optimized_scene`)
* ``training_scene_complete`` — RL/ray_tracer_rl_complete.py:45-80
                                (`create_training_scene`)
* ``dynamic_scene``           — RL/train_raytracer_optimized.py:97-143
                                (`create_dynamic_scene`, 3 curriculum phases)

Each returns ``(scene, global_lights, point_lights)`` on ``device``
(``cuda`` unless the caller names another).
"""
from __future__ import annotations

import numpy as np

from ..scene.types import SceneBuilder

PI = float(np.pi)


def training_scene_v1(device=None):
    """RL/train_raytracer.py:18-71: matte ground (emitive 0.05!), one mirror,
    one glass, a second mirror, two light spheres; a global light plus two
    strong point lights (strength 8/6, max_angle π)."""
    b = SceneBuilder()
    b.add_sphere((0, -100.5, -3), 100, (150, 150, 150), emitive=0.05, id=1)
    b.add_sphere((0, 0, -3), 0.5, (255, 255, 255), reflective=1.0, id=2)
    b.add_sphere((-1.5, 0.2, -3), 0.5, (200, 200, 255), transparent=1.0,
                 ior=1.5, id=3)
    b.add_sphere((1.5, -0.2, -3), 0.5, (255, 200, 200), reflective=1.0, id=4)
    b.add_sphere((0, 2.5, -3), 0.4, (255, 255, 200), emitive=1.0, id=99)
    b.add_sphere((-2, 1, -3), 0.3, (200, 255, 200), emitive=1.0, id=100)
    # The reference normalises the global light vector at construction.
    v = np.array([0.0, -1.0, -0.3])
    v = v / np.linalg.norm(v)
    b.add_global_light(tuple(v), (150, 150, 200), strength=0.2,
                       max_angle=PI / 4)
    b.add_point_light(99, (0, 2.5, -3), (255, 255, 200), strength=8.0,
                      max_angle=PI, func=0)
    b.add_point_light(100, (-2, 1, -3), (200, 255, 200), strength=6.0,
                      max_angle=PI, func=0)
    return b.build(device)


def training_scene_optimized(device=None):
    """RL/train_raytracer_improved.py:52-93."""
    b = SceneBuilder()
    b.add_sphere((0, -100, -3), 99, (100, 100, 100), emitive=0.1, id=1)
    b.add_sphere((0, 0, -3), 0.7, (255, 255, 255), reflective=1.0, id=2)
    b.add_sphere((-1.8, 0.3, -3), 0.5, (200, 200, 255), reflective=1.0, id=3)
    b.add_sphere((0, 2, -3), 0.5, (255, 255, 200), emitive=1.0, id=99)
    b.add_sphere((-2, 1.5, -3), 0.4, (200, 255, 200), emitive=1.0, id=100)
    b.add_point_light(99, (0, 2, -3), (255, 255, 200), strength=12.0,
                      max_angle=PI, func=0)
    b.add_point_light(100, (-2, 1.5, -3), (200, 255, 200), strength=8.0,
                      max_angle=PI, func=0)
    return b.build(device)


def training_scene_complete(device=None):
    """RL/ray_tracer_rl_complete.py:45-80."""
    b = SceneBuilder()
    b.add_sphere((0, -100, -3), 99, (150, 150, 150), emitive=0.1, id=1)
    b.add_sphere((0, 0, -3), 0.7, (255, 255, 255), reflective=1.0, id=2)
    b.add_sphere((-1.5, 0.3, -3), 0.5, (200, 200, 255), reflective=1.0, id=3)
    b.add_sphere((1.5, -0.2, -3), 0.5, (255, 200, 200), reflective=1.0, id=4)
    b.add_sphere((0, 2.5, -3), 0.6, (255, 255, 200), emitive=1.0, id=99)
    b.add_sphere((-2, 1.8, -3), 0.4, (200, 255, 200), emitive=1.0, id=100)
    b.add_point_light(99, (0, 2.5, -3), (255, 255, 200), strength=15.0,
                      max_angle=PI, func=0)
    b.add_point_light(100, (-2, 1.8, -3), (200, 255, 200), strength=10.0,
                      max_angle=PI, func=0)
    return b.build(device)


def dynamic_scene(phase: int = 1, device=None):
    """RL/train_raytracer_optimized.py:97-143 curriculum phases."""
    b = SceneBuilder()
    b.add_sphere((0, -100, -3), 99, (150, 150, 150), emitive=0.1, id=1)
    if phase == 1:
        b.add_sphere((0, 0, -3), 0.8, (255, 255, 255), reflective=1.0, id=2)
        b.add_sphere((0, 2.5, -3), 0.8, (255, 255, 200), emitive=1.0, id=99)
    elif phase == 2:
        b.add_sphere((0, 0, -3), 0.7, (255, 255, 255), reflective=1.0, id=2)
        b.add_sphere((-1.5, 0.5, -3), 0.5, (200, 200, 255), reflective=1.0, id=3)
        b.add_sphere((0, 2.5, -3), 0.6, (255, 255, 200), emitive=1.0, id=99)
    else:
        b.add_sphere((0, 0, -3), 0.6, (255, 255, 255), reflective=1.0, id=2)
        b.add_sphere((-1.8, 0.3, -3), 0.5, (200, 200, 255), reflective=1.0, id=3)
        b.add_sphere((1.8, -0.3, -3), 0.5, (255, 200, 200), reflective=1.0, id=4)
        b.add_sphere((0, 2.5, -3), 0.5, (255, 255, 200), emitive=1.0, id=99)
        b.add_sphere((-2, 1.8, -3), 0.4, (200, 255, 200), emitive=1.0, id=100)
    b.add_point_light(99, (0, 2.5, -3), (255, 255, 200), strength=15.0,
                      max_angle=PI, func=0)
    if phase >= 3:
        b.add_point_light(100, (-2, 1.8, -3), (200, 255, 200), strength=10.0,
                          max_angle=PI, func=0)
    return b.build(device)
