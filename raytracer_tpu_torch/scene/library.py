"""Canonical scenes, rebuilt as tensor scenes.

Counterpart of ``raytracer_tpu/scene/library.py``.  Each function returns
``(scene, global_lights, point_lights, params)``, as the JAX package's
do; ``params`` carries the camera and render constants the reference
keeps beside the scene.

Sources: ``custom_scene`` RL/output5.py:165-262; ``true_original_scene``
RL/output5.py:416-533 (RL/Planets 1.ipynb cell 0); ``planets2_scene``
RL/Planets 2.ipynb cell 0; ``marbles4_scene`` RL/Marbles 4.ipynb cell 0;
``chandelier_scene`` FB/fb_vs_traditional_chandelier.py:275-387.
"""
from __future__ import annotations

import math

import numpy as np

from .types import SceneBuilder

DEG90 = float(np.radians(90))


def _custom_spheres(b: SceneBuilder, sun_id: int) -> None:
    b.add_sphere((-0.8, 0.6, 0), 0.3, (255, 100, 100), transparent=1.0, ior=1.52, id=1)
    b.add_sphere((0.8, -0.8, -10), 2.2, (204, 204, 255), id=2)
    b.add_sphere((0.3, 0.34, 0.1), 0.2, (0, 51, 204), id=3)
    b.add_sphere((5.6, 3, -2), 5, (153, 51, 153), reflective=1.0, id=4)
    b.add_sphere((-0.8, -0.8, -0.2), 0.25, (153, 204, 0), id=5)
    b.add_sphere((-3, 10, -75), 30, (255, 204, 102), id=6)
    b.add_sphere((-0.6, 0.2, 6), 0.1, (255, 255, 204), emitive=1.0, id=sun_id)


def custom_scene(device=None):
    """The experiment harness's 7-sphere scene (sun id 7)."""
    b = SceneBuilder()
    _custom_spheres(b, sun_id=7)
    scene, gl, pl = b.build(device=device)
    params = dict(camera_position=(0, 0, 1), max_bounces=5,
                  background=(2, 2, 5), sun_id=7)
    return scene, gl, pl, params


def true_original_scene(device=None):
    """The notebook golden path: the custom spheres with the sun as id 0,
    its point light (func -1) and a blue global light."""
    b = SceneBuilder()
    _custom_spheres(b, sun_id=0)
    b.add_global_light((3, 1, -0.75), (20, 20, 255), strength=1, max_angle=DEG90)
    b.add_point_light(0, (-0.6, 0.2, 6), (255, 255, 204), strength=1,
                      max_angle=DEG90, func=-1)
    scene, gl, pl = b.build(device=device)
    params = dict(camera_position=(0, 0, 1), max_bounces=5,
                  background=(2, 2, 5), ray_count=100, ray_step=0.01,
                  multiple=3)
    return scene, gl, pl, params


def planets2_scene(device=None):
    """A mirror, a glass marble (n=1.52), three point lights."""
    b = SceneBuilder()
    b.add_sphere((0.2, 0, 0), 0.1, (255, 255, 204), emitive=1.0, id=0)      # sun
    b.add_sphere((-1, 0.5, -2), 1, (255, 153, 102), id=1)
    b.add_sphere((1, -0.5, 0.5), 0.4, (255, 0, 0), id=2)
    b.add_sphere((-10, 5, -20), 14, (102, 204, 255), id=3)
    b.add_sphere((0, 0.4, -0.8), 0.2, (204, 0, 204), id=4)
    b.add_sphere((0.45, -0.25, 0.2), 0.1, (50, 255, 25), id=5)
    b.add_sphere((1.5, 1, -2.5), 1, (24, 24, 35), reflective=1.0, id=6)     # mirror
    b.add_sphere((-5, -5, 5), 0.2, (255, 0, 0), emitive=1.0, id=7)          # red light
    b.add_sphere((5, 0, -2.5), 0.2, (0, 255, 0), emitive=1.0, id=8)         # green light
    b.add_sphere((-0.25, -0.2, 0.7), 0.3, (100, 100, 100), transparent=1.0,
                 ior=1.52, id=10)                                           # marble
    b.add_point_light(0, (0.2, 0, 0), (255, 255, 204), strength=3, max_angle=DEG90)
    b.add_point_light(7, (-5, -5, 5), (255, 0, 0), strength=1, max_angle=DEG90)
    b.add_point_light(8, (5, 0, -2.5), (0, 255, 0), strength=2, max_angle=DEG90)
    b.add_global_light((1, 0.1, -0.2), (0, 0, 255), strength=0.1, max_angle=DEG90)
    scene, gl, pl = b.build(device=device)
    params = dict(camera_position=(0, 0, 5), max_bounces=10,
                  background=(0, 0, 1), ray_count=100, ray_step=0.005,
                  multiple=10)
    return scene, gl, pl, params


def marbles4_scene(device=None):
    """Glass n=2 (rich in total internal reflection); misses take a sky
    colour."""
    b = SceneBuilder()
    b.add_sphere((5, 0.5, 1.5), 0.05, (179, 230, 255), emitive=1.0, id=200)
    b.add_sphere((-5, 0.5, 2.5), 0.05, (255, 153, 194), emitive=1.0, id=201)
    b.add_sphere((1, 1, 6), 0.05, (255, 218, 179), emitive=1.0, id=202)
    # ids continue via len(spheres) in the notebook: 3, 4, 5, 6, 7.
    b.add_sphere((0, 0, 2), 0.5, (100, 100, 100), transparent=1.0, ior=2, id=3)
    b.add_sphere((0.5, 0.5, -1), 1, (153, 102, 255), id=4)
    b.add_sphere((-0.5, -0.5, 1), 0.3, (204, 51, 0), id=5)
    b.add_sphere((0.5, 0.3, 4), 0.3, (194, 194, 214), reflective=1.0, id=6)
    b.add_sphere((-1, -0.1, -6), 1.5, (255, 214, 153), reflective=1.0, id=7)
    b.add_global_light((0.1, 1, -0.2), (255, 255, 255), strength=0.5,
                       max_angle=float(np.radians(180)))
    b.add_point_light(200, (5, 0.5, 1.5), (179, 230, 255), strength=5, max_angle=DEG90)
    b.add_point_light(201, (-5, 0.5, 2.5), (255, 153, 194), strength=5, max_angle=DEG90)
    b.add_point_light(202, (1, 1, 6), (255, 218, 179), strength=3, max_angle=DEG90)
    scene, gl, pl = b.build(device=device)
    params = dict(camera_position=(0, 0, 10), max_bounces=8,
                  background=(0, 0, 1), sky_colour=(230, 230, 255),
                  ray_count=100, ray_step=0.002, multiple=1)
    return scene, gl, pl, params


def chandelier_scene(device=None):
    """5 wall spheres, one big light, 20 golden-angle small lights and 3
    decorative glass/mirror spheres; material floats as in the reference
    (mirror 0.95, glass 0.9/0.1)."""
    b = SceneBuilder()
    sid = 1000
    # Walls.
    b.add_sphere((0, -100, 0), 99, (220, 220, 230), reflective=0.95, id=sid + 1)
    b.add_sphere((0, 100, 0), 99, (240, 240, 255), reflective=0.95, id=sid + 2)
    b.add_sphere((0, 0, -100), 99, (210, 210, 230), reflective=0.1, id=sid + 3)
    b.add_sphere((-100, 0, 0), 99, (200, 200, 220), reflective=0.1, id=sid + 4)
    b.add_sphere((100, 0, 0), 99, (220, 200, 200), reflective=0.1, id=sid + 5)
    # Main light.
    b.add_sphere((0, 10, 5), 1.2, (255, 255, 240), emitive=1.0, id=sid + 6)
    # Chandelier small lights on a golden-angle shell.
    cx, cy, cz, cr = 0.0, 4.0, 8.0, 2.0
    for i in range(20):
        theta = (i * 137.5) % 360 * math.pi / 180
        phi = (i * 90) % 360 * math.pi / 180
        x = cx + cr * math.sin(phi) * math.cos(theta)
        y = cy + cr * math.sin(phi) * math.sin(theta)
        z = cz + cr * math.cos(phi)
        r = max(180, min(255, int(200 + 55 * math.sin(theta))))
        g = max(180, min(255, int(200 + 55 * math.cos(phi))))
        bl = max(180, min(255, int(200 + 55 * math.sin(phi + theta))))
        b.add_sphere((x, y, z), 0.1, (r, g, bl), emitive=1.0, id=sid + 10 + i)
    # Decorative spheres.
    b.add_sphere((1.5, 3, 7), 0.6, (255, 255, 255), reflective=0.1,
                 transparent=0.9, ior=1.5, id=sid + 40)
    b.add_sphere((-1.5, -1.2, 6), 0.7, (200, 200, 220), reflective=0.95, id=sid + 41)
    b.add_sphere((0, 1, 4), 0.5, (255, 240, 240), reflective=0.1,
                 transparent=0.9, ior=1.5, id=sid + 42)
    scene, gl, pl = b.build(device=device)
    params = dict(camera_position=(0, 2, 0), max_bounces=8, fov=60,
                  background=(2, 2, 5),
                  small_light_radius_below=0.5)
    return scene, gl, pl, params
