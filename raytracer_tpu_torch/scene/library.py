"""Canonical scenes, rebuilt as tensor scenes.

Counterpart of ``raytracer_tpu/scene/library.py``.  This slice carries the
chandelier only (FB/fb_vs_traditional_chandelier.py:275-387); the Whitted
notebook scenes come with the Whitted slice.  Each function returns
``(scene, params)``: the JAX package's tuple without the light tables,
which only the Whitted tracer reads.
"""
from __future__ import annotations

import math

from .types import SceneBuilder


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
    scene = b.build(device=device)
    params = dict(camera_position=(0, 2, 0), max_bounces=8, fov=60,
                  background=(2, 2, 5),
                  small_light_radius_below=0.5)
    return scene, params
