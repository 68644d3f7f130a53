"""Deployment guide registry: the shipped student for a (scene, camera).

Counterpart of ``raytracer_tpu/fb/registry.py`` with its own copy of the
table.  Students are camera-distribution-specific: on the chandelier scene
the all-around student wins at every aspect, the 2:1 specialist only at the
2:1 aspect (the JAX package's measurements, recorded there).  The caller
names the directory that holds the checkpoints; ``STUDENTS_DIR`` holds
byte-equal copies of every student the table names (``models/``'s).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

STUDENTS_DIR = Path(__file__).resolve().parent / "students"

#: (scene_name, aspect_band) -> checkpoint file name.  Aspect bands:
#: "wide" = width/height >= 1.8 (the reference's 2:1 comparison family),
#: "standard" = everything else (4:3 deployment renders included).
REGISTRY = {
    ("chandelier", "wide"): "fb_chandelier_distilled_2to1.npz",
    ("chandelier", "standard"): "fb_chandelier_distilled.npz",
    ("complex", "wide"): "fb_complex_distilled.npz",
    ("complex", "standard"): "fb_complex_distilled.npz",
    ("cornell_box", "wide"): "fb_cornell_distilled.npz",
    ("cornell_box", "standard"): "fb_cornell_distilled.npz",
    ("many_lights", "wide"): "fb_many_lights_distilled.npz",
    ("many_lights", "standard"): "fb_many_lights_distilled.npz",
    ("occluded_lights", "wide"): "fb_occluded_distilled.npz",
    ("occluded_lights", "standard"): "fb_occluded_distilled.npz",
    ("glass_gallery", "wide"): "fb_glass_gallery_distilled.npz",
    ("glass_gallery", "standard"): "fb_glass_gallery_distilled.npz",
    ("simple_challenging", "wide"): "fb_simple_distilled.npz",
    ("simple_challenging", "standard"): "fb_simple_distilled.npz",
    ("mirror_maze", "wide"): "fb_mirror_maze_distilled.npz",
    ("mirror_maze", "standard"): "fb_mirror_maze_distilled.npz",
}


def aspect_band(width: int, height: int) -> str:
    return "wide" if width / max(height, 1) >= 1.8 else "standard"


def model_path_for(scene_name: str, width: int, height: int,
                   models_dir) -> Optional[str]:
    """The registered checkpoint for this scene and camera in
    ``models_dir``, or None if nothing is registered or on disk."""
    scene_name = scene_name.partition(":")[0]       # cornell_box:1007 -> type
    name = REGISTRY.get((scene_name, aspect_band(width, height)))
    if name is None:
        return None
    path = os.path.join(os.fspath(models_dir), name)
    return path if os.path.exists(path) else None


def guide_for(scene_name: str, width: int, height: int, models_dir,
              dtype="auto"):
    """The registered student as a guide (ready for
    ``render_path(..., guide_fn=...)``), or None."""
    path = model_path_for(scene_name, width, height, models_dir)
    if path is None:
        return None
    from .distill import DistilledGuide
    return DistilledGuide.load(path).as_guide_fn(dtype=dtype)
