"""FB-vs-traditional comparison harness.

Counterpart of ``raytracer_tpu/compare/harness.py`` (the main() flows of
FB/fb_vs_traditional_chandelier.py:785-931 and
FB/fb_vs_traditional_complex.py:648-796): render traditional and
FB-guided with the same camera and config, write ``statistics.json`` with
the JAX package's schema key for key (``traditional`` / ``fb`` stats,
``implementations``, and the ``comparison`` block: speedup,
ray_efficiency, small_light_improvement) and ``comparison.png`` into a
timestamped directory.

Both renders go through ``render/path_renderer.py::render_path`` on the
card by default.  Each side's impl takes the port's names: ``"kernel"``
(the path kernel, a student inside it), ``"hybrid"``, ``"stepwise"`` (the
default, as in JAX) and ``"plain"``.  The two sides draw their planes from
two ``torch.Generator`` seeded from ``seed`` (JAX: ``k1, k2 =
split(key(seed))``), a fresh generator each render so that warm-up and
timed renders trace the same rays; or they take explicit planes
(``traditional_planes`` / ``fb_planes``: ``render_path``'s ``jitter``,
``uniforms`` and ``fb_uniforms``).

``comparison.png`` holds the two frames and their difference, enhanced 3x,
side by side (JAX draws the same three panels with matplotlib, with
titles; the port writes the pixels through ``utils/io.py``).
"""
from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..fb.inference import TrainedFBAgent, small_light_indices
from ..render.path_renderer import render_path
from ..scene.types import Scene
from ..utils.io import quantise_unit, save_image


def _stats_dict(stats, render_time: float) -> dict:
    return {
        "total_rays": int(stats.total_rays),
        "total_intersections": int(stats.total_intersections),
        "light_hits": int(stats.light_hits),
        "small_light_hits": int(stats.small_light_hits),
        "render_time": render_time,
        "rays_per_second": (int(stats.total_rays) / render_time
                            if render_time > 0 else 0),
    }


def _is_distilled(model_path) -> bool:
    """A distilled student (``fb.distill.DistilledGuide.save``) is a flat
    npz with a ``__hidden__`` header; full FB checkpoints carry
    ``__meta__`` instead (``utils/checkpoint.save_fb``)."""
    p = str(model_path)
    if not p.endswith(".npz"):
        return False
    try:
        with np.load(p) as z:
            return "__hidden__" in z.files
    except (OSError, ValueError):
        return False


def side_seeds(seed: int):
    """The two sides' generator seeds, independent streams from ``seed``."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(2)]


def run_comparison(scene: Scene, *, camera_position, width: int = 200,
                   height: int = 100, samples_per_pixel: int = 8,
                   max_bounces: int = 8, model_path: Optional[str] = None,
                   traditional_mirror_threshold: float = 0.0,
                   fb_mirror_threshold: float = 0.9,
                   out_dir: Optional[str] = None, scene_name: str = "scene",
                   seed: int = 0, save_png: bool = True,
                   warmup: bool = True, impl: str = "stepwise",
                   traditional_impl: Optional[str] = None,
                   fb_impl: Optional[str] = None,
                   timing_iters: int = 1,
                   fb_samples_per_pixel: Optional[int] = None,
                   spp_chunk: Optional[int] = None,
                   traditional_planes: Optional[Mapping] = None,
                   fb_planes: Optional[Mapping] = None,
                   device=None) -> dict:
    """Run the two renders and write the artifacts; returns the stats dict.

    ``traditional_mirror_threshold`` defaults to the chandelier script's
    ``reflective > 0`` rule; pass 0.9 for the complex script's.
    ``model_path``: a distilled student (``*.npz`` with ``__hidden__`` ->
    ``fb.distill.DistilledGuide``, bf16 as deployed), a full FB checkpoint
    (``TrainedFBAgent``, f32), or None: the FB side then samples as the
    traditional one with ``fb_prob=0`` (JAX's fallback).  ``warmup``: each
    side renders once before the timed renders; ``timing_iters``: best of
    that many timed renders, each ended by ``torch.cuda.synchronize()``.
    ``fb_samples_per_pixel``: the FB side's spp (matched-signal mode).
    ``spp_chunk``: both sides in chunks of that many samples
    (``render_path``; impl ``"kernel"`` or ``"plain"``)."""
    fb_spp = (samples_per_pixel if fb_samples_per_pixel is None
              else fb_samples_per_pixel)
    if spp_chunk is not None:
        # Both sides up front: render_path's own check would fire on the
        # FB side only after the traditional render.
        for label, v in (("samples_per_pixel", samples_per_pixel),
                         ("fb_samples_per_pixel", fb_spp)):
            if v > spp_chunk and v % spp_chunk:
                raise ValueError(
                    f"{label}={v} not divisible by spp_chunk={spp_chunk}")
    dev = resolve_device(device)
    scene = scene.to(dev)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    out = Path(out_dir or f"./{scene_name}_comparison_{timestamp}")
    out.mkdir(parents=True, exist_ok=True)

    if model_path is not None and _is_distilled(model_path):
        from ..fb.distill import DistilledGuide
        guide = DistilledGuide.load(str(model_path)).as_guide_fn()
        fb_prob = 1.0
    elif model_path is not None:
        agent = TrainedFBAgent(model_path, scene, small_light_indices(scene),
                               camera_position, device=dev)
        guide, fb_prob = agent.as_guide_fn(), 1.0
    else:
        guide, fb_prob = None, 0.0

    t_impl = traditional_impl or impl
    f_impl = fb_impl or impl
    seeds = side_seeds(seed)
    common = dict(width=width, height=height, max_bounces=max_bounces,
                  camera_position=camera_position, spp_chunk=spp_chunk,
                  device=dev)

    def planes(given, side):
        if given is not None:
            return dict(given)
        return {"generator": torch.Generator(dev).manual_seed(seeds[side])}

    def run_trad():
        return render_path(scene, spp=samples_per_pixel,
                           mirror_threshold=traditional_mirror_threshold,
                           impl=t_impl, **common,
                           **planes(traditional_planes, 0))

    def run_fb():
        return render_path(scene, spp=fb_spp,
                           mirror_threshold=fb_mirror_threshold,
                           guide_fn=guide, fb_prob=fb_prob, impl=f_impl,
                           **common, **planes(fb_planes, 1))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if warmup:
        run_trad()
        run_fb()
        sync()

    def timed(run):
        best, img, stats = float("inf"), None, None
        for _ in range(max(1, timing_iters)):
            t0 = time.perf_counter()
            img, stats = run()
            sync()
            best = min(best, time.perf_counter() - t0)
        return img, stats, best

    trad_img, trad_stats, trad_time = timed(run_trad)
    fb_img, fb_stats, fb_time = timed(run_fb)

    td = _stats_dict(trad_stats, trad_time)
    td["samples_per_pixel"] = samples_per_pixel
    fd = _stats_dict(fb_stats, fb_time)
    fd["samples_per_pixel"] = fb_spp
    # fb_success: guided bounces whose subpath ended on a light
    # (PathStats.fb_success), and its rate (complex.py:746-748).
    fd["fb_used"] = int(fb_stats.fb_used)
    fd["fb_success"] = int(fb_stats.fb_success)
    fd["fb_success_rate"] = (fd["fb_success"] / fd["fb_used"]
                             if fd["fb_used"] else 0.0)
    stats = {
        "traditional": td,
        "fb": fd,
        "implementations": {"traditional": t_impl, "fb": f_impl,
                            "timing_iters": max(1, timing_iters)},
        "comparison": {
            "speedup": trad_time / fb_time if fb_time > 0 else 0,
            "ray_efficiency": (fd["total_rays"] / td["total_rays"]
                               if td["total_rays"] else 0),
            "small_light_improvement": (
                fd["small_light_hits"] / td["small_light_hits"]
                if td["small_light_hits"] else 0),
        },
    }
    with open(out / "statistics.json", "w") as f:
        json.dump(stats, f, indent=2)
    if save_png:
        save_comparison_png(out / "comparison.png",
                            trad_img.cpu().numpy(), fb_img.cpu().numpy())
    return stats


def save_comparison_png(path, trad_img: np.ndarray, fb_img: np.ndarray):
    """Traditional, FB and ``min(1, 3 |fb - traditional|)`` side by side,
    ``[H, 3W, 3]``, as a PNG."""
    diff = np.clip(np.abs(fb_img - trad_img) * 3, 0, 1)
    panels = np.concatenate([np.clip(trad_img, 0, 1), np.clip(fb_img, 0, 1),
                             diff], axis=1)
    save_image(path, quantise_unit(panels))


def chandelier_comparison(model_path=None, **kw):
    from ..scene.library import chandelier_scene
    scene, _, _, p = chandelier_scene(device="cpu")
    kw.setdefault("camera_position", p["camera_position"])
    kw.setdefault("traditional_mirror_threshold", 0.0)   # `reflective > 0`
    return run_comparison(scene, model_path=model_path,
                          scene_name="chandelier", **kw)


def complex_comparison(model_path=None, **kw):
    from ..scene.complex import create_camera_for_scene, create_complex_scene
    scene, _, _ = create_complex_scene(device="cpu")
    kw.setdefault("camera_position", create_camera_for_scene())
    kw.setdefault("traditional_mirror_threshold", 0.9)   # `reflective > 0.9`
    return run_comparison(scene, model_path=model_path,
                          scene_name="complex", **kw)
