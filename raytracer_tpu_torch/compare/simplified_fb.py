"""SimplifiedFBRenderer: the FB/output6.py renderer.

Counterpart of ``raytracer_tpu/compare/simplified_fb.py``:

* model autodiscovery under ``./fb_training_outputs`` (:128-145), native
  ``.npz`` checkpoints (the ``.pth`` import is not ported);
* the notebook-shading approximation ``calculate_lighting_exact_original``
  (:197-306), shared with the output5 tracer (``trace/output5_style.py::
  _shade_level``);
* FB-guided diffuse bounces through ``fb/agent.py::FBResearchAgent``'s
  batched policy on the 22-D observation *with the real sun direction in
  its last three features* (:308-407);
* the iterative walk ``trace_ray_simple`` (:434-577): lighting
  accumulation, mirror, 50/50 glass, FB-or-cosine diffuse; each level's
  sweep ``core/cuda_intersect.py::nearest_hit`` (the kernel on the card);
* the grid render with fov π/3 and its stats (:579-683).

Randomness comes in as planes, in the JAX schedule (each bounce's ``key,
k1, k2, k3 = split(key, 4)``): ``glass_uniforms [L, R]`` (``uniform(k1)``),
``uniforms [L, R, 2]`` (the cosine bounce, ``k2``) and ``fb_uniforms [L,
R]`` (the fb gate, ``k3``); a generator draws those not given.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core import cuda_intersect, vec
from ..core.device import resolve_device
from ..fb.agent import FBResearchAgent
from ..fb.config import FBConfig
from ..scene.types import Scene
from ..trace import sampling
from ..trace.output5_style import _normalise_safe, _shade_level, sweep


def find_model(base: str = "./fb_training_outputs") -> Optional[Path]:
    """The newest native checkpoint under the training outputs directory
    (:128-145), or None."""
    base = Path(base)
    if not base.exists():
        return None
    cands = sorted(base.glob("**/*.npz"))
    return max(cands, key=lambda p: p.stat().st_mtime) if cands else None


class SimplifiedFBRenderer:
    def __init__(self, scene: Scene, sun_idx: int,
                 model_path: Optional[str] = None,
                 config: Optional[FBConfig] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        # output6 builds the drifted legacy config (:166-179); the
        # canonical one is the default, the legacy one is the caller's.
        self.config = config or FBConfig()
        self.scene = scene.to(self.device)
        self.sun_idx = int(sun_idx)
        self.agent = FBResearchAgent(self.config, seed=seed,
                                     device=self.device)
        self.loaded = False
        if model_path:
            self.agent.load(model_path)
            self.loaded = True
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.stats = {"total_rays": 0, "fb_used": 0, "render_time": 0.0,
                      "rays_per_second": 0.0}

    def _obs_with_sun(self, point, normal, d, bounce, idx, max_bounces):
        """The 22-D observation with the sun's direction in its last three
        features (:308-407)."""
        sc = self.scene
        dtype = point.dtype
        sun_dir = _normalise_safe(sc.centre[self.sun_idx][None] - point)
        R = point.shape[0]
        col = lambda t: t[idx].to(dtype)[:, None]     # noqa: E731
        return torch.cat([
            point, d, normal, col(sc.reflective), col(sc.transparent),
            col(sc.emitive), col(sc.ior),
            torch.zeros((R, 3), dtype=dtype, device=point.device),
            torch.full((R, 1), bounce / max_bounces, dtype=dtype,
                       device=point.device),
            torch.zeros((R, 1), dtype=dtype, device=point.device),
            vec.div_scalar(sc.id[idx].to(dtype), 100.0)[:, None],
            sun_dir], dim=-1)

    def trace(self, origins: torch.Tensor, dirs: torch.Tensor, *,
              max_bounces: int = 6, fb_prob: float = 1.0,
              glass_uniforms: Optional[torch.Tensor] = None,
              uniforms: Optional[torch.Tensor] = None,
              fb_uniforms: Optional[torch.Tensor] = None):
        """The walk over ``[R]`` rays; ``[R, 3]`` accumulated colour,
        clamped to 255.  Stops early once no lane runs."""
        sc = self.scene
        dev = sc.device
        o = origins.to(dev)
        d = _normalise_safe(dirs.to(dev))
        R, dtype = o.shape[0], o.dtype
        L = max_bounces
        if glass_uniforms is None:
            glass_uniforms = torch.rand((L, R), generator=self.generator,
                                        device=dev)
        if uniforms is None:
            uniforms = torch.rand((L, R, 2), generator=self.generator,
                                  device=dev)
        if fb_uniforms is None:
            fb_uniforms = torch.rand((L, R), generator=self.generator,
                                     device=dev)
        table = cuda_intersect.sphere_table(sc)
        running = torch.ones(R, dtype=torch.bool, device=dev)
        acc = torch.zeros((R, 3), dtype=dtype, device=dev)
        emissive = sc.emitive > 0
        fb_used = 0
        for k in range(max_bounces):
            hit = sweep(sc, table, o, d, "kernel")
            found = running & hit.found
            emis = found & emissive[hit.idx]
            # Lights: add their colour and stop the lane.
            acc = torch.where(emis[:, None], torch.clamp_max(
                acc + sc.colour[hit.idx].to(dtype), 255.0), acc)
            surf = found & ~emis
            shade = _shade_level(sc, hit)
            acc = torch.where(surf[:, None],
                              torch.clamp_max(acc + shade, 255.0), acc)
            mirror = surf & (sc.reflective[hit.idx] > 0.9)
            glass = surf & ~mirror & (sc.transparent[hit.idx] > 0.9)
            diffuse = surf & ~mirror & ~glass
            refl_d = torch.stack(vec.reflect_c(*d.unbind(-1),
                                               *hit.normal.unbind(-1)), -1)
            through = glass_uniforms[k].to(dev, dtype) >= 0.5
            glass_d = torch.where(through[:, None], d, refl_d)
            diff_d = sampling.cosine_weighted(uniforms[k].to(dev, dtype),
                                              hit.normal, "renderer")
            use_fb = diffuse & (fb_uniforms[k].to(dev, dtype) < fb_prob)
            if bool(use_fb.any()):
                obs = self._obs_with_sun(hit.point, hit.normal, d, float(k),
                                         hit.idx, max_bounces)
                action = self.agent.choose_direction_batch(obs)
                fb_d = sampling.fb_action_to_direction(
                    torch.clamp(action, -1.0, 1.0), hit.normal, "renderer")
                diff_d = torch.where(use_fb[:, None], fb_d, diff_d)
                fb_used += int(use_fb.sum())
            new_d = torch.where(mirror[:, None], refl_d,
                                torch.where(glass[:, None], glass_d, diff_d))
            new_o = torch.where((glass & through)[:, None],
                                hit.point + d * 0.001,
                                hit.point + hit.normal * 0.001)
            o = torch.where(surf[:, None], new_o, o)
            d = torch.where(surf[:, None], new_d, d)
            running = surf
            if not bool(running.any()):
                break
        self.stats["fb_used"] += fb_used
        return torch.clamp_max(acc, 255.0)

    def render_original_style(self, width: int = 200, height: int = 200, *,
                              max_bounces: int = 6,
                              camera_position=(0, 0, 1)) -> np.ndarray:
        """The grid render, fov π/3 (:579-683): ``[H, W, 3]`` in [0, 1]."""
        half = np.tan((np.pi / 3) / 2)
        xs = np.linspace(-half, half, width)
        ys = np.linspace(half * height / width, -half * height / width,
                         height)
        X, Y = np.meshgrid(xs, ys)
        dirs = torch.from_numpy(np.stack([X, Y, -np.ones_like(X)], -1)
                                .reshape(-1, 3)).float().to(self.device)
        origins = torch.tensor(camera_position, dtype=torch.float32,
                               device=self.device).expand_as(dirs)
        t0 = time.perf_counter()
        rgb = self.trace(origins.contiguous(), dirs,
                         max_bounces=max_bounces,
                         fb_prob=1.0 if self.loaded else 0.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        rays = width * height
        self.stats["total_rays"] += rays
        self.stats["render_time"] += dt
        self.stats["rays_per_second"] = rays / dt if dt > 0 else 0
        return rgb.cpu().numpy().reshape(height, width, 3) / 255.0
