"""CustomSceneExperiment: the 4-way unified comparison (RL/output5.py:
265-1945).

Counterpart of ``raytracer_tpu/compare/experiment.py``.  Methods, all
rendered with the same 601x601 grid camera (the "unified camera",
:1251-1277; its size set by the mode's ``multiple``):

* ``true_original``: the notebook Whitted render (:416-533), through
  ``render/renderer.py::render_whitted`` (the Whitted kernel on the card);
* ``traditional``, ``rl``, ``fb``: the output5 tracers of
  ``trace/output5_style.py`` (the nearest-hit kernel a level on the card).

Outputs, into a timestamped directory: ``unified_comparison.png`` (the four
frames in a 2x2 grid), the per-method performance trials,
``custom_scene_analysis.png`` (JAX's matplotlib figure: the scene's
layout in 3-D, three of the renders, the trials' bars; :1688-1861; skipped
with a printed line where matplotlib is absent, ``utils/figures.py``) and
``custom_scene_results.json`` with a UTF-8 text summary (:1863-1945).

Seeds: JAX seeds a method's render with ``seed + hash(method) % 1000``,
which Python salts per process for ``str``; the port gives each method a
fixed offset (``METHOD_SEED_OFFSET``) instead.  The trials draw from one
generator a method seeded with ``seed``.
"""
from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..render.camera import grid_rays
from ..render.renderer import render_whitted
from ..scene import library
from ..trace.output5_style import trace_output5
from ..utils.io import quantise_unit, save_image

CONFIG_MODES = {
    # RL/output5.py:288-323: the fast / balanced / quality presets.
    "fast_mode": dict(multiple=1, max_bounces=3, trials=10),
    "balanced_mode": dict(multiple=2, max_bounces=5, trials=25),
    "quality_mode": dict(multiple=3, max_bounces=5, trials=50),
}
METHOD_SEED_OFFSET = {"traditional": 1, "fb": 2, "rl": 3}
GRID_ORDER = ("true_original", "traditional", "fb", "rl")


class CustomSceneExperiment:
    def __init__(self, output_dir: str = "./custom_scene_results",
                 mode: str = "balanced_mode", seed: int = 0, device=None):
        self.device = resolve_device(device)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.output_dir = Path(output_dir) / f"experiment_{stamp}"
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.config = dict(CONFIG_MODES[mode], mode=mode)
        self.seed = seed
        self.results: Dict = {}

    def _grid(self):
        return grid_rays(100, 0.01, self.config["multiple"],
                         origin=(0, 0, 1), device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- renders -------------------------------------------------------------
    def render_true_original(self):
        scene, gl, pl, p = library.true_original_scene(device=self.device)
        origins, dirs, h, w = self._grid()
        t0 = time.perf_counter()
        img = render_whitted(scene, gl, pl, origins, dirs, h, w,
                             max_bounces=5, background=p["background"],
                             mode="unit")
        self._sync()
        return img.cpu().numpy(), time.perf_counter() - t0

    def render_method(self, method: str):
        """One method over the grid: ``(image [H, W, 3] in [0, 1], seconds,
        stats)``, its planes drawn by a generator seeded ``seed +
        METHOD_SEED_OFFSET[method]``."""
        scene, _, _, _ = library.custom_scene(device=self.device)
        origins, dirs, h, w = self._grid()
        gen = torch.Generator(self.device).manual_seed(
            self.seed + METHOD_SEED_OFFSET[method])
        t0 = time.perf_counter()
        rgb, stats = trace_output5(scene, origins, dirs,
                                   max_bounces=self.config["max_bounces"],
                                   method=method, generator=gen)
        self._sync()
        dt = time.perf_counter() - t0
        img = np.minimum(1.0, rgb.cpu().numpy().reshape(h, w, 3) / 255.0)
        return img, dt, {k: float(v) for k, v in stats.items()}

    def render_custom_scene(self, method: str, *, width: int = 200,
                            height: int = 200, spp: int = 4, seed: int = 0):
        """The spp-jittered variant (RL/output5.py:1420-1525): a linspace
        camera scaled from the 601-wide original, a grid cell's jitter a
        sample, integer-averaged samples, ``min(1, c/255)``.  A generator
        seeded ``seed`` draws each sample's jitter, then its planes."""
        scale_factor = min(width, height) / 601
        extent = int(100 * scale_factor) * 0.01
        xs = np.linspace(-extent, extent, width)
        ys = np.linspace(extent, -extent, height)
        dx = xs[1] - xs[0] if width > 1 else 0.0
        dy = ys[0] - ys[1] if height > 1 else 0.0
        X, Y = np.meshgrid(xs, ys)
        scene, _, _, _ = library.custom_scene(device=self.device)
        gen = torch.Generator(self.device).manual_seed(seed)
        total = np.zeros((height * width, 3), np.float64)
        for _ in range(spp):
            Xj, Yj = X, Y
            if spp > 1:
                jit = (torch.rand((height, width, 2), generator=gen,
                                  device=self.device) - 0.5).cpu().numpy()
                Xj, Yj = X + jit[..., 0] * dx, Y + jit[..., 1] * dy
            dirs = torch.from_numpy(np.stack([Xj, Yj, -np.ones_like(Xj)], -1)
                                    .reshape(-1, 3)).float().to(self.device)
            origins = torch.tensor([0.0, 0.0, 1.0], device=self.device
                                   ).expand_as(dirs).contiguous()
            rgb, _ = trace_output5(scene, origins, dirs,
                                   max_bounces=self.config["max_bounces"],
                                   method=method, generator=gen)
            total += rgb.cpu().numpy().astype(np.float64)
        avg = np.trunc(total / spp)
        return np.minimum(1.0, avg / 255.0).reshape(height, width, 3)

    def render_unified_comparison(self, save: bool = True):
        """All four methods over the same camera grid (:1251-1418)."""
        images, times, stats = {}, {}, {}
        img, dt = self.render_true_original()
        images["true_original"], times["true_original"] = img, dt
        for method in ("traditional", "fb", "rl"):
            img, dt, st = self.render_method(method)
            images[method], times[method], stats[method] = img, dt, st
        if save:
            self._save_grid(images)
        self.results["render_times"] = times
        self.results["method_stats"] = stats
        return images, times, stats

    def _save_grid(self, images):
        """The four frames, 2x2 in ``GRID_ORDER``, as a PNG."""
        tiles = [np.clip(images[n], 0, 1) for n in GRID_ORDER]
        grid = np.concatenate([np.concatenate(tiles[:2], axis=1),
                               np.concatenate(tiles[2:], axis=1)], axis=0)
        save_image(self.output_dir / "unified_comparison.png",
                   quantise_unit(grid))

    # -- performance trials (:353-414, 1578-1622) ----------------------------
    def run_performance_trials(self, num_trials: Optional[int] = None):
        num_trials = num_trials or self.config["trials"]
        scene, _, _, _ = library.custom_scene(device=self.device)
        origins, dirs, _, _ = grid_rays(8, 0.05, 1, origin=(0, 0, 1),
                                        device=self.device)
        rays = origins.shape[0]
        results = {}
        for method in ("traditional", "fb", "rl"):
            gen = torch.Generator(self.device).manual_seed(self.seed)
            rewards, hits = [], []
            for _ in range(num_trials):
                _, st = trace_output5(scene, origins, dirs,
                                      max_bounces=self.config["max_bounces"],
                                      method=method, generator=gen)
                rewards.append(float(st["reward"]) / rays)
                hits.append(float(st["light_hits"]) / rays)
            results[method] = {"avg_reward": float(np.mean(rewards)),
                               "avg_light_hits": float(np.mean(hits)),
                               "trials": num_trials}
        self.results["trials"] = results
        return results

    # -- persistence (:1863-1945) --------------------------------------------
    def save_custom_results(self):
        out = self.output_dir / "custom_scene_results.json"
        with open(out, "w") as f:
            json.dump({"config": self.config, "results": self.results},
                      f, indent=2)
        with open(self.output_dir / "custom_scene_summary.txt", "w",
                  encoding="utf-8") as f:
            f.write("CUSTOM SCENE EXPERIMENT\n=======================\n\n")
            f.write(f"Mode: {self.config['mode']}\n\n")
            for section, data in self.results.items():
                f.write(f"[{section}]\n")
                f.write(json.dumps(data, indent=1))
                f.write("\n\n")
        return out

    def create_custom_scene_visualization(self, images=None):
        """Analysis figure (RL/output5.py:1688-1861): 3-D scene layout,
        up to three method renders, per-method trial metrics."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        scene, _, _, _ = library.custom_scene(device="cpu")
        fig = plt.figure(figsize=(16, 10))
        ax = fig.add_subplot(2, 3, 1, projection="3d")
        c = scene.centre.numpy()
        r = scene.radius.numpy()
        col = np.clip(scene.colour.numpy() / 255.0, 0, 1)
        emis = scene.emitive.numpy() > 0
        keep = r < 20
        ax.scatter(c[keep, 0], c[keep, 2], c[keep, 1],
                   s=np.clip(r[keep] * 400, 20, 600), c=col[keep],
                   edgecolors=np.where(emis[keep], "gold", "none"))
        ax.set_title("scene layout")
        slot = 2
        for name, img in (images or {}).items():
            if slot > 4:
                break
            a2 = fig.add_subplot(2, 3, slot)
            a2.imshow(np.clip(img, 0, 1)); a2.set_title(name); a2.axis("off")
            slot += 1
        trials = self.results.get("trials", {})
        if trials:
            a5 = fig.add_subplot(2, 3, 5)
            names = list(trials)
            a5.bar(names, [trials[n]["avg_reward"] for n in names])
            a5.set_title("avg reward / ray")
            a6 = fig.add_subplot(2, 3, 6)
            a6.bar(names, [trials[n]["avg_light_hits"] for n in names])
            a6.set_title("avg light hits / ray")
        plt.tight_layout()
        out = self.output_dir / "custom_scene_analysis.png"
        plt.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return out

    def run_custom_scene_experiment(self):
        """End-to-end flow (:1527-1622): the grid, the trials, the
        analysis figure, the results."""
        from ..utils.figures import figure_or_note
        images, _, _ = self.render_unified_comparison()
        self.run_performance_trials()
        figure_or_note(self.create_custom_scene_visualization, images,
                       name=str(self.output_dir / "custom_scene_analysis.png"))
        return self.save_custom_results()
