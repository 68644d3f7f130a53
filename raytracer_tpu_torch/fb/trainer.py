"""FB trainers.

Counterpart of ``raytracer_tpu/fb/trainer.py`` (the rebuild of the missing
``fb_multi_scene_trainer.py``, ``MultiSceneFBTrainer``, and the two
surviving training scripts):

* ``ChandelierOnlyTrainer``: FB/train_chandelier_only.py:186-328;
* ``RayTracedComplexTrainer``: FB/train_complex_only.py:245-365.

Attributes ``config``, ``device`` (the torch device everything runs on,
``cuda`` by default), ``agent``, ``scene_generator`` and ``output_dir``;
``run_training(num_scenes, scenes_per_batch, training_steps_per_scene)``
writes JAX's files (``performance_batch_N.json``,
``checkpoint_batch_N.npz``, ``fb_multi_scene_final.npz``,
``final_training_report.json``, ``best_render_probe.npz``) with its report
schema; ``test_on_complex``/``test_on_chandelier`` the held-out tests.

Each scene's experience is one ``fb/trajectory.py`` walk (the nearest-hit
kernel a step on the card), its draws from the trainer's
``torch.Generator`` (seeded ``seed + 17``, as JAX's key).  The render probe
runs ``render_path(impl=PROBE_IMPL)``: "hybrid", one level kernel a bounce
with the live agent between levels (JAX runs its stepwise route; the two
give the same image, ``chip_smoke.py`` phase ``fb_agent``).
"""
from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core import cuda_intersect
from ..core.device import resolve_device
from ..scene import templates
from ..scene.types import Scene
from ..trace import sampling
from ..trace.path import make_observation
from .agent import FBResearchAgent
from .config import FBConfig
from .trajectory import draw_walk, generate_trajectories

# Scene-type cycle matching the report's counts over 100 scenes
# (complex/cornell/mirror/glass ×15, simple/many/occluded/chandelier ×10).
_CYCLE = ["complex_scene", "cornell_box", "mirror_maze", "glass_gallery",
          "simple_challenging", "many_lights", "occluded_lights",
          "chandelier_scene"]


def has_small_lights(scene: Scene) -> bool:
    """True when the scene has an emissive sphere of radius in (0, 0.5):
    then the success signal and the probe's metric are small-light hits."""
    r = scene.radius
    return bool(((scene.emitive > 0) & (r > 0) & (r < 0.5)).any())


class MultiSceneFBTrainer:
    """Trains the FB agent across the 8-template scene family."""

    # One sphere count for every variation: the walk's tables keep a shape.
    PAD_TO = 64
    # Start-point policy of the walk (fb/trajectory.py): "small" weights
    # start spheres by 1/(1+r); "uniform" is the reference's walk.
    START_BIAS = "small"
    # Share of walkers starting on wall surfaces when START_BIAS is "mixed".
    WALL_FRAC = 0.35
    # Hindsight relabelling: every step of a light-reaching episode is
    # recorded again with the terminal light observation as its target.
    HINDSIGHT = True
    # render_probe every N scenes during run_training (None disables), at
    # 64x32@2spp, and the probe scene's least traditional signal.
    probe_every: Optional[int] = None
    PROBE_WIDTH = 64
    PROBE_HEIGHT = 32
    PROBE_SPP = 2
    PROBE_MIN_SIGNAL = 8
    PROBE_IMPL = "hybrid"

    def __init__(self, num_training_scenes: int = 100,
                 config: Optional[FBConfig] = None,
                 output_dir: Optional[str] = None, seed: int = 0,
                 guide_prob: float = 0.0,
                 resume_from: Optional[str] = None, device=None):
        self.config = config or FBConfig()
        self.guide_prob = float(guide_prob)
        self.device = resolve_device(device)
        self.agent = FBResearchAgent(self.config, seed=seed,
                                     device=self.device)
        self.scene_generator = templates
        self.num_training_scenes = num_training_scenes
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.output_dir = Path(output_dir or
                               f"./fb_multi_scene_training_{stamp}")
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._gen = torch.Generator(self.device).manual_seed(seed + 17)
        self.all_performances: list = []
        # A directory: run_training writes tfevents to {dir}/FB_{N}/.
        self.tensorboard_log: Optional[str] = None
        # Continue training from a checkpoint: parameters, noise schedule,
        # light memory; the optimiser and the buffer restart empty.
        if resume_from:
            self.agent.load(resume_from)

    # -- scene supply (overridden by subclasses) ---------------------------
    def make_scene(self, i: int):
        stype = _CYCLE[i % len(_CYCLE)]
        scene, name = templates.generate_scene(stype, i, pad_to=self.PAD_TO,
                                               device=self.device)
        return scene, name, stype

    # -- experience --------------------------------------------------------
    def train_on_scene(self, scene: Scene, name: str,
                       episodes: int) -> float:
        """One walk of ``episodes`` walkers on the card, fed to the agent;
        returns the episode light-hit rate."""
        guided = self.guide_prob > 0 and bool(self.agent.light_memory)
        gkw = {}
        if guided:
            gkw = dict(guide=self.agent.guide(), guide_prob=self.guide_prob,
                       guide_noise=max(self.agent.noise_scale,
                                       self.agent.config.min_noise))
        draws = draw_walk(episodes, scene.num_spheres,
                          self.config.max_bounces,
                          start_bias=self.START_BIAS, guided=guided,
                          generator=self._gen, device=self.device)
        batch = generate_trajectories(scene, draws,
                                      max_steps=self.config.max_bounces,
                                      start_bias=self.START_BIAS,
                                      wall_frac=self.WALL_FRAC, **gkw)
        batch = type(batch)(*(f.cpu().numpy() for f in batch))
        # Deployment conditions the backward model on the small-light
        # prototype: on scenes with small lights the success signal and the
        # hindsight targets are small-light hits (JAX :188-200).
        success = batch.hit_small if has_small_lights(scene) \
            else batch.hit_light
        valid = batch.valid.reshape(-1)
        if valid.any():
            def flat(a):
                return a.reshape((-1,) + a.shape[2:])[valid]
            self.agent.record_success(flat(batch.obs), flat(batch.action),
                                      flat(batch.next_obs),
                                      flat(batch.reward), flat(success))
        if self.HINDSIGHT:
            self._record_hindsight(batch, success)
        return float(batch.episode_hit.mean())

    def _record_hindsight(self, batch, success=None) -> int:
        hit_steps = np.asarray(success if success is not None
                               else batch.hit_light)         # [T, W]
        valid = np.asarray(batch.valid)
        n = 0
        for w in np.nonzero(hit_steps.any(axis=0))[0]:
            t_hit = int(np.nonzero(hit_steps[:, w])[0][0])
            terminal = batch.next_obs[t_hit, w]
            steps = [t for t in range(t_hit) if valid[t, w]]
            if not steps:
                continue
            self.agent.record_success(
                batch.obs[steps, w], batch.action[steps, w],
                np.broadcast_to(terminal, (len(steps),) + terminal.shape),
                np.ones(len(steps), np.float32),
                np.ones(len(steps), np.float32))
            n += len(steps)
        return n

    # -- render-level probe --------------------------------------------------
    def agent_guide_fn(self):
        """The live agent's current policy and prototype as a guide (f32)."""
        return self.agent.guide()

    def _probe_render(self, scene, camera_position, width, height, spp,
                      seed, guide_fn=None):
        from ..render.path_renderer import render_path
        kw = {} if guide_fn is None else dict(guide_fn=guide_fn, fb_prob=1.0)
        return render_path(
            scene, width=width, height=height, spp=spp,
            max_bounces=self.config.max_bounces,
            camera_position=camera_position, mirror_threshold=0.9,
            impl=self.PROBE_IMPL, device=self.device,
            generator=torch.Generator(self.device).manual_seed(seed), **kw)[1]

    def probe_scene(self, max_candidates: int = 10):
        """The held-out probe scene with signal: variations 99, 98, ... until
        a traditional probe render records at least ``PROBE_MIN_SIGNAL``
        hits on the scored metric; variation 99 when none does.  Returns
        ``(scene, name, traditional_signal_hits)``."""
        fallback = None
        for v in range(99, 99 - max_candidates, -1):
            scene, name = self.make_scene(v)[:2]
            if fallback is None:
                fallback = (scene, name, 0)
            ts = self._probe_render(scene, (0.0, 0.5, 0.0), self.PROBE_WIDTH,
                                    self.PROBE_HEIGHT, self.PROBE_SPP, 0)
            sig = int(ts.small_light_hits if has_small_lights(scene)
                      else ts.light_hits)
            if sig >= self.PROBE_MIN_SIGNAL:
                return scene, name, sig
        return fallback

    def render_probe(self, scene: Optional[Scene] = None,
                     camera_position=(0.0, 0.5, 0.0), *,
                     width: Optional[int] = None,
                     height: Optional[int] = None,
                     spp: Optional[int] = None, seed: int = 0,
                     guide_fn=None) -> dict:
        """One small guided render and one traditional render on the same
        draws (a generator seeded ``seed``): the guided light-hit
        improvement on the deployment metric (small-light hits where the
        scene has small lights).  Deterministic in ``seed``."""
        if scene is None:
            scene = self.make_scene(99)[0]
        width = width or self.PROBE_WIDTH
        height = height or self.PROBE_HEIGHT
        spp = spp or self.PROBE_SPP
        args = (scene, camera_position, width, height, spp, seed)
        ts = self._probe_render(*args)
        gs = self._probe_render(*args,
                                guide_fn=guide_fn or self.agent_guide_fn())
        t_small, g_small = int(ts.small_light_hits), int(gs.small_light_hits)
        t_all, g_all = int(ts.light_hits), int(gs.light_hits)
        small = has_small_lights(scene)
        t_sig, g_sig = (t_small, g_small) if small else (t_all, g_all)
        return {
            "probe": f"{width}x{height}@{spp}spp "
                     f"max_bounces={self.config.max_bounces} seed={seed}",
            "metric": "small_light_hits" if small else "light_hits",
            "traditional_light_hits": t_all,
            "guided_light_hits": g_all,
            "traditional_small_light_hits": t_small,
            "guided_small_light_hits": g_small,
            "improvement": g_sig / max(t_sig, 1),
        }

    # -- main loop ---------------------------------------------------------
    def run_training(self, num_scenes: Optional[int] = None,
                     scenes_per_batch: int = 20,
                     training_steps_per_scene: int = 150,
                     scene_offset: int = 0) -> dict:
        """Train on ``num_scenes`` scenes from variation ``scene_offset``
        (a resumed run passes the scenes already trained).  With
        ``probe_every``, every that-many scenes runs ``render_probe`` on the
        probe scene, appends it to the report's ``render_probe_history``
        and keeps the best parameters in ``best_render_probe.npz``."""
        num_scenes = num_scenes or self.num_training_scenes
        t0 = time.time()
        self.probe_history: list = []
        probe_scene = probe_name = None
        if self.probe_every:
            probe_scene, probe_name, sig = self.probe_scene()
            if sig < self.PROBE_MIN_SIGNAL:
                print(f"render probe: no held-out variation with "
                      f"camera-reachable signal (falling back to "
                      f"{probe_name}; improvement will read raw guided "
                      f"counts)")
        best_probe = -1.0
        tb = None
        if self.tensorboard_log:
            from ..utils.tb import SummaryWriter, next_run_dir
            tb = SummaryWriter(next_run_dir(self.tensorboard_log, "FB"))
        try:
            for i in range(num_scenes):
                scene, name, stype = self.make_scene(scene_offset + i)
                hit_rate = self.train_on_scene(
                    scene, name, episodes=training_steps_per_scene)
                if tb is not None:
                    step = len(self.all_performances)
                    tb.add_scalar("train/scene_hit_rate", hit_rate * 100.0,
                                  step)
                    tb.add_scalar("train/noise_scale",
                                  float(self.agent.noise_scale), step)
                self.agent.note_scene_performance(stype.split("_")[0],
                                                  hit_rate)
                real = scene.radius > 0
                self.all_performances.append({
                    "scene": name, "scene_type": stype.split("_")[0],
                    "hit_rate": hit_rate * 100.0,
                    "objects": int(real.sum()),
                    "lights": int(((scene.emitive > 0) & real).sum()),
                })
                if self.probe_every and (i + 1) % self.probe_every == 0:
                    pr = self.render_probe(probe_scene)
                    pr["scene"] = probe_name
                    pr["after_scene"] = i + 1
                    self.probe_history.append(pr)
                    self.agent.note_generalization(pr["improvement"])
                    if tb is not None:
                        tb.add_scalar("train/render_probe_improvement",
                                      pr["improvement"],
                                      len(self.all_performances) - 1)
                    if pr["improvement"] > best_probe:
                        best_probe = pr["improvement"]
                        self.agent.save(self.output_dir /
                                        "best_render_probe.npz")
                if (i + 1) % scenes_per_batch == 0:
                    self._save_batch((i + 1) // scenes_per_batch)
        finally:
            if tb is not None:
                tb.close()
        self.agent.save(self.output_dir / "fb_multi_scene_final.npz")
        report = self._final_report(time.time() - t0)
        with open(self.output_dir / "final_training_report.json", "w") as f:
            json.dump(report, f, indent=2)
        return report

    def _save_batch(self, bno: int):
        self.agent.save(self.output_dir / f"checkpoint_batch_{bno}.npz")
        with open(self.output_dir / f"performance_batch_{bno}.json",
                  "w") as f:
            json.dump(self.all_performances, f, indent=2)

    def _final_report(self, elapsed: float) -> dict:
        perfs = self.all_performances
        by_type: dict = {}
        for p in perfs:
            by_type.setdefault(p["scene_type"], []).append(p["hit_rate"])
        scene_type_performance = {
            t: {"count": len(v), "avg_hit_rate": float(np.mean(v)),
                "min_hit_rate": float(np.min(v)),
                "max_hit_rate": float(np.max(v))}
            for t, v in by_type.items()}
        losses = [x for x in self.agent.losses if np.isfinite(x)]
        summary = {
            "config": self.config.to_dict(),
            "device": str(self.device),
            "total_training_time": elapsed,
            "final_buffer_size": self.agent.buffer.size,
            "agent_stats": self.agent.get_stats(),
        }
        if getattr(self, "probe_history", None):
            summary["render_probe_history"] = self.probe_history
        return {
            "training_summary": summary,
            "performance_statistics": {
                "total_scenes_trained": len(perfs),
                "successful_scenes": len(perfs),
                "success_rate": 100.0,
                "avg_hit_rate": float(np.mean([p["hit_rate"]
                                               for p in perfs]) / 100.0)
                                if perfs else 0.0,
                "avg_loss": float(np.mean(losses)) if losses else None,
                "scene_types_trained": len(by_type),
            },
            "scene_type_performance": scene_type_performance,
            "all_performances": perfs,
        }

    # -- held-out evaluation ----------------------------------------------
    def test_on_scene(self, scene: Scene, num_tests: int = 200,
                      action_fn=None) -> dict:
        """The one-step held-out test (JAX ``test_on_scene``;
        FB/train_chandelier_only.py:199-300): random surface points, the
        agent's action (or ``action_fn(obs [N, 22]) -> [N, 2]``), one test
        ray each, against a cosine-sampled random baseline; from the
        reference's uniform non-light starts and from scene-core starts
        (``*_core``, the 1/(1+r) bias).  Draws come from the trainer's
        generator, the agent's noise from the agent's."""
        emissive = scene.emitive > 0
        real = scene.radius > 0
        small = scene.radius < 0.5
        table = cuda_intersect.sphere_table(scene)
        dev, n = self.device, num_tests
        ninf = torch.tensor(float("-inf"), device=dev)

        def cast(origin, d, idx):
            _, hidx, found = cuda_intersect.nearest_hit(
                origin, d.contiguous(), scene.id[idx].contiguous(), table,
                by_abs=True)
            hidx = hidx.long()
            return found & emissive[hidx], hidx

        def probe(logits):
            gumbel = -torch.log(-torch.log(torch.clamp_min(torch.rand(
                (n, scene.num_spheres), generator=self._gen, device=dev),
                torch.finfo(torch.float32).tiny)))
            idx = torch.argmax(gumbel + logits, dim=-1)
            u = torch.rand((3, n, 2), generator=self._gen, device=dev)
            point, normal = sampling.uniform_on_sphere(
                u[0], scene.centre[idx], scene.radius[idx])
            incoming = sampling.cosine_weighted(u[1], normal, "trainer")
            zeros = torch.zeros((n,), device=dev)
            obs = make_observation(point, normal, incoming, zeros,
                                   torch.zeros((n, 3), device=dev), scene,
                                   idx, self.config.max_bounces)
            if action_fn is not None:
                action = torch.as_tensor(action_fn(obs))
            else:
                action = torch.from_numpy(np.atleast_2d(
                    self.agent.choose_direction_research(
                        obs.cpu().numpy())[0]))
            action = action.to(dev, torch.float32)
            origin = (point + normal * 0.001).contiguous()
            d = sampling.fb_action_to_direction(action, normal, "trainer")
            hits, hidx = cast(origin, d, idx)
            shits = hits & small[hidx]
            rand, _ = cast(origin, sampling.cosine_weighted(
                u[2], normal, "trainer"), idx)
            return (float(hits.float().mean()), float(shits.float().mean()),
                    float(rand.float().mean()))

        mask = emissive | ~real
        a, s, r = probe(torch.where(mask, ninf, 0.0))
        a_c, s_c, r_c = probe(torch.where(mask, ninf,
                                          -torch.log1p(scene.radius)))
        if r_c > 0:
            self.agent.note_generalization(a_c / r_c)
        return {
            "num_tests": num_tests,
            "agent_hit_rate": a,
            "agent_small_light_rate": s,
            "random_hit_rate": r,
            "agent_hit_rate_core": a_c,
            "agent_small_light_rate_core": s_c,
            "random_hit_rate_core": r_c,
        }

    def _held_out(self, scene_type: str, filename: str,
                  num_tests: int) -> dict:
        scene, _ = templates.generate_scene(scene_type, 99,
                                            pad_to=self.PAD_TO,
                                            device=self.device)
        result = self.test_on_scene(scene, num_tests)
        with open(self.output_dir / filename, "w") as f:
            json.dump(result, f, indent=2)
        return result

    def test_on_complex(self, num_tests: int = 200) -> dict:
        return self._held_out("complex_scene", "held_out_complex_test.json",
                              num_tests)


class ChandelierOnlyTrainer(MultiSceneFBTrainer):
    """FB/train_chandelier_only.py:186-197: chandelier variations only,
    max_bounces 8, forward 512 / backward 256, walkers starting "mixed"
    (a share on the wall surfaces a 4:3 view sees)."""

    START_BIAS = "mixed"

    def __init__(self, num_training_scenes: int = 100, **kw):
        cfg = kw.pop("config", None) or FBConfig(max_bounces=8,
                                                 f_hidden_dim=512,
                                                 b_hidden_dim=256)
        super().__init__(num_training_scenes, config=cfg, **kw)

    def make_scene(self, i: int):
        scene, name = templates.generate_scene("chandelier_scene", i,
                                               pad_to=self.PAD_TO,
                                               device=self.device)
        return scene, name, "chandelier"

    def test_on_chandelier(self, num_tests: int = 200) -> dict:
        return self._held_out("chandelier_scene",
                              "held_out_chandelier_test.json", num_tests)


class RayTracedComplexTrainer(MultiSceneFBTrainer):
    """FB/train_complex_only.py:245-365: complex variations only, max
    bounces 8."""

    def __init__(self, num_training_scenes: int = 100, **kw):
        cfg = kw.pop("config", None) or FBConfig(max_bounces=8)
        super().__init__(num_training_scenes, config=cfg, **kw)

    def make_scene(self, i: int):
        scene, name = templates.generate_scene("complex_scene", i,
                                               pad_to=self.PAD_TO,
                                               device=self.device)
        return scene, name, "complex"
