"""The system under test: ``raytracer_tpu_torch``'s ``render_path`` as a
cell runs it.  The only module of the benchmark that imports the program,
and only inside ``Program``: the benchmark's own tests import this module
where the program is absent.
"""
from __future__ import annotations

import json
import os
import tempfile
from contextlib import nullcontext

import numpy as np
import torch

from .inputs import prototype_seed, student_file
from .reference.plain import COUNTERS


class TimedGuide:
    """A guide with CUDA events around each call (the harness's span of
    the guide layer); ``take()`` returns the milliseconds since the last
    take, on the card's clock."""

    def __init__(self, guide, span=None):
        self.guide, self.events = guide, []
        self.span = span or (lambda name: nullcontext())

    def __call__(self, obs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with self.span("guide"):
            a.record()
            out = self.guide(obs)
            b.record()
        self.events.append((a, b))
        return out

    def take(self) -> float:
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


class Program:
    """The port set up for one cell: its scene, its guide (the shipped
    student, or the FB agent on ``params``), and ``render(planes)``."""

    def __init__(self, cell: dict, seed: int, device, params=None,
                 timed_guide: bool = False, span=None):
        from raytracer_tpu_torch.render.path_renderer import render_path
        from raytracer_tpu_torch.scene.types import SceneBuilder
        self.render_path = render_path
        cfg, mix = cell["config_data"], cell["mix"]
        self.device = torch.device(device)
        b = SceneBuilder()
        for s in cfg["scene"]["spheres"]:
            b.add_sphere(tuple(s["centre"]), s["radius"], tuple(s["colour"]),
                         reflective=s.get("reflective", 0.0),
                         transparent=s.get("transparent", 0.0),
                         emitive=s.get("emitive", 0.0), ior=s.get("ior", 1.0),
                         id=s["id"])
        self.scene = b.build(device=self.device)[0]
        self.guide = None
        kind = cfg["guide"]["kind"]
        if mix["guided"]:
            if kind == "student":
                from raytracer_tpu_torch.fb.distill import DistilledGuide
                self.guide = DistilledGuide.load(
                    student_file(cfg["guide"])).as_guide_fn("auto")
            elif kind == "fb_agent":
                self.guide = self._agent(cfg, seed, params)
            else:
                raise ValueError(f"unknown guide kind {kind!r}")
        self.timed = None
        if timed_guide and self.guide is not None and kind != "student":
            self.timed = TimedGuide(self.guide, span)
        self.kw = dict(width=mix["width"], height=mix["height"],
                       spp=mix["spp"], max_bounces=cfg["max_bounces"],
                       fov=cfg["scene"]["fov"],
                       camera_position=tuple(cfg["scene"]["camera_position"]),
                       mirror_threshold=mix["mirror_threshold"],
                       background=tuple(cfg["scene"]["background"]),
                       fb_prob=mix.get("fb_prob", 1.0), impl=mix["impl"],
                       guide_max_level=mix.get("guide_max_level"),
                       device=self.device)

    def _agent(self, cfg, seed, params):
        """The FB agent from a native checkpoint of the harness's seeded
        parameters (the program's own loader and prototype)."""
        from raytracer_tpu_torch.fb.config import FBConfig
        from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                                      small_light_indices)
        g = cfg["guide"]
        config = FBConfig(z_dim=g["z_dim"], e_hidden_dim=g["e_hidden_dim"],
                          f_hidden_dim=g["f_hidden_dim"],
                          b_hidden_dim=g["b_hidden_dim"])
        flat = {f"{part}::{name}": t.detach().cpu().numpy()
                for part, p in params.items() for name, t in p.items()}
        meta = {"config": {k: g[k] for k in ("z_dim", "e_hidden_dim",
                                             "f_hidden_dim", "b_hidden_dim")},
                "noise_scale": 0.0, "updates": 0}
        fd, path = tempfile.mkstemp(suffix=".npz", prefix="portbench_agent_")
        os.close(fd)
        try:
            np.savez(path, __meta__=json.dumps(meta),
                     __light_memory__=np.zeros((0, g["z_dim"]), np.float32),
                     **flat)
            agent = TrainedFBAgent(path, self.scene,
                                   small_light_indices(self.scene),
                                   cfg["scene"]["camera_position"],
                                   config=config, seed=prototype_seed(seed),
                                   device=self.device)
        finally:
            os.unlink(path)
        return agent.as_guide_fn()

    def render(self, planes: dict):
        """One frame as a caller gets it: ``(image [H, W, 3], counters
        [6] int64)``, both on the host.  The image lands in page-locked
        host memory, as a client that receives frames one after another
        keeps it: a pageable copy is staged by the host's CPU, which made
        the host-paced frames' rate swing by a fifth between runs on an
        H100 (NVIDIA H100 80GB HBM3, 700 W)."""
        image, stats = self.render_path(
            self.scene, jitter=planes["jitter"],
            uniforms=planes.get("uniforms"),
            fb_uniforms=planes.get("fb_uniforms"),
            guide_fn=self.timed or self.guide, **self.kw)
        counters = torch.stack([getattr(stats, n) for n in COUNTERS])
        if image.is_cuda:
            host = torch.empty(image.shape, dtype=image.dtype,
                               pin_memory=True)
            host.copy_(image)
            image = host
        return image.cpu(), counters.cpu()

    def close(self):
        self.guide = self.timed = self.scene = None
