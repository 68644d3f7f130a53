"""The path tracer: ``raytracer_tpu_torch``'s ``render_path`` as a cell
runs it (the chandelier scene, the shipped student or the FB agent as its
guide), and its plain reference (``portbench/reference/``).

The reference renders each sampled frame again from the same planes
(drawn anew from ``(seed, frame index)``) and the same inputs (the
student's file, the agent's seeded parameters); its counters are the six
``PathStats`` counters.  Its control is the reference at the precision
below the configuration's (``reference/guides.py``; the unguided tracer
in bfloat16), put in the program's place, which the limits must fail
(``tools/readings.py``, ``tests/``).
"""
from __future__ import annotations

import json
import os
import tempfile
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from .. import inputs
from ..reference import guides, plain, work


def samples_per_frame(cell: dict) -> int:
    """Camera samples a frame: W x H x spp."""
    mix = cell["mix"]
    return mix["width"] * mix["height"] * mix["spp"]


def has_tf32_path(cell: dict) -> bool:
    """Whether the program's products are float32 (the agent guides), so
    that the program with TF32 on is a control of its own."""
    return (cell["mix"]["guided"]
            and cell["config_data"]["precision"]["guide"] == "float32")


def counters():
    """The program's counters, or None for a program that keeps none."""
    try:
        from raytracer_tpu_torch.utils.profiling import counters as read
    except ImportError:
        return None
    return read()


def _planes(cell: dict, seed: int, index: int, diffuse: bool, device):
    mix = cell["mix"]
    return inputs.planes(seed, index, width=mix["width"],
                         height=mix["height"], spp=mix["spp"],
                         max_bounces=cell["config_data"]["max_bounces"],
                         diffuse=diffuse, guided=mix["guided"], device=device)


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
                    inputs.student_file(cfg["guide"])).as_guide_fn("auto")
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
                                   config=config,
                                   seed=inputs.prototype_seed(seed),
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
        counters = torch.stack([getattr(stats, n) for n in plain.COUNTERS])
        if image.is_cuda:
            host = torch.empty(image.shape, dtype=image.dtype,
                               pin_memory=True)
            host.copy_(image)
            image = host
        return image.cpu(), counters.cpu()

    def close(self):
        self.guide = self.timed = self.scene = None


class Session:
    """The program set up for a cell, with the harness's draws: the
    agent's parameters (``inputs``) and each frame's planes."""

    def __init__(self, cell: dict, seed: int, device, trace: bool,
                 tracer=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg, mix = cell["config_data"], cell["mix"]
        rows = plain.scene_rows(cfg["scene"]["spheres"])
        self.diffuse = not plain.no_diffuse_possible(rows,
                                                     mix["mirror_threshold"])
        self.inputs = None
        if mix["guided"] and cfg["guide"]["kind"] == "fb_agent":
            self.inputs = inputs.agent_params(seed, cfg["guide"], self.device)
        timed = trace and self.device.type == "cuda"
        self.program = Program(cell, seed, self.device, self.inputs,
                               timed_guide=timed,
                               span=tracer.span if tracer else None)
        self.guide_ms: Optional[List[float]] = [] if (
            self.program.timed is not None) else None

    def planes(self, index: int) -> dict:
        return _planes(self.cell, self.seed, index, self.diffuse, self.device)

    def render(self, planes: dict):
        return self.program.render(planes)

    def setup_done(self) -> None:
        """The warm-up's guide time left out of the window's."""
        if self.guide_ms is not None:
            self.program.timed.take()

    def frame_done(self) -> None:
        if self.guide_ms is not None:
            self.guide_ms.append(self.program.timed.take())

    def run_fields(self) -> dict:
        return {"diffuse": self.diffuse, "guide_ms": self.guide_ms}

    def close(self) -> None:
        self.program.close()
        self.program = None


class Reference:
    """The plain reference for one cell and seed: ``frame(index)`` gives
    the reference's image and counters for that frame of the window, and
    counts its work when ``count_work``.  ``precision``: None for the
    configuration's own, ``"control"`` for the control's."""

    def __init__(self, cell: dict, seed: int, device, params=None,
                 precision: Optional[str] = None, count_work: bool = False):
        cfg, mix = cell["config_data"], cell["mix"]
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.rows = plain.scene_rows(cfg["scene"]["spheres"])
        self.control = precision == "control"
        self.guide = None
        gcfg = cfg["guide"]
        if mix["guided"]:
            if gcfg["kind"] == "student":
                self.guide = guides.Student(
                    guides.load_student(inputs.student_file(gcfg)),
                    self.device, "fp8" if self.control else "bf16")
            else:
                agent = guides.Agent(params, gcfg["z_dim"],
                                     "tf32" if self.control else "f32")
                agent.set_prototype(self.rows,
                                    cfg["scene"]["camera_position"],
                                    inputs.prototype_seed(seed))
                self.guide = agent
        # The unguided tracer's control is the tracer in bfloat16.
        self.dtype = (torch.bfloat16 if self.control and self.guide is None
                      else torch.float32)
        self.work = work.Work(self.rows) if count_work else None
        self.frames = 0
        self.fb_used = 0

    def planes(self, index: int) -> dict:
        return _planes(self.cell, self.seed, index,
                       not plain.no_diffuse_possible(
                           self.rows, self.cell["mix"]["mirror_threshold"]),
                       self.device)

    def frame(self, index: int):
        mix, cfg = self.cell["mix"], self.cell["config_data"]
        with torch.no_grad():
            image, counters = plain.frame(
                self.planes(index), self.rows, width=mix["width"],
                height=mix["height"], spp=mix["spp"],
                max_bounces=cfg["max_bounces"], fov=cfg["scene"]["fov"],
                camera=tuple(cfg["scene"]["camera_position"]),
                mirror_threshold=mix["mirror_threshold"],
                background=tuple(cfg["scene"]["background"]),
                guide=self.guide, fb_prob=mix.get("fb_prob", 1.0),
                guide_max_level=mix.get("guide_max_level"),
                dtype=self.dtype, on_level=self.work)
        self.frames += 1
        self.fb_used += int(counters[4])
        return image.cpu(), counters.cpu()

    def work_per_frame(self) -> Optional[dict]:
        """The mean work of the frames seen: the level counts, the guided
        rows, and the frame's rays and pixels."""
        if self.work is None or not self.frames:
            return None
        mix = self.cell["mix"]
        out = {k: v / self.frames for k, v in self.work.totals.items()}
        out["guided_rows"] = self.fb_used / self.frames
        out["pixels"] = mix["width"] * mix["height"]
        out["rays"] = out["pixels"] * mix["spp"]
        return out
