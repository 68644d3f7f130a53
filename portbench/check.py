"""Whether what the timed path produced is correct.

After the window, the reference renders each sampled frame again from the
same planes (drawn anew from ``(seed, frame index)``) and the same inputs
(the student's file, the agent's seeded parameters), and two numbers are
compared, each against the cell's limit (``workloads/<cell>.json``,
``check.limits``):

* ``pixels_off``: the share of the sampled frames' pixels whose value
  differs from the reference's in any channel;
* ``counters_off``: the largest relative gap, over the frames and the six
  ``PathStats`` counters, ``|program - reference| / max(reference, 1)``.

``Reference(precision="control")`` is the control: the reference at the
precision below the configuration's (``reference/guides.py``; the
unguided tracer in bfloat16), put in the program's place, which the
limits must fail (``tools/readings.py``, ``tests/``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import inputs
from .reference import guides, plain, work

NUMBERS = ("pixels_off", "counters_off")


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
                    guides.load_student(inputs.student_file(gcfg)), self.device,
                    "fp8" if self.control else "bf16")
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
        mix = self.cell["mix"]
        cfg = self.cell["config_data"]
        return inputs.planes(
            self.seed, index, width=mix["width"], height=mix["height"],
            spp=mix["spp"], max_bounces=cfg["max_bounces"],
            diffuse=not plain.no_diffuse_possible(self.rows,
                                                  mix["mirror_threshold"]),
            guided=mix["guided"], device=self.device)

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


def numbers(pairs) -> Dict[str, float]:
    """The compared numbers over ``[(program image, program counters,
    reference image, reference counters)]``, host tensors."""
    off = total = 0
    worst = 0.0
    for img, cnt, ref_img, ref_cnt in pairs:
        off += int((img != ref_img).any(dim=-1).sum())
        total += ref_img.shape[0] * ref_img.shape[1]
        gap = (cnt - ref_cnt).abs().double() / ref_cnt.abs().clamp_min(1)
        worst = max(worst, float(gap.max()))
    return {"pixels_off": off / max(total, 1), "counters_off": worst}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Each number at or under its limit."""
    return all(values[k] <= limits[k] for k in NUMBERS)


def lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {values[k]!r} limit {limits[k]!r}" for k in NUMBERS]
