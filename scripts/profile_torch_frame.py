#!/usr/bin/env python3
"""Where the time of one port frame goes, on one NVIDIA GPU.

Runs the main path of the PyTorch/CUDA port (chandelier traditional frame,
800x600, 8 spp, 8 bounces, mirror_threshold=0.0) and reports:

* a staged breakdown on the host clock, each stage ended by
  ``torch.cuda.synchronize()``: jitter draw, camera, scene-table set-up,
  path kernel, stats sums, image assembly, and the whole ``render_path``;
* a ``torch.profiler`` window over a few frames: device time by kernel
  name and the device's idle share of the window;
* the pixel-centre frame (spp 1) traced by the kernel on the card and by
  the plain version on the CPU: how many camera directions and samples
  differ between the two devices.

Run from the repository root: ``python3 scripts/profile_torch_frame.py``.
Prints one JSON line per phase, with the card's name and power limit.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raytracer_tpu_torch.core import cuda_path  # noqa: E402
from raytracer_tpu_torch.render import path_renderer  # noqa: E402
from raytracer_tpu_torch.render.camera import perspective_rays  # noqa: E402
from raytracer_tpu_torch.scene.library import chandelier_scene  # noqa: E402
from raytracer_tpu_torch.trace.path import (  # noqa: E402
    PathStats, emissive_indices, no_diffuse_possible, scene_spec)

W, H, SPP, BOUNCES = 800, 600, 8, 8
BG = (2.0, 2.0, 5.0)
REPS = 10


def stage_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    scene, p = chandelier_scene(device=dev)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
              fov=p["fov"], camera_position=p["camera_position"],
              mirror_threshold=0.0, background=BG, device=dev)

    def frame():
        return path_renderer.render_path(
            scene, generator=torch.Generator(dev).manual_seed(0), **kw)

    for _ in range(3):
        frame()                          # build and warm up

    stages = {k: [] for k in ("jitter", "camera", "table", "kernel",
                              "stats", "assemble", "render_path")}
    for _ in range(REPS):
        g = torch.Generator(dev).manual_seed(0)
        jitter, t = stage_ms(lambda: torch.rand((SPP, H, W, 2), device=dev,
                                                generator=g))
        stages["jitter"].append(t)
        (o, d), t = stage_ms(lambda: perspective_rays(
            W, H, fov=p["fov"], origin=p["camera_position"],
            sample_xy=jitter))
        stages["camera"].append(t)

        def table():
            no_diffuse_possible(scene, 0.0)
            return cuda_path.path_table(scene_spec(scene),
                                        emissive_indices(scene), 0.0, dev)
        tab, t = stage_ms(table)
        stages["table"].append(t)
        o, d = o.contiguous(), d.contiguous()
        (rgb, counts), t = stage_ms(lambda: cuda_path.path_trace(
            o, d, None, tab, max_bounces=BOUNCES, background=BG))
        stages["kernel"].append(t)
        _, t = stage_ms(lambda: PathStats.from_counts(counts))
        stages["stats"].append(t)
        _, t = stage_ms(lambda: path_renderer._assemble(
            rgb, spp=SPP, height=H, width=W))
        stages["assemble"].append(t)
        _, t = stage_ms(frame)
        stages["render_path"].append(t)
    breakdown = {k: {"min_ms": min(v), "median_ms": sorted(v)[len(v) // 2]}
                 for k, v in stages.items()}
    results = [{"phase": "host_breakdown", **card, "reps": REPS,
                "stages": breakdown}]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            frame()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    device_us = 0.0
    for e in prof.key_averages():
        self_dev = getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        if self_dev > 0:
            rows.append({"name": e.key[:80], "calls": e.count,
                         "self_device_ms": self_dev / 1e3})
            device_us += self_dev
    rows.sort(key=lambda r: -r["self_device_ms"])
    results.append({"phase": "profiler", **card, "frames": 3,
                    "window_ms": window_ms, "device_busy_ms": device_us / 1e3,
                    "device_idle_share": 1 - device_us / 1e3 / window_ms,
                    "top": rows[:12]})
    # Card vs CPU on the pixel-centre frame.
    oc, dc = perspective_rays(W, H, fov=p["fov"],
                              origin=p["camera_position"], device=dev)
    oh, dh = perspective_rays(W, H, fov=p["fov"],
                              origin=p["camera_position"], device="cpu")
    tab_c = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.0, dev)
    tab_h = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.0, "cpu")
    rk, ck = cuda_path.path_trace(oc.contiguous(), dc, None, tab_c,
                                  max_bounces=BOUNCES, background=BG)
    rh, ch = cuda_path.path_trace_plain(oh.contiguous(), dh, None, tab_h,
                                        max_bounces=BOUNCES, background=BG)
    rk, ck = rk.cpu(), ck.cpu()
    diff = (rk != rh).any(-1)
    results.append({
        "phase": "card_vs_cpu", **card, "rays": W * H,
        "camera_dirs_differ": int((dc.cpu() != dh).any(-1).sum()),
        "samples_differ": int(diff.sum()),
        "max_abs_diff": float((rk - rh).abs().max()),
        "counts_card": ck.sum(0, dtype=torch.int64).tolist(),
        "counts_cpu": ch.sum(0, dtype=torch.int64).tolist(),
        "first_differing": [
            {"ray": int(i), "card": rk[i].tolist(), "cpu": rh[i].tolist(),
             "dir": dh[i].tolist()}
            for i in torch.nonzero(diff).ravel()[:5]]})
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
