#!/usr/bin/env python3
"""The Whitted frame's breakdown, and the port's frames on the card against
the CPU, on one NVIDIA GPU.

Runs the Whitted tracer's frame (planets2, 2001x2001, 10 bounces) and
reports:

* a staged breakdown on the host clock, each stage ended by
  ``torch.cuda.synchronize()``: camera, table set-up, Whitted kernel,
  shading, image assembly, and the whole ``render_whitted``;
* a ``torch.profiler`` window over a few frames: device time by kernel
  name;

and how many rays and pixels differ between the card and the CPU: the
path tracer's pixel-centre frame (chandelier traditional, 800x600, spp 1,
8 bounces, mirror_threshold=0.0) and its guided frame (200x150, spp 1,
mirror_threshold=0.9, fb_prob=1.0, the shipped student) traced by the
kernel on the card and by the plain version on the CPU, and the Whitted
tracer's true_original 601x601 frame rendered both ways.  The path
frames' breakdowns are the spans the program records
(``utils/profiling.py::span``) in a traced run: ``portbench/run.py
--trace 1``, or any ``torch.profiler`` session.

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

from raytracer_tpu_torch.core import (  # noqa: E402
    cuda_intersect, cuda_path, cuda_whitted)
from raytracer_tpu_torch.core.vec import div_scalar  # noqa: E402
from raytracer_tpu_torch.fb.registry import (  # noqa: E402
    STUDENTS_DIR, guide_for)
from raytracer_tpu_torch.render.camera import (  # noqa: E402
    grid_rays, perspective_rays)
from raytracer_tpu_torch.render.renderer import (  # noqa: E402
    material_flags, render_whitted)
from raytracer_tpu_torch.scene import library  # noqa: E402
from raytracer_tpu_torch.scene.library import chandelier_scene  # noqa: E402
from raytracer_tpu_torch.trace.shade import terminal_rgb  # noqa: E402
from raytracer_tpu_torch.trace.path import (  # noqa: E402
    emissive_indices, scene_spec, trace_path)

W, H, BOUNCES = 800, 600, 8
BG = (2.0, 2.0, 5.0)
REPS = 10


def stage_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile(frame, frames=3):
    """``torch.profiler`` over a few frames: the window and device time by
    kernel name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # Device time from the kernels' own events only: key_averages() also
    # gives each aten operator the device time of its kernels, so summing
    # every row counts that time twice.
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    rows = sorted(({"name": k[:80], "calls": c, "device_ms": us / 1e3}
                   for k, (c, us) in by_name.items()),
                  key=lambda r: -r["device_ms"])
    return {"window_ms": window_ms, "top": rows[:12]}


def whitted(dev, card):
    """The planets2 2001x2001@10 Whitted frame: stages, profiler, and the
    true_original 601x601 frame on the card against the CPU."""
    scene, gl, pl, p = library.planets2_scene(device=dev)
    kw = dict(max_bounces=p["max_bounces"], background=p["background"])
    o, d, h, w = grid_rays(p["ray_count"], p["ray_step"], p["multiple"],
                           origin=p["camera_position"], device=dev)

    def frame():
        return render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)

    for _ in range(3):
        frame()                          # build and warm up
    stages = {k: [] for k in ("camera", "setup", "kernel", "shading",
                              "assemble", "render_whitted")}
    for _ in range(REPS):
        _, t = stage_ms(lambda: grid_rays(
            p["ray_count"], p["ray_step"], p["multiple"],
            origin=p["camera_position"], device=dev))
        stages["camera"].append(t)
        (_, table), t = stage_ms(lambda: (
            material_flags(scene), cuda_intersect.sphere_table(scene)))
        stages["setup"].append(t)
        res, t = stage_ms(lambda: cuda_whitted.whitted_trace(
            o, d, None, table, max_bounces=p["max_bounces"]))
        stages["kernel"].append(t)
        rgb, t = stage_ms(lambda: terminal_rgb(
            scene, gl, pl, res, kw["background"], impl="kernel"))
        stages["shading"].append(t)
        bg = torch.tensor(kw["background"], dtype=torch.float32, device=dev)
        _, t = stage_ms(lambda: torch.clamp_max(div_scalar(torch.where(
            res.hit[:, None], rgb, bg[None, :]).reshape(h, w, 3), 255.0),
            1.0))
        stages["assemble"].append(t)
        _, t = stage_ms(frame)
        stages["render_whitted"].append(t)
    breakdown = {k: {"min_ms": min(v), "median_ms": sorted(v)[len(v) // 2]}
                 for k, v in stages.items()}
    out = [{"phase": "whitted_host_breakdown", **card, "reps": REPS,
            "frame": f"planets2 {w}x{h}/{p['max_bounces']}",
            "stages": breakdown},
           {"phase": "whitted_profiler", **card, "frames": 3,
            **profile(frame)}]
    s6, g6, p6, q = library.true_original_scene(device=dev)
    imgs = []
    for device in (dev, "cpu"):
        o6, d6, h6, w6 = grid_rays(q["ray_count"], q["ray_step"],
                                   q["multiple"], origin=q["camera_position"],
                                   device=device)
        imgs.append(render_whitted(
            s6, g6, p6, o6, d6, h6, w6, max_bounces=q["max_bounces"],
            background=q["background"]).cpu())
    diff = (imgs[0] != imgs[1]).any(-1)
    out.append({"phase": "whitted_card_vs_cpu", **card,
                "frame": f"true_original {w6}x{h6}/{q['max_bounces']}",
                "pixels_differ": int(diff.sum()),
                "max_abs_diff": float((imgs[0] - imgs[1]).abs().max())})
    return out


def guided(dev, card, p):
    """The guided frame (mirror_threshold=0.9, fb_prob=1.0, the shipped
    student) at pixel centres, 200x150: the kernel on the card against the
    plain version on the CPU."""
    guide = guide_for("chandelier", W, H, STUDENTS_DIR)
    w, h = 200, 150
    res = []
    for device in (dev, "cpu"):
        sc = chandelier_scene(device=device)[0]
        oc, dc = perspective_rays(w, h, fov=p["fov"],
                                  origin=p["camera_position"], device=device)
        g = torch.Generator().manual_seed(1)
        u = torch.rand((BOUNCES, w * h, 2), generator=g).to(device)
        f = torch.rand((BOUNCES, w * h), generator=g).to(device)
        rgb, st = trace_path(sc, oc, dc, max_bounces=BOUNCES,
                             mirror_threshold=0.9, background=BG,
                             uniforms=u, fb_uniforms=f, guide_fn=guide,
                             fb_prob=1.0)
        res.append((rgb.cpu(), st.as_dict()))
    diff = (res[0][0] != res[1][0]).any(-1)
    return [{"phase": "guided_card_vs_cpu", **card, "rays": w * h,
             "samples_differ": int(diff.sum()),
             "max_abs_diff": float((res[0][0] - res[1][0]).abs().max()),
             "stats_card": res[0][1], "stats_cpu": res[1][1]}]


def main():
    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    scene, _, _, p = chandelier_scene(device=dev)
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
    results = [{
        "phase": "card_vs_cpu", **card, "rays": W * H,
        "camera_dirs_differ": int((dc.cpu() != dh).any(-1).sum()),
        "samples_differ": int(diff.sum()),
        "max_abs_diff": float((rk - rh).abs().max()),
        "counts_card": ck.sum(0, dtype=torch.int64).tolist(),
        "counts_cpu": ch.sum(0, dtype=torch.int64).tolist(),
        "first_differing": [
            {"ray": int(i), "card": rk[i].tolist(), "cpu": rh[i].tolist(),
             "dir": dh[i].tolist()}
            for i in torch.nonzero(diff).ravel()[:5]]}]
    results += guided(dev, card, p)
    results += whitted(dev, card)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
