#!/usr/bin/env python3
"""Where the time of the port's frames goes, on one NVIDIA GPU.

Runs the path tracer's frame (chandelier traditional, 800x600, 8 spp, 8
bounces, mirror_threshold=0.0), the guided frame (the same at
mirror_threshold=0.9, fb_prob=1.0, the shipped student; impl="kernel" and
impl="hybrid"), the full FB agent's frame (200x100, 8 spp, 8 bounces,
mirror_threshold=0.9, fb_prob=1.0, an agent at FBConfig()'s width with
seeded weights; impl="stepwise", with guide_max_level=3, and
impl="hybrid": the profiler window only) and the Whitted tracer's
(planets2, 2001x2001, 10 bounces) and reports, for each:

* a staged breakdown on the host clock, each stage ended by
  ``torch.cuda.synchronize()``: jitter draw, camera, scene-table set-up,
  path kernel, stats sums, image assembly, and the whole ``render_path``;
* a ``torch.profiler`` window over a few frames: device time by kernel
  name and the device's idle share of the window;
* the path tracer's pixel-centre frame (spp 1) traced by the kernel on
  the card and by the plain version on the CPU (guided: 200x150, spp 1),
  and the Whitted tracer's true_original 601x601 frame rendered both
  ways: how many rays and pixels differ between the two devices.

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
from raytracer_tpu_torch.fb.inference import (  # noqa: E402
    TrainedFBAgent, small_light_indices)
from raytracer_tpu_torch.fb.registry import (  # noqa: E402
    STUDENTS_DIR, guide_for)
from raytracer_tpu_torch.render import path_renderer  # noqa: E402
from raytracer_tpu_torch.render.camera import (  # noqa: E402
    grid_rays, perspective_rays)
from raytracer_tpu_torch.render.renderer import (  # noqa: E402
    material_flags, render_whitted)
from raytracer_tpu_torch.scene import library  # noqa: E402
from raytracer_tpu_torch.scene.library import chandelier_scene  # noqa: E402
from raytracer_tpu_torch.trace.shade import terminal_rgb  # noqa: E402
from raytracer_tpu_torch.trace.path import (  # noqa: E402
    PathStats, emissive_indices, no_diffuse_possible, scene_spec, trace_path)

W, H, SPP, BOUNCES = 800, 600, 8, 8
BG = (2.0, 2.0, 5.0)
REPS = 10


def stage_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile(frame, frames=3):
    """``torch.profiler`` over a few frames: the window, device time by
    kernel name and the device's idle share of the window."""
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
    device_us = sum(us for _, us in by_name.values())
    rows = sorted(({"name": k[:80], "calls": c, "device_ms": us / 1e3}
                   for k, (c, us) in by_name.items()),
                  key=lambda r: -r["device_ms"])
    return {"window_ms": window_ms, "device_busy_ms": device_us / 1e3,
            "device_idle_share": 1 - device_us / 1e3 / window_ms,
            "top": rows[:12]}


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


def guided(dev, card, scene, p):
    """The guided 800x600@8spp/8 frame (mirror_threshold=0.9, fb_prob=1.0,
    the shipped student): stages of ``render_path(impl="kernel")``, the
    profiler over both impls, and the card against the CPU."""
    guide = guide_for("chandelier", W, H, STUDENTS_DIR)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
              fov=p["fov"], camera_position=p["camera_position"],
              mirror_threshold=0.9, background=BG, device=dev,
              guide_fn=guide, fb_prob=1.0)

    def frame(impl="kernel"):
        return path_renderer.render_path(
            scene, generator=torch.Generator(dev).manual_seed(0), impl=impl,
            **kw)

    for impl in ("kernel", "hybrid"):
        frame(impl)                      # build and warm up
    stages = {k: [] for k in ("jitter", "draws", "camera", "table",
                              "kernel", "stats", "assemble", "render_path",
                              "render_path_hybrid")}
    for _ in range(REPS):
        g = torch.Generator(dev).manual_seed(0)
        jitter, t = stage_ms(lambda: torch.rand((SPP, H, W, 2), device=dev,
                                                generator=g))
        stages["jitter"].append(t)
        R = SPP * H * W
        (u, f), t = stage_ms(lambda: (
            torch.rand((BOUNCES, R, 2), generator=g, device=dev),
            torch.rand((BOUNCES, R), generator=g, device=dev)))
        stages["draws"].append(t)
        (o, d), t = stage_ms(lambda: perspective_rays(
            W, H, fov=p["fov"], origin=p["camera_position"],
            sample_xy=jitter))
        stages["camera"].append(t)

        def table():
            no_diffuse_possible(scene, 0.9)
            return cuda_path.path_table(scene_spec(scene),
                                        emissive_indices(scene), 0.9, dev)
        tab, t = stage_ms(table)
        stages["table"].append(t)
        o, d = o.contiguous(), d.contiguous()
        (rgb, counts), t = stage_ms(lambda: cuda_path.path_trace(
            o, d, u, tab, max_bounces=BOUNCES, background=BG, guide=guide,
            fb_uniforms=f, fb_prob=1.0))
        stages["kernel"].append(t)
        _, t = stage_ms(lambda: PathStats.from_counts(counts))
        stages["stats"].append(t)
        _, t = stage_ms(lambda: path_renderer._assemble(
            rgb, spp=SPP, height=H, width=W))
        stages["assemble"].append(t)
        _, t = stage_ms(frame)
        stages["render_path"].append(t)
        _, t = stage_ms(lambda: frame("hybrid"))
        stages["render_path_hybrid"].append(t)
    breakdown = {k: {"min_ms": min(v), "median_ms": sorted(v)[len(v) // 2]}
                 for k, v in stages.items()}
    out = [{"phase": "guided_host_breakdown", **card, "reps": REPS,
            "frame": f"{W}x{H}@{SPP}spp/{BOUNCES} guided",
            "stages": breakdown}]
    for impl in ("kernel", "hybrid"):
        out.append({"phase": f"guided_profiler_{impl}", **card, "frames": 3,
                    **profile(lambda: frame(impl))})
    # Card vs CPU: pixel centres at 200x150, the plain version on the CPU.
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
    out.append({"phase": "guided_card_vs_cpu", **card, "rays": w * h,
                "samples_differ": int(diff.sum()),
                "max_abs_diff": float((res[0][0] - res[1][0]).abs().max()),
                "stats_card": res[0][1], "stats_cpu": res[1][1]})
    return out


def agent(dev, card, scene, p):
    """The full FB agent's 200x100@8spp/8 frame on its three routes: the
    profiler over two frames each (the guide's GEMMs and elementwise
    kernels, the level's, the device's idle share)."""
    guide = TrainedFBAgent(None, scene, small_light_indices(scene),
                           p["camera_position"], seed=0,
                           device=dev).as_guide_fn()
    kw = dict(width=200, height=100, spp=SPP, max_bounces=BOUNCES,
              fov=p["fov"], camera_position=p["camera_position"],
              mirror_threshold=0.9, background=BG, device=dev,
              guide_fn=guide, fb_prob=1.0)
    out = []
    for name, rkw in (("stepwise", dict(impl="stepwise")),
                      ("stepwise_guide_max_level_3",
                       dict(impl="stepwise", guide_max_level=3)),
                      ("hybrid", dict(impl="hybrid"))):
        def frame(rkw=rkw):
            return path_renderer.render_path(
                scene, generator=torch.Generator(dev).manual_seed(0), **rkw,
                **kw)

        frame()                          # build and warm up
        out.append({"phase": f"fb_agent_profiler_{name}", **card,
                    "frame": f"200x100@{SPP}spp/{BOUNCES}", "frames": 2,
                    **profile(frame, frames=2)})
    return out


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

    results.append({"phase": "profiler", **card, "frames": 3,
                    **profile(frame)})
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
    results += guided(dev, card, scene, p)
    results += agent(dev, card, scene, p)
    results += whitted(dev, card)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
