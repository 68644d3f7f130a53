#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It builds the
port's CUDA kernels with nvcc (all sources at once), then drives its two
paths, each with the kernels' launch counts set to 0 just before and read
just after:

* the path tracer: the chandelier path-traced frame, 800x600, 8 spp, 8
  bounces, mirror_threshold=0.0, through ``render_path``;
* the Whitted tracer: planets2 at 2001x2001, 10 bounces, and marbles4 at
  801x801, 8 bounces, through ``render_whitted`` (the whole-trace Whitted
  kernel, and the nearest-hit kernel for the shadow sweeps).

It holds every kernel against its plain PyTorch version, checks frames
against the executed-reference goldens, times everything on the card's
clock and prints JSON lines.  The last line is ``{"ok": true, "device":
{...}}``; any failed phase exits non-zero before it.  Without a CUDA
device it exits 1 and prints no result.
"""
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.core import (cuda_intersect, cuda_path,
                                      cuda_whitted, native)
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS
from raytracer_tpu_torch.render.camera import grid_rays, perspective_rays
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.render.renderer import material_flags, render_whitted
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.trace.path import (emissive_indices, scene_spec,
                                            trace_path)
from raytracer_tpu_torch.trace.whitted import trace_whitted

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "showcase" / "parity_fullres" / "chandelier_800x600_ref.npy"
WHITTED_GOLDEN = (ROOT / "showcase" / "parity_fullres" /
                  "true_original_601_ref.npy")
SOURCES = ("path_trace", "whitted_trace", "nearest_hit")
SEED = 0
W, H, SPP, BOUNCES = 800, 600, 8, 8
BG = (2.0, 2.0, 5.0)

# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations of csrc/path_trace.cu, counted from its code: the sweep per
# sphere and ray-level run; per continuing level, direct light per emissive
# sphere and the fixed rest (hit point, normal, reflection, offset, fold);
# the first normalisation per ray.
OPS_SWEEP_PER_SPHERE = 26
OPS_DIRECT_PER_LIGHT = 32
OPS_CONTINUE_FIXED = 82
OPS_PER_RAY = 10
BYTES_PER_RAY = 24 + 12 + 16     # origin + direction in; rgb + counts out
# f32 operations of csrc/whitted_trace.cu and csrc/nearest_hit.cu, counted
# from their code (csrc/sphere.cuh sweep; whitted_trace.cu helpers): the
# sweep per sphere and ray-level; per level run, the hit point, normal and
# budget test; a mirror bounce (reflect3); a glass entry (refract3 in and a
# far-root exit); per walk step the outward refract3, and per internal
# reflection a reflect3 and a far-root exit; the first normalisation.
W_OPS_SWEEP_PER_SPHERE = 26
W_OPS_LEVEL = 20
W_OPS_MIRROR = 42
W_OPS_GLASS_ENTRY = 98
W_OPS_WALK_STEP = 61
W_OPS_WALK_REFLECT = 82
W_OPS_PER_RAY = 10
W_BYTES_IN, W_BYTES_SUPPRESS, W_BYTES_OUT = 24, 4, 1 + 4 + 4 + 12 + 12 + 4 + 4
NH_BYTES_OUT = 4 + 4 + 1          # t, idx, found
# Fallback bounds of the Whitted kernel, the JAX package's own for its TPU
# kernel (tests/test_pallas_whitted.py:28-49): discrete fields exact, floats
# within rtol/atol 2e-4, at most 0.1% of pixels off by more than 1/255.
W_RTOL = W_ATOL = 2e-4
W_PIXELS_OFF = 1e-3


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card's clock (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, nbytes):
    """Least time for ``ops`` f32 operations and ``nbytes`` bytes: the
    larger of the two over the card's peaks, and which one sets it."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def bound_ms(counts, n_spheres, n_emissive, max_bounces, n_rays):
    """Least time for the kernel's work on these inputs: the larger of its
    f32 operations over the f32 peak and its bytes over the HBM rate."""
    c = counts.to(torch.int64)
    levels_run = torch.clamp_max(c[:, 0], max_bounces).sum().item()
    levels_cont = (c[:, 1] - c[:, 2]).sum().item()
    ops = (OPS_PER_RAY * n_rays
           + OPS_SWEEP_PER_SPHERE * n_spheres * levels_run
           + (OPS_DIRECT_PER_LIGHT * n_emissive + OPS_CONTINUE_FIXED)
           * levels_cont)
    nbytes = BYTES_PER_RAY * n_rays
    return (*bound(ops, nbytes), ops, nbytes)


def stats_close(a, b, rel):
    return all(abs(a[k] - b[k]) <= rel * max(abs(b[k]), 1) for k in b)


def reset_counts():
    """Every kernel's launch count to 0."""
    cuda_path.path_trace.launches = 0
    cuda_whitted.whitted_trace.launches = 0
    cuda_intersect.nearest_hit.launches = 0


def read_counts():
    return {"path_trace": cuda_path.path_trace.launches,
            "whitted_trace": cuda_whitted.whitted_trace.launches,
            "nearest_hit": cuda_intersect.nearest_hit.launches}


def notebook_frame(name, multiple, dev):
    """A library scene and its grid camera at ``multiple`` (host ms of the
    camera, which builds float64 numpy on the host, beside it)."""
    scene, gl, pl, p = getattr(library, name + "_scene")(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o, d, h, w = grid_rays(p["ray_count"], p["ray_step"], multiple,
                           origin=p["camera_position"], device=dev)
    torch.cuda.synchronize()
    camera_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p.get("sky_colour"))
    return scene, gl, pl, o, d, h, w, kw, camera_ms


def compare_traces(a, b):
    """``(bit_equal, max |float diff|, within the fallback bound)``."""
    discrete = all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("hit", "idx", "bounces", "through"))
    floats = ("t", "point", "normal")
    err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
              for f in floats)
    close = all(torch.allclose(getattr(a, f), getattr(b, f), rtol=W_RTOL,
                               atol=W_ATOL) for f in floats)
    return discrete and err == 0.0, err, discrete and close


def compare_images(a, b):
    """``(bit_equal, max |diff|, share of pixels off by more than 1/255)``."""
    diff = (a - b).abs()
    off = float((diff.amax(-1) > 1 / 255 + 1e-7).float().mean())
    return bool(torch.equal(a, b)), float(diff.max()), off


def whitted_phases(dev, card):
    """The Whitted path's phases; returns its two ``kernels`` entries."""
    # whitted_main: planets2 2001x2001@10 and marbles4 801x801@8 through
    # render_whitted, kernel then plain.
    main = {}
    for name, multiple in (("planets2", 10), ("marbles4", 4)):
        t0 = time.perf_counter()
        scene, gl, pl, o, d, h, w, kw, camera_ms = notebook_frame(
            name, multiple, dev)
        reset_counts()
        img_k = render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)
        torch.cuda.synchronize()
        launches = read_counts()
        check(launches["whitted_trace"] >= 1,
              f"{name}: render_whitted launched no whitted_trace kernel")
        check(launches["nearest_hit"] >= pl.count >= 1,
              f"{name}: the shadow sweeps launched no nearest_hit kernel")
        img_p = render_whitted(scene, gl, pl, o, d, h, w, impl="plain", **kw)
        torch.cuda.synchronize()
        check(tuple(img_k.shape) == (h, w, 3), f"image shape {img_k.shape}")
        check(bool(torch.isfinite(img_k).all()), "non-finite pixels")
        check(float(img_k.min()) >= 0.0 and float(img_k.max()) <= 1.0,
              "pixels outside [0, 1]")
        img_equal, img_err, img_off = compare_images(img_k, img_p)
        eg, em = material_flags(scene)
        tkw = dict(enable_glass=eg, enable_mirror=em)
        res_k = trace_whitted(scene, o, d, kw["max_bounces"], impl="kernel",
                              **tkw)
        res_p = trace_whitted(scene, o, d, kw["max_bounces"], impl="plain",
                              **tkw)
        tr_equal, tr_err, tr_close = compare_traces(res_k, res_p)
        hit_frac = float(res_k.hit.float().mean())
        emit({"phase": "whitted_main", "scene": name,
              "frame": f"{w}x{h}/{kw['max_bounces']}", "rays": h * w,
              "launches": launches, "image_bit_equal": img_equal,
              "image_max_abs_err": img_err, "pixels_off_fraction": img_off,
              "trace_bit_equal": tr_equal, "trace_max_abs_err": tr_err,
              "hit_fraction": hit_frac,
              "max_through": int(res_k.through.max()),
              "max_bounces_reached": int(res_k.bounces.max()),
              "grid_rays_ms": camera_ms,
              "seconds": time.perf_counter() - t0})
        check(0.0 < hit_frac <= 1.0, f"{name}: no ray hit anything")
        check((img_equal or img_off <= W_PIXELS_OFF)
              and (tr_equal or tr_close),
              f"{name}: kernel vs plain: image {img_err} max, {img_off} of "
              f"pixels off; trace {tr_err} max")
        main[name] = dict(scene=scene, gl=gl, pl=pl, o=o, d=d, h=h, w=w,
                          kw=kw, tkw=tkw, launches=launches, img_p=img_p,
                          res_k=res_k, err=tr_err, camera_ms=camera_ms)
    whitted_err = max(m["err"] for m in main.values())

    # whitted_golden: true_original 601x601@5 through the kernel against
    # the executed reference.
    t0 = time.perf_counter()
    scene, gl, pl, o, d, h, w, kw, _ = notebook_frame("true_original", 3,
                                                      dev)
    img = render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)
    img = img.cpu().numpy().astype(np.float64)
    ref = np.load(WHITTED_GOLDEN).astype(np.float64)
    dd = np.abs(img - ref)
    agree = dd.max(axis=-1) <= 1 / 255
    divergent = int((~agree).sum())
    mse_agree = float(np.mean(dd[agree] ** 2))
    emit({"phase": "whitted_golden", "frame": f"{w}x{h}/5",
          "divergent_pixels": divergent, "mse_agreeing": mse_agree,
          "exact_pixel_fraction": float((dd.max(-1) == 0).mean()),
          "bounds": {"divergent_pixels": "<= 32", "mse_agreeing": "< 1e-8"},
          "seconds": time.perf_counter() - t0})
    check(divergent <= 32 and mse_agree < 1e-8,
          f"whitted golden: {divergent} divergent pixels, mse {mse_agree}")

    # nearest_hit: kernel vs plain on planets2's primary rays and a ragged
    # 3601-ray set, ids suppressed on every third ray, both metrics and
    # both hit tests; then a planets2 frame with every level's sweep
    # through the kernel.
    t0 = time.perf_counter()
    m = main["planets2"]
    scene = m["scene"]
    table = cuda_intersect.sphere_table(scene, **m["tkw"])
    n_sph = len(table.spec)
    dn = torch.nn.functional.normalize(m["d"], dim=1).contiguous()
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    o_r = (torch.rand((3601, 3), device=dev, generator=gen) * 6 - 3)
    d_r = torch.nn.functional.normalize(
        torch.randn((3601, 3), device=dev, generator=gen), dim=1)
    nh_err, nh_equal = 0.0, True
    for o_s, d_s in ((m["o"], dn), (o_r.contiguous(), d_r.contiguous())):
        i = torch.arange(o_s.shape[0], device=dev)
        sup = torch.where(i % 3 == 0, table.ids[(i // 3) % n_sph],
                          NO_SUPPRESS).to(torch.int32)
        for by_abs in (False, True):
            for fast in (False, True):
                a = cuda_intersect.nearest_hit(o_s, d_s, sup, table,
                                               by_abs=by_abs, fast=fast)
                b = cuda_intersect.nearest_hit_plain(o_s, d_s, sup, table,
                                                     by_abs=by_abs, fast=fast)
                nh_equal &= all(bool(torch.equal(x, y)) for x, y in zip(a, b))
                both = a[2] & b[2]
                nh_err = max(nh_err, float(
                    (a[0] - b[0]).abs().where(both, 0.0).max()))
    img_s = render_whitted(scene, m["gl"], m["pl"], m["o"], m["d"], m["h"],
                           m["w"], impl="plain", sweep="kernel", **m["kw"])
    sweep_equal = bool(torch.equal(img_s, m["img_p"]))
    emit({"phase": "nearest_hit", "rays": [m["o"].shape[0], 3601],
          "bit_equal": nh_equal, "max_abs_err": nh_err,
          "sweep_kernel_frame_bit_equal": sweep_equal,
          "seconds": time.perf_counter() - t0})
    check(nh_equal, f"nearest_hit kernel vs plain differ ({nh_err})")
    check(sweep_equal, "planets2 frame with sweep='kernel' differs from "
          "the plain frame")

    # whitted_times: both kernels at the planets2 shape on the card's
    # clock, their bounds from this run's data, the frame's wall time.
    t0 = time.perf_counter()
    o, d, R = m["o"], m["d"], m["o"].shape[0]
    mb = m["kw"]["max_bounces"]
    for _ in range(3):
        cuda_whitted.whitted_trace(o, d, None, table, max_bounces=mb)
    w_ms = cuda_ms(lambda: cuda_whitted.whitted_trace(
        o, d, None, table, max_bounces=mb), 20)
    w_plain_ms = cuda_ms(lambda: cuda_whitted.whitted_trace_plain(
        o, d, None, table, max_bounces=mb), 2)
    work = {}
    cuda_whitted.whitted_trace_plain(o, d, None, table, max_bounces=mb,
                                     counters=work)
    w_ops = (W_OPS_PER_RAY * R
             + (W_OPS_SWEEP_PER_SPHERE * n_sph + W_OPS_LEVEL) * work["levels"]
             + W_OPS_MIRROR * work["mirror"]
             + W_OPS_GLASS_ENTRY * work["glass"]
             + W_OPS_WALK_STEP * work["walk_steps"]
             + W_OPS_WALK_REFLECT * (work["walk_steps"] - work["walk_exits"]))
    w_bytes = (W_BYTES_IN + W_BYTES_OUT) * R
    w_bound, w_by = bound(w_ops, w_bytes)
    # The nearest-hit kernel as the shadow sweep runs it: from the
    # termini toward the first point light, the shaded sphere suppressed.
    res = m["res_k"]
    light = m["pl"].position[0]
    to_light = torch.nn.functional.normalize(light - res.point, dim=1)
    self_id = table.ids[res.idx]
    nh_args = (res.point, to_light.contiguous(), self_id, table)
    for _ in range(3):
        cuda_intersect.nearest_hit(*nh_args)
    nh_ms = cuda_ms(lambda: cuda_intersect.nearest_hit(*nh_args), 50)
    nh_plain_ms = cuda_ms(lambda: cuda_intersect.nearest_hit_plain(*nh_args),
                          3)
    nh_bound, nh_by = bound(
        W_OPS_SWEEP_PER_SPHERE * n_sph * R,
        (W_BYTES_IN + W_BYTES_SUPPRESS + NH_BYTES_OUT) * R)
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(5):
        t1 = time.perf_counter()
        render_whitted(scene, m["gl"], m["pl"], o, d, m["h"], m["w"],
                       impl="kernel", **m["kw"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    emit({"phase": "whitted_times", **card,
          "frame": f"planets2 {m['w']}x{m['h']}/{mb}", "rays": R,
          "whitted_trace_ms": w_ms, "whitted_trace_plain_ms": w_plain_ms,
          "whitted_trace_bound_ms": w_bound, "whitted_trace_bound_by": w_by,
          "whitted_trace_bound_ops": w_ops,
          "whitted_trace_bound_bytes": w_bytes,
          "whitted_trace_bound_share": w_bound / w_ms, "work": work,
          "nearest_hit_ms": nh_ms, "nearest_hit_plain_ms": nh_plain_ms,
          "nearest_hit_bound_ms": nh_bound, "nearest_hit_bound_by": nh_by,
          "nearest_hit_bound_share": nh_bound / nh_ms,
          "launches_per_frame": m["launches"],
          "render_whitted_wall_ms": walls,
          "render_whitted_wall_ms_min": min(walls),
          "primary_rays_per_s_wall": R / (min(walls) / 1e3),
          "grid_rays_host_ms": m["camera_ms"],
          "max_memory_allocated_bytes": peak, "library_ms": None,
          "library_note": "no single PyTorch call computes either function",
          "seconds": time.perf_counter() - t0})

    return [
        {"name": "whitted_trace", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/whitted_trace.cu",
         "replaces": "raytracer_tpu/core/pallas_whitted.py:110",
         "launches": m["launches"]["whitted_trace"],
         "max_abs_err": whitted_err, "ms": w_ms, "plain_ms": w_plain_ms,
         "bound_ms": w_bound, "bound_by": w_by, "library_ms": None},
        {"name": "nearest_hit", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/nearest_hit.cu",
         "replaces": "raytracer_tpu/core/pallas_intersect.py:42",
         "launches": m["launches"]["nearest_hit"], "max_abs_err": nh_err,
         "ms": nh_ms, "plain_ms": nh_plain_ms, "bound_ms": nh_bound,
         "bound_by": nh_by, "library_ms": None}]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. Device -------------------------------------------------------------
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    card = {"device": kind, "nvidia_smi": smi_line}
    emit({"phase": "device", "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    # 2. Build ----------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc a source
        libs = dict(zip(SOURCES, pool.map(native.load, SOURCES)))
    lib = libs["path_trace"]
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": str(lib.path.relative_to(ROOT)),
          "nvcc_seconds": lib.build_seconds, "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "whitted_build", "libraries": {
        n: {"library": str(libs[n].path.relative_to(ROOT)),
            "nvcc_seconds": libs[n].build_seconds,
            "ptxas": [ln.strip() for ln in libs[n].build_log.splitlines()
                      if "registers" in ln or "spill" in ln]}
        for n in SOURCES[1:]}})

    # 3. Main path: render_path through the kernel, then the plain version
    #    on the same draws (same seed).
    t0 = time.perf_counter()
    scene, _, _, params = chandelier_scene(device=dev)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
              fov=params["fov"], camera_position=params["camera_position"],
              mirror_threshold=0.0, background=BG, device=dev)
    reset_counts()
    img_k, st_k = render_path(scene, impl="kernel",
                              generator=torch.Generator(dev).manual_seed(SEED),
                              **kw)
    torch.cuda.synchronize()
    launches = cuda_path.path_trace.launches
    check(launches >= 1, "the main path launched no path_trace kernel")
    img_p, st_p = render_path(scene, impl="plain",
                              generator=torch.Generator(dev).manual_seed(SEED),
                              **kw)
    torch.cuda.synchronize()
    check(tuple(img_k.shape) == (H, W, 3), f"image shape {img_k.shape}")
    check(bool(torch.isfinite(img_k).all()), "non-finite pixels")
    check(float(img_k.min()) >= 0.0 and float(img_k.max()) <= 1.0,
          "pixels outside [0, 1]")
    sk, sp = st_k.as_dict(), st_p.as_dict()
    check(sk["total_rays"] >= W * H * SPP and sk["light_hits"] > 0,
          f"implausible stats {sk}")
    equal = bool(torch.equal(img_k, img_p)) and sk == sp
    off = (img_k - img_p).abs().amax(-1) > 1 / 255 + 1e-7
    off_frac = float(off.float().mean())
    # Fallback bound, the TPU kernel's own (core/pallas_path.py:36-45):
    # <= 0.1% of pixels off by more than 1/255, hit counts within 0.02%.
    check(equal or (off_frac <= 1e-3 and stats_close(sk, sp, 2e-4)),
          f"kernel frame differs from plain: {off_frac} of pixels off, "
          f"stats {sk} vs {sp}")
    emit({"phase": "main_path", "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "launches": launches, "bit_equal": equal,
          "pixels_off_fraction": off_frac, "stats_kernel": sk,
          "stats_plain": sp, "seconds": time.perf_counter() - t0})

    # Kernel vs plain at the main path's shapes, wrapper to wrapper.
    jitter = torch.rand((SPP, H, W, 2), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    o, d = perspective_rays(W, H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.0, dev)
    tkw = dict(max_bounces=BOUNCES, background=BG)
    rgb_k, cnt_k = cuda_path.path_trace(o, d, None, table, **tkw)
    rgb_p, cnt_p = cuda_path.path_trace_plain(o, d, None, table, **tkw)
    torch.cuda.synchronize()
    max_abs_err = float((rgb_k - rgb_p).abs().max())
    samples_off = float((rgb_k != rgb_p).any(-1).float().mean())
    sums_k = dict(zip("rfes", cnt_k.sum(0, dtype=torch.int64).tolist()))
    sums_p = dict(zip("rfes", cnt_p.sum(0, dtype=torch.int64).tolist()))
    # Expected bit-equal; the fallback bound is the TPU kernel's (above).
    check((max_abs_err == 0 and sums_k == sums_p)
          or (samples_off <= 1e-3 and stats_close(sums_k, sums_p, 2e-4)),
          f"kernel vs plain: max |err| {max_abs_err}, {samples_off} of "
          f"samples differ, counts {sums_k} vs {sums_p}")
    emit({"phase": "kernel_vs_plain", "rays": o.shape[0],
          "max_abs_err": max_abs_err, "samples_off_fraction": samples_off,
          "counts_kernel": sums_k, "counts_plain": sums_p})

    # 4. Golden on the card: pixel centres, spp 1, 8 bounces.
    t0 = time.perf_counter()
    og, dg = perspective_rays(W, H, fov=params["fov"],
                              origin=params["camera_position"], device=dev)
    rgb_g, _ = trace_path(scene, og, dg, max_bounces=BOUNCES,
                          mirror_threshold=0.0, background=BG, impl="kernel")
    img = rgb_g.cpu().numpy().reshape(H, W, 3).astype(np.float64)
    ref = np.load(GOLDEN).astype(np.float64)
    dd = np.abs(np.minimum(1.0, img / 255.0) - np.minimum(1.0, ref / 255.0))
    agree = dd.max(axis=-1) <= 1 / 255
    divergent = int((~agree).sum())
    mse_agree = float(np.mean(dd[agree] ** 2))
    emit({"phase": "golden", "divergent_pixels": divergent,
          "mse_agreeing": mse_agree,
          "exact_pixel_fraction": float((dd.max(-1) == 0).mean()),
          "bounds": {"divergent_pixels": "< 1000", "mse_agreeing": "< 1e-8"},
          "seconds": time.perf_counter() - t0})
    check(divergent < 1000 and mse_agree < 1e-8,
          f"golden: {divergent} divergent pixels, mse {mse_agree}")

    # 5. Diffuse bounces (mirror_threshold=0.9) and a ragged ray count.
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    jd = torch.rand((2, 150, 200, 2), device=dev, generator=gen)
    od, ddir = perspective_rays(200, 150, fov=params["fov"],
                                origin=params["camera_position"],
                                sample_xy=jd)
    u = torch.rand((BOUNCES, od.shape[0], 2), device=dev, generator=gen)
    dkw = dict(max_bounces=BOUNCES, mirror_threshold=0.9, background=BG,
               uniforms=u)
    rk, sdk = trace_path(scene, od, ddir, impl="kernel", **dkw)
    rp, sdp = trace_path(scene, od, ddir, impl="plain", **dkw)
    eq_frac = float((rk == rp).float().mean())
    sdk, sdp = sdk.as_dict(), sdp.as_dict()
    hits = ("total_rays", "total_intersections", "light_hits")
    diffuse_ok = eq_frac >= 0.95 and stats_close(
        {k: sdk[k] for k in hits}, {k: sdp[k] for k in hits}, 0.02)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    orr = torch.zeros((3601, 3), device=dev) + torch.tensor(
        params["camera_position"], dtype=torch.float32, device=dev)
    drr = torch.randn((3601, 3), device=dev, generator=gen)
    r1, s1 = trace_path(scene, orr, drr, max_bounces=BOUNCES,
                        mirror_threshold=0.0, impl="kernel")
    r2, s2 = trace_path(scene, orr, drr, max_bounces=BOUNCES,
                        mirror_threshold=0.0, impl="plain")
    ragged_equal = bool(torch.equal(r1, r2)) and s1.as_dict() == s2.as_dict()
    emit({"phase": "diffuse_and_ragged", "diffuse_subpixels_equal": eq_frac,
          "diffuse_stats_kernel": sdk, "diffuse_stats_plain": sdp,
          "ragged_3601_bit_equal": ragged_equal,
          "seconds": time.perf_counter() - t0})
    check(diffuse_ok, f"diffuse kernel vs plain: {eq_frac} equal, "
          f"stats {sdk} vs {sdp}")
    check(ragged_equal, "ragged 3601-ray kernel vs plain differ")

    # 6. Times on the card's clock at the main path's shapes.
    t0 = time.perf_counter()
    for _ in range(3):
        cuda_path.path_trace(o, d, None, table, **tkw)
    kernel_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, None, table,
                                                     **tkw), 20)
    plain_ms = cuda_ms(lambda: cuda_path.path_trace_plain(o, d, None, table,
                                                          **tkw), 3)
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(5):
        t1 = time.perf_counter()
        render_path(scene, impl="kernel",
                    generator=torch.Generator(dev).manual_seed(SEED), **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    n_rays = o.shape[0]
    bms, bby, ops, nbytes = bound_ms(cnt_k, len(table.spec),
                                     len(table.emissive_idx), BOUNCES, n_rays)
    emit({"phase": "times", **card, "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "render_path_wall_ms": walls, "render_path_wall_ms_min": min(walls),
          "total_rays": sk["total_rays"], "camera_rays": n_rays,
          "rays_per_s_kernel": sk["total_rays"] / (kernel_ms / 1e3),
          "rays_per_s_wall": sk["total_rays"] / (min(walls) / 1e3),
          "bound_ms": bms, "bound_by": bby, "bound_ops": ops,
          "bound_bytes": nbytes, "bound_share": bms / kernel_ms,
          "max_memory_allocated_bytes": peak,
          "library_ms": None,
          "library_note": "no single PyTorch call computes this function",
          "seconds": time.perf_counter() - t0})

    whitted_kernels = whitted_phases(dev, card)

    emit({"kernels": [{
        "name": "path_trace", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/path_trace.cu",
        "replaces": "raytracer_tpu/core/pallas_path.py:213",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "library_ms": None}] + whitted_kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
