#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It builds the
port's CUDA kernel with nvcc, drives the main path (the chandelier
path-traced frame, 800x600, 8 spp, 8 bounces, mirror_threshold=0.0)
through ``render_path``, holds the kernel against its plain PyTorch
version, checks the frame against the executed-reference golden, times
everything on the card's clock and prints JSON lines.  The last line is
``{"ok": true, "device": {...}}``; any failed phase exits non-zero before
it.  Without a CUDA device it exits 1 and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.core import cuda_path, native
from raytracer_tpu_torch.render.camera import perspective_rays
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.trace.path import (emissive_indices, scene_spec,
                                            trace_path)

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "showcase" / "parity_fullres" / "chandelier_800x600_ref.npy"
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
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, nbytes)


def stats_close(a, b, rel):
    return all(abs(a[k] - b[k]) <= rel * max(abs(b[k]), 1) for k in b)


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
    lib = native.load("path_trace")
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": str(lib.path.relative_to(ROOT)),
          "nvcc_seconds": lib.build_seconds, "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})

    # 3. Main path: render_path through the kernel, then the plain version
    #    on the same draws (same seed).
    t0 = time.perf_counter()
    scene, params = chandelier_scene(device=dev)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
              fov=params["fov"], camera_position=params["camera_position"],
              mirror_threshold=0.0, background=BG, device=dev)
    cuda_path.path_trace.launches = 0
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

    emit({"kernels": [{
        "name": "path_trace", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/path_trace.cu",
        "replaces": "raytracer_tpu/core/pallas_path.py:213",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "library_ms": None}]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
