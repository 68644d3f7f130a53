#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It builds the
port's CUDA kernels with nvcc (all sources at once), then drives its three
paths, each with the kernels' launch counts set to 0 just before and read
just after:

* the path tracer: the chandelier path-traced frame, 800x600, 8 spp, 8
  bounces, mirror_threshold=0.0, through ``render_path``;
* the Whitted tracer: planets2 at 2001x2001, 10 bounces, and marbles4 at
  801x801, 8 bounces, through ``render_whitted`` (the whole-trace Whitted
  kernel, and the nearest-hit kernel for the shadow sweeps);
* the guided path tracer: the chandelier frame at 800x600, 8 spp, 8
  bounces, mirror_threshold=0.9, fb_prob=1.0, guided by the shipped
  distilled student (22->128->128->2, bf16), through ``render_path`` with
  impl="kernel" (the student inside the path kernel: a bf16 student on the
  tensor cores in csrc/path_guided.cu, an f32 one as scalar multiply-adds
  in csrc/path_trace.cu) and impl="hybrid" (the per-level kernel, the
  student between levels);
* the full FB agent as a guide (bench.py's full-agent cell): the chandelier
  at 200x100, 8 spp, 8 bounces, mirror_threshold=0.9, fb_prob=1.0, an
  agent at FBConfig()'s width (z 64, encoder 512, backward 256) with
  seeded weights, through ``render_path`` with impl="stepwise" (the
  nearest-hit kernel a level, the guide between levels; every level
  guided, and guide_max_level=3) and impl="hybrid" (the level kernel a
  level); phases fb_agent and fb_agent_times, then one 800x600@8spp/8
  frame with guide_max_level=3 (fb_agent_800x600).

It holds every kernel against its plain PyTorch version, checks frames
against the executed-reference goldens, holds the path and level kernels
against their plain versions on seeded scenes built to cross the shared
level's exact rewrites (phase level_edges) and the nearest-hit kernel on
seeded ray sets built to cross the sweep's (phase nearest_hit), times
everything on the card's clock (the nearest-hit kernel on planets2's
shadow sweep and on the stepwise path level's sweep of the chandelier's
29 spheres, phase nearest_hit_times) and prints JSON lines.  The last
line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.  Without a CUDA
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

from raytracer_tpu_torch.core import (cuda_intersect, cuda_level, cuda_path,
                                      cuda_whitted, native, vec)
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.distill import DistilledGuide
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.fb.registry import (STUDENTS_DIR, guide_for,
                                             model_path_for)
from raytracer_tpu_torch.render.camera import grid_rays, perspective_rays
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.render.renderer import material_flags, render_whitted
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.tools import level_edges, sweep_edges
from raytracer_tpu_torch.trace.path import (emissive_indices, scene_spec,
                                            trace_path)
from raytracer_tpu_torch.trace.whitted import trace_whitted

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "showcase" / "parity_fullres" / "chandelier_800x600_ref.npy"
WHITTED_GOLDEN = (ROOT / "showcase" / "parity_fullres" /
                  "true_original_601_ref.npy")
SOURCES = ("path_trace", "path_guided", "whitted_trace", "nearest_hit",
           "path_level")
SEED = 0
W, H, SPP, BOUNCES = 800, 600, 8, 8
BG = (2.0, 2.0, 5.0)

# H100 SXM rates.  f32 operations outside the tensor cores, none fused:
# every kernel is built with -fmad=false (core/native.py), so an add or a
# multiply is one instruction on one lane, 132 SMs x 128 lanes x 1.98 GHz =
# 33.5 T operations/s; the data sheet's 67 TFLOP/s counts each fused
# multiply-add as two operations.  HBM3 bandwidth from the data sheet.
PEAK_F32_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# f32 operations of the path level (csrc/path_common.cuh), counted from its
# code, each IEEE square root or divide as one: what the function needs on
# the run's data (tools/level_edges.py::level_work counts it level by
# level), a valid sphere's thc and t and a light term's weight only where
# they can change an output.  The sweep: l, tca and its test a sphere test;
# d2 and its test a test in front of the ray; r^2, thc, t, |t| and the
# nearest test a valid test.  Direct light: t, d2, t.n and the cull test a
# light term of a continuing level; the square root, three divides, cos,
# the weight, trunc and sum a term not skipped.  A continuing level: the hit
# point, normal, offset and fold, and the mirror reflection where it is
# kept (a diffuse lane's bounce is not counted).  The first normalisation a
# ray.  The plain version computes every term: 26 a sphere test, 32 a light
# term and 82 a continuing level (OPS_PLAIN_*).
OPS_SPHERE = 9
OPS_SPHERE_FRONT = 9
OPS_SPHERE_VALID = 7
OPS_LIGHT = 14
OPS_LIGHT_COMPUTED = 24
OPS_CONTINUE = 40
OPS_REFLECT = 42
OPS_PER_RAY = 10
OPS_PLAIN_SPHERE, OPS_PLAIN_LIGHT, OPS_PLAIN_CONTINUE = 26, 32, 82
BYTES_PER_RAY = 24 + 12 + 16     # origin + direction in; rgb + counts out
# f32 operations of csrc/whitted_trace.cu and csrc/nearest_hit.cu, counted
# from their code (whitted_trace.cu helpers): the sweep (csrc/sphere.cuh::
# test) as the path level's, OPS_SPHERE, OPS_SPHERE_FRONT and
# OPS_SPHERE_VALID on the tests, the tests in front of the ray and the valid
# ones of the run's data (core/cuda_intersect.py::sweep_work), and every
# term of it, 26 a sphere test, as the plain version computes it
# (W_OPS_SWEEP_PER_SPHERE, reported beside); per level run, the hit point,
# normal and budget test; a mirror bounce (reflect3); a glass entry
# (refract3 in and a far-root exit); per walk step the outward refract3,
# and per internal reflection a reflect3 and a far-root exit; the first
# normalisation.
W_OPS_SWEEP_PER_SPHERE = 26
W_OPS_LEVEL = 20
W_OPS_MIRROR = 42
W_OPS_GLASS_ENTRY = 98
W_OPS_WALK_STEP = 61
W_OPS_WALK_REFLECT = 82
W_OPS_PER_RAY = 10
W_BYTES_IN, W_BYTES_SUPPRESS, W_BYTES_OUT = 24, 4, 1 + 4 + 4 + 12 + 12 + 4 + 4
NH_BYTES_OUT = 4 + 4 + 1          # t, idx, found
# nearest_hit: seeded ray sets on the edges of the sweep's rewrites
# (raytracer_tpu_torch/tools/sweep_edges.py), rays a set; the seed of the
# stepwise level's camera rays (case b).
NH_EDGE_SEEDS = (SEED + 30, SEED + 31)
NH_EDGE_RAYS = 200_000
NH_LEVEL_SEED = SEED + 14
# Fallback bounds of the Whitted kernel, the JAX package's own for its TPU
# kernel (tests/test_pallas_whitted.py:28-49): discrete fields exact, floats
# within rtol/atol 2e-4, at most 0.1% of pixels off by more than 1/255.
W_RTOL = W_ATOL = 2e-4
W_PIXELS_OFF = 1e-3
# Guided path tracer (bench.py's guided cell): the student's width, the fb
# gate, and the bounds the JAX package holds its guided TPU kernel to for a
# dense student (tests/test_pallas_path.py:149-181): at least 90% of samples
# equal, light hits within 0.9-1.12x.
G_THRESHOLD = 0.9
G_FB_PROB = 1.0
G_WIDTH = 128
G_MIN_EQUAL = 0.9
G_HITS = (0.9, 1.12)
# Published H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the
# least time for the student's flops.
PEAK_BF16 = 989e12
STUDENT_FLOPS = 2 * (22 * 128 + 128 * 128 + 128 * 2)   # a guided ray-level
# Bytes of the guided kernel beyond the unguided one: six counts out, not
# four; the fb uniform of every guided ray-level in (at fb_prob=1 every
# diffuse ray-level is guided and reads no cosine uniforms).
G_BYTES_PER_RAY = 24 + 12 + 24
G_BYTES_FB = 4
# Bytes of csrc/path_level.cu a ray-level: o, d and running in; state, rec,
# o_next, d_next and the hit plane out; the uniforms of a diffuse lane in.
LVL_BYTES_PER_RAY = 12 + 12 + 1 + 1 + 24 + 12 + 12
LVL_BYTES_HIT = 44
LVL_BYTES_U = 8
# The full FB agent (bench.py's full-agent cell, bench.py:108-170): frame,
# the stepwise deployment knob (raytracer_tpu/trace/path.py:200-207) and
# the larger frame run once.  The guide's products run as cuBLAS SGEMM in
# full f32, bounded by the data sheet's 67 TFLOP/s f32 rate (a fused
# multiply-add counted as two operations).
A_W, A_H = 200, 100
A_GML = 3
A_BIG_W, A_BIG_H = 800, 600
PEAK_F32_FLOPS = 67e12
# level_edges: seeded scenes on the edges of the level's exact rewrites
# (raytracer_tpu_torch/tools/level_edges.py), rays a scene.
EDGE_SEEDS = (SEED + 20, SEED + 21, SEED + 22)
EDGE_RAYS = 200_000


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
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def add_work(total, work):
    """Sums ``level_work`` dicts into ``total``, nested ones flattened."""
    for k, v in work.items():
        for kk, vv in (v.items() if isinstance(v, dict) else ((None, v),)):
            key = k if kk is None else f"{k}_{kk}"
            total[key] = total.get(key, 0) + vv
    return total


def level_ops(work):
    """``(f32 operations the level needs, those the plain version does)``
    over summed ``level_work`` counts."""
    ops = (OPS_SPHERE * work["sphere_tests"]
           + OPS_SPHERE_FRONT * work["front_sphere_tests"]
           + OPS_SPHERE_VALID * work["valid_sphere_tests"]
           + OPS_LIGHT * work["light_terms"]
           + OPS_LIGHT_COMPUTED * work["lights_computed"]
           + OPS_CONTINUE * work["continuing"]
           + OPS_REFLECT * work["reflections"])
    plain = (OPS_PLAIN_SPHERE * work["sphere_tests"]
             + OPS_PLAIN_LIGHT * work["light_terms"]
             + OPS_PLAIN_CONTINUE * work["continuing"])
    return ops, plain


def traced_work(o, d, u, table, **kw):
    """``(rgb, counts, summed level_work)`` of ``path_trace_plain`` on these
    inputs: the plain trace, each level's work counted on its data."""
    total = {}

    def counted(lo, ld, lrun, lu, ltable, **lkw):
        lv = cuda_path.level_plain(lo, ld, lrun, lu, ltable,
                                   fast=lkw["fast"], want_hit=True)
        add_work(total, level_edges.level_work(lo, ld, lrun, lu, ltable, lv))
        return lv

    # path_trace_plain is trace_levels over level_plain.
    rgb, counts = cuda_path.trace_levels(counted, o, d, u, table, **kw)
    return rgb, counts, total


def sweep_ops(work):
    """``(f32 operations the sweep needs, every term of it)`` over
    ``cuda_intersect.sweep_work`` counts."""
    ops = (OPS_SPHERE * work["sphere_tests"]
           + OPS_SPHERE_FRONT * work["front_sphere_tests"]
           + OPS_SPHERE_VALID * work["valid_sphere_tests"])
    return ops, W_OPS_SWEEP_PER_SPHERE * work["sphere_tests"]


def nearest_hit_modes(o, d, sup, table):
    """The nearest-hit kernel against its plain version on these rays in
    the four modes (signed t or |t|, exact or fast test): ``(bit_equal,
    max |t diff| where both found a hit)``."""
    equal, err = True, 0.0
    for by_abs in (False, True):
        for fast in (False, True):
            a = cuda_intersect.nearest_hit(o, d, sup, table, by_abs=by_abs,
                                           fast=fast)
            b = cuda_intersect.nearest_hit_plain(o, d, sup, table,
                                                 by_abs=by_abs, fast=fast)
            equal &= all(bool(torch.equal(x, y)) for x, y in zip(a, b))
            both = a[2] & b[2]
            err = max(err, float((a[0] - b[0]).abs().where(both, 0.0).max()))
    return equal, err


def stats_close(a, b, rel):
    return all(abs(a[k] - b[k]) <= rel * max(abs(b[k]), 1) for k in b)


def reset_counts():
    """Every kernel's launch count to 0."""
    cuda_path.path_trace.launches = 0
    for route in cuda_path.path_trace.route_launches:
        cuda_path.path_trace.route_launches[route] = 0
    cuda_whitted.whitted_trace.launches = 0
    cuda_intersect.nearest_hit.launches = 0
    cuda_level.path_level.launches = 0


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

    # nearest_hit: kernel vs plain in the four modes on planets2's primary
    # rays and a ragged 3601-ray set (ids suppressed on every third ray), on
    # seeded ray sets built to cross the sweep's rewrites (tools/
    # sweep_edges.py; every edge must be crossed) and on the stepwise
    # level's chandelier camera rays (case b); then a planets2 frame with
    # every level's sweep through the kernel.
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
    sets = {}
    for name, o_s, d_s in (("planets2_primary", m["o"], dn),
                           ("ragged_3601", o_r.contiguous(),
                            d_r.contiguous())):
        i = torch.arange(o_s.shape[0], device=dev)
        sup = torch.where(i % 3 == 0, table.ids[(i // 3) % n_sph],
                          NO_SUPPRESS).to(torch.int32)
        sets[name] = (o_s, d_s, sup, table)
    edges = {}
    for seed in NH_EDGE_SEEDS:
        e_table, e_o, e_d, e_sup = sweep_edges.edge_case(seed, NH_EDGE_RAYS,
                                                         dev)
        sets[f"edges_{seed}"] = (e_o, e_d, e_sup, e_table)
        edges[f"edges_{seed}"] = sweep_edges.edge_counts(e_o, e_d, e_sup,
                                                         e_table)
    l_table, l_o, l_d = sweep_edges.level_rays(dev, NH_LEVEL_SEED)
    sets["chandelier_level"] = (l_o, l_d, None, l_table)
    edges["chandelier_level"] = sweep_edges.edge_counts(l_o, l_d, None,
                                                        l_table)
    nh_err, nh_equal, per_set = 0.0, True, {}
    for name, (o_s, d_s, sup, tab) in sets.items():
        eq, err = nearest_hit_modes(o_s, d_s, sup, tab)
        per_set[name] = {"rays": o_s.shape[0], "bit_equal": eq,
                         "max_abs_err": err}
        nh_equal &= eq
        nh_err = max(nh_err, err)
    img_s = render_whitted(scene, m["gl"], m["pl"], m["o"], m["d"], m["h"],
                           m["w"], impl="plain", sweep="kernel", **m["kw"])
    sweep_equal = bool(torch.equal(img_s, m["img_p"]))
    crossed = all(v > 0 for k, v in edges.items() if k.startswith("edges_")
                  for v in v.values())
    emit({"phase": "nearest_hit", "sets": per_set,
          "bit_equal": nh_equal, "max_abs_err": nh_err,
          "edge_counts": edges, "every_edge_crossed": crossed,
          "sweep_kernel_frame_bit_equal": sweep_equal,
          "seconds": time.perf_counter() - t0})
    check(nh_equal, f"nearest_hit kernel vs plain differ ({per_set})")
    check(crossed, f"an edge ray set crosses no ray on some edge: {edges}")
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
    w_sweep, w_sweep_every = sweep_ops(work)
    w_rest = (W_OPS_PER_RAY * R + W_OPS_LEVEL * work["levels"]
              + W_OPS_MIRROR * work["mirror"]
              + W_OPS_GLASS_ENTRY * work["glass"]
              + W_OPS_WALK_STEP * work["walk_steps"]
              + W_OPS_WALK_REFLECT * (work["walk_steps"]
                                      - work["walk_exits"]))
    w_ops = w_sweep + w_rest
    w_bytes = (W_BYTES_IN + W_BYTES_OUT) * R
    w_bound, w_by = bound(w_ops, w_bytes)
    # The nearest-hit kernel as the shadow sweep runs it (case a): from the
    # termini toward the first point light, the shaded sphere suppressed.
    nh_args = (*sweep_edges.shadow_rays(m["res_k"], m["pl"], table), table)
    nh_cases = {"a_shadow_planets2": (nh_args, {}),
                "b_level_chandelier_exact": ((l_o, l_d, None, l_table),
                                             {"by_abs": True}),
                "b_level_chandelier_fast": ((l_o, l_d, None, l_table),
                                            {"by_abs": True, "fast": True})}
    nh_times = {}
    for name, (args, kw) in nh_cases.items():
        for _ in range(3):
            cuda_intersect.nearest_hit(*args, **kw)
        ms = cuda_ms(lambda: cuda_intersect.nearest_hit(*args, **kw), 50)
        plain_ms = cuda_ms(lambda: cuda_intersect.nearest_hit_plain(
            *args, **kw), 3)
        n = args[0].shape[0]
        nh_work = cuda_intersect.sweep_work(*args, fast=kw.get("fast", False))
        ops, ops_every = sweep_ops(nh_work)
        nbytes = (W_BYTES_IN + (0 if args[2] is None else W_BYTES_SUPPRESS)
                  + NH_BYTES_OUT) * n
        b_ms, b_by = bound(ops, nbytes)
        nh_times[name] = {
            "rays": n, "spheres": len(args[3].spec), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "bytes": nbytes, "ops": ops,
            "ops_every_term": ops_every,
            "bound_ms_every_term": bound(ops_every, nbytes)[0],
            "work": nh_work}
    nh = nh_times["a_shadow_planets2"]
    emit({"phase": "nearest_hit_times", **card, "cases": nh_times,
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    table_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        material_flags(scene)
        cuda_intersect.sphere_table(scene)
        torch.cuda.synchronize()
        table_ms.append((time.perf_counter() - t1) * 1e3)
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
          "whitted_trace_bound_ops_every_term": w_sweep_every + w_rest,
          "whitted_trace_bound_bytes": w_bytes,
          "whitted_trace_bound_share": w_bound / w_ms, "work": work,
          "nearest_hit_ms": nh["ms"], "nearest_hit_plain_ms": nh["plain_ms"],
          "nearest_hit_bound_ms": nh["bound_ms"],
          "nearest_hit_bound_by": nh["bound_by"],
          "nearest_hit_bound_share": nh["bound_share"],
          "launches_per_frame": m["launches"],
          "render_whitted_wall_ms": walls,
          "render_whitted_wall_ms_min": min(walls),
          "primary_rays_per_s_wall": R / (min(walls) / 1e3),
          "material_flags_and_sphere_table_host_ms": sorted(table_ms)[10],
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
         "ms": nh["ms"], "plain_ms": nh["plain_ms"],
         "bound_ms": nh["bound_ms"], "bound_by": nh["bound_by"],
         "library_ms": None}]


def student_params(kind, width=G_WIDTH, seed=SEED, hidden=2):
    """A 22->width(->width)->2 student with ``hidden`` layers:
    ``"one_hot"`` (px, py, pz and nx through the hidden layers to a0 = px,
    a1 = -nx; any summation order gives the same floats) or ``"random"``
    (seeded dense weights)."""
    dims = (22,) + (width,) * hidden + (2,)
    if kind == "random":
        rng = np.random.RandomState(seed)
        return {f"Dense_{i}": {
            "kernel": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
            "bias": (rng.randn(b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    k0 = np.zeros((22, width), np.float32)
    for j, c in enumerate((0, 1, 2, 6)):
        k0[c, j] = 1.0
    k2 = np.zeros((width, 2), np.float32)
    k2[0, 0], k2[3, 1] = 1.0, -1.0
    kernels = [k0] + [np.eye(width, dtype=np.float32)] * (hidden - 1) + [k2]
    return {f"Dense_{i}": {"kernel": k,
                           "bias": np.zeros(k.shape[1], np.float32)}
            for i, k in enumerate(kernels)}


def student(kind, width=G_WIDTH, hidden=2, dtype="auto"):
    """``student_params`` as a guide (bf16 for ``dtype="auto"``)."""
    return DistilledGuide(student_params(kind, width, hidden=hidden),
                          (width,) * hidden).as_guide_fn(dtype=dtype)


def route_counts():
    return dict(cuda_path.path_trace.route_launches)


def hits_close(a, b):
    """``a`` within the guided bounds of ``b`` (equal when ``b`` is 0)."""
    return a == b if b == 0 else G_HITS[0] <= a / b <= G_HITS[1]


def compare_guided(rgb_a, st_a, rgb_b, st_b, exact):
    """Samples ``[R, 3]`` and stats of two guided traces: bit for bit when
    ``exact``, else the guided bounds.  Returns ``(ok, report)``."""
    equal = bool(torch.equal(rgb_a, rgb_b)) and st_a == st_b
    frac = float((rgb_a == rgb_b).all(-1).double().mean())
    ok = bool(torch.isfinite(rgb_a).all()) and (equal or (
        not exact and frac >= G_MIN_EQUAL
        and hits_close(st_a["light_hits"], st_b["light_hits"])
        and hits_close(st_a["small_light_hits"], st_b["small_light_hits"])))
    return ok, {"bit_equal": equal, "samples_equal_fraction": frac,
                "max_abs_err": float((rgb_a - rgb_b).abs().max()),
                "stats": st_a, "stats_reference": st_b}


def guided_phases(dev, card, scene, params, libs):
    """The guided path's phases; returns its two ``kernels`` entries."""
    guide = guide_for("chandelier", W, H, STUDENTS_DIR)
    check(guide is not None, f"no shipped student in {STUDENTS_DIR}")
    emit({"phase": "guided_build", "libraries": {
        n: {"library": str(libs[n].path.relative_to(ROOT)),
            "nvcc_seconds": libs[n].build_seconds,
            "ptxas": [ln.strip() for ln in libs[n].build_log.splitlines()
                      if "registers" in ln or "spill" in ln]}
        for n in ("path_trace", "path_guided", "path_level")},
        "path_guided_launch_shipped_student":
            cuda_path.guided_occupancy(guide)})
    gen = torch.Generator(dev).manual_seed(SEED + 10)
    jitter = torch.rand((SPP, H, W, 2), device=dev, generator=gen)
    o, d = perspective_rays(W, H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    tkw = dict(max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
               background=BG, uniforms=u, fb_uniforms=f, fb_prob=G_FB_PROB)

    def trace(impl, guide):
        rgb, st = trace_path(scene, o, d, impl=impl, guide_fn=guide, **tkw)
        torch.cuda.synchronize()
        return rgb, st.as_dict()

    # guided_one_hot: kernel vs plain with a one-hot and a seeded random
    # 22->128->128->2 student, f32 and bf16.
    t0 = time.perf_counter()
    for kind in ("one_hot", "random"):
        for dtype in (None, "auto"):
            g = student(kind, dtype=dtype)
            rk, sk = trace("kernel", g)
            rp, sp = trace("plain", g)
            ok, rep = compare_guided(rk, sk, rp, sp, exact=kind == "one_hot")
            emit({"phase": "guided_one_hot", "student": kind,
                  "dtype": "bfloat16" if dtype else "float32",
                  "route": cuda_path.guided_route(g),
                  "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}", **rep,
                  "seconds": time.perf_counter() - t0})
            check(ok, f"guided kernel vs plain, {kind} student, {dtype}: "
                  f"{rep}")
            check(sk["fb_used"] > 0, f"{kind} student: no guided bounce")

    # guided_main: the shipped student through render_path, kernel then
    # plain then hybrid on the same draws.
    t0 = time.perf_counter()
    fkw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
               fov=params["fov"], camera_position=params["camera_position"],
               mirror_threshold=G_THRESHOLD, background=BG, device=dev,
               guide_fn=guide, fb_prob=G_FB_PROB)
    frames, launches = {}, {}
    for impl in ("kernel", "plain", "hybrid"):
        reset_counts()
        img, st = render_path(
            scene, impl=impl,
            generator=torch.Generator(dev).manual_seed(SEED + 11), **fkw)
        torch.cuda.synchronize()
        launches[impl] = {"path_trace": cuda_path.path_trace.launches,
                          "path_trace_routes": route_counts(),
                          "path_level": cuda_level.path_level.launches}
        frames[impl] = (img, st.as_dict())
    img_k, sk = frames["kernel"]
    check(launches["kernel"]["path_trace"] >= 1,
          "the guided path launched no path_trace kernel")
    check(launches["kernel"]["path_trace_routes"]["bf16_mma"]
          == launches["kernel"]["path_trace"],
          f"the shipped bf16 student's frame left the tensor-core route: "
          f"{launches['kernel']}")
    check(launches["hybrid"]["path_level"] >= BOUNCES,
          "the hybrid launched too few path_level kernels")
    check(tuple(img_k.shape) == (H, W, 3) and bool(torch.isfinite(img_k)
                                                   .all()),
          f"guided image {tuple(img_k.shape)} not finite")
    check(sk["fb_used"] > 0 and sk["fb_success"] > 0,
          f"guided stats {sk}: no guided bounce found a light")
    main_ok, main_rep = {}, {}
    for impl in ("plain", "hybrid"):
        img, st = frames[impl]
        pix = float((img_k == img).all(-1).float().mean())
        main_ok[impl] = (bool(torch.equal(img_k, img)) and sk == st) or (
            pix >= G_MIN_EQUAL and hits_close(sk["light_hits"],
                                              st["light_hits"])
            and hits_close(sk["small_light_hits"], st["small_light_hits"]))
        main_rep[impl] = {"bit_equal": bool(torch.equal(img_k, img))
                          and sk == st, "pixels_equal_fraction": pix,
                          "stats": st}
    # The same student, sample by sample, on the frame's draws.
    rk, sk_s = trace("kernel", guide)
    rp, sp_s = trace("plain", guide)
    ok_s, rep_s = compare_guided(rk, sk_s, rp, sp_s, exact=False)
    emit({"phase": "guided_main", "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "student": "fb_chandelier_distilled.npz (bf16)",
          "launches": launches, "stats_kernel": sk,
          "plain_vs_kernel": main_rep["plain"],
          "hybrid_vs_kernel": main_rep["hybrid"],
          "samples_kernel_vs_plain": {k: v for k, v in rep_s.items()
                                      if k != "stats_reference"},
          "seconds": time.perf_counter() - t0})
    for impl in ("plain", "hybrid"):
        check(main_ok[impl], f"guided frame, kernel vs {impl}: "
              f"{main_rep[impl]}")
    check(ok_s, f"guided samples, kernel vs plain: {rep_s}")

    # guided_edges: the tensor-core route's edge cases on the frame's
    # draws, kernel against plain and hybrid against kernel, one-hot
    # students bit for bit and dense ones within the guided bounds: a
    # ragged ray count (3,601 of the frame's rays, a seeded choice),
    # fb_prob 0.5 (warps with every number of guided lanes), one hidden
    # layer, width 24 (not a multiple of 16); then, at fb_prob 0, the
    # route against the unguided kernel on the same uniforms.
    t0 = time.perf_counter()
    pick = torch.randperm(R, device=dev, generator=torch.Generator(
        dev).manual_seed(SEED + 13))[:3601]
    ragged = (o[pick].contiguous(), d[pick].contiguous(),
              u[:, pick].contiguous(), f[:, pick].contiguous())
    full = (o, d, u, f)
    edges, edges_ok = [], True
    for name, kind, width, hidden, fb_prob, rays in (
            ("ragged_3601", "one_hot", G_WIDTH, 2, 1.0, ragged),
            ("fb_prob_0.5", "one_hot", G_WIDTH, 2, 0.5, full),
            ("one_hidden_layer", "one_hot", G_WIDTH, 1, 1.0, full),
            ("width_24", "one_hot", 24, 2, 1.0, full),
            ("ragged_3601", "random", G_WIDTH, 2, 0.5, ragged),
            ("one_hidden_layer", "random", G_WIDTH, 1, 1.0, full),
            ("width_24", "random", 24, 2, 0.5, full)):
        g = student(kind, width, hidden)
        eo, ed, eu, ef = rays
        ekw = dict(max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
                   background=BG, uniforms=eu, fb_uniforms=ef,
                   fb_prob=fb_prob, guide_fn=g)
        before = route_counts()["bf16_mma"]
        out = {}
        for impl in ("kernel", "plain", "hybrid"):
            rgb, st = trace_path(scene, eo, ed, impl=impl, **ekw)
            out[impl] = (rgb, st.as_dict())
        torch.cuda.synchronize()
        routed = route_counts()["bf16_mma"] - before
        exact = kind == "one_hot"
        ok_p, rep_p = compare_guided(*out["kernel"], *out["plain"], exact)
        ok_h, rep_h = compare_guided(*out["hybrid"], *out["kernel"], exact)
        keep = ("bit_equal", "samples_equal_fraction", "max_abs_err")
        edges.append({
            "case": name, "student": f"{kind} 22->"
            + "->".join([str(width)] * hidden) + "->2 bf16",
            "fb_prob": fb_prob, "rays": eo.shape[0],
            "fb_used": out["kernel"][1]["fb_used"],
            "bf16_mma_launches": routed,
            "kernel_vs_plain": {k: rep_p[k] for k in keep},
            "hybrid_vs_kernel": {k: rep_h[k] for k in keep}})
        edges_ok &= (ok_p and ok_h and routed == 1
                     and out["kernel"][1]["fb_used"] > 0)
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 G_THRESHOLD, dev)
    rgb0, cnt0 = cuda_path.path_trace(o, d, u, table, max_bounces=BOUNCES,
                                      background=BG, guide=guide,
                                      fb_uniforms=f, fb_prob=0.0)
    rgb_u, cnt_u = cuda_path.path_trace(o, d, u, table, max_bounces=BOUNCES,
                                        background=BG)
    torch.cuda.synchronize()
    fb0_equal = (bool(torch.equal(rgb0, rgb_u))
                 and bool(torch.equal(cnt0[:, :4], cnt_u))
                 and not bool(cnt0[:, 4:].any()))
    emit({"phase": "guided_edges", "cells": edges,
          "fb_prob_0_equals_unguided_kernel": fb0_equal,
          "seconds": time.perf_counter() - t0})
    check(edges_ok, f"tensor-core route edge cases: {edges}")
    check(fb0_equal, "the tensor-core route at fb_prob 0 differs from the "
          "unguided kernel on the same uniforms")

    # guided_hits: small-light hits, guided over traditional, both shipped
    # chandelier students, at bench.py's two guided shapes.
    t0 = time.perf_counter()
    hits = []
    for w, h in ((200, 100), (W, H)):
        hkw = dict(width=w, height=h, spp=SPP, max_bounces=BOUNCES,
                   fov=params["fov"], camera_position=params["camera_position"],
                   background=BG, device=dev)
        _, st_t = render_path(
            scene, mirror_threshold=0.0,
            generator=torch.Generator(dev).manual_seed(SEED + 12), **hkw)
        trad = int(st_t.small_light_hits)
        for name in ("fb_chandelier_distilled.npz",
                     "fb_chandelier_distilled_2to1.npz"):
            g = DistilledGuide.load(STUDENTS_DIR / name).as_guide_fn()
            _, st_g = render_path(
                scene, mirror_threshold=G_THRESHOLD, guide_fn=g,
                fb_prob=G_FB_PROB,
                generator=torch.Generator(dev).manual_seed(SEED + 12), **hkw)
            hits.append({"frame": f"{w}x{h}@{SPP}spp/{BOUNCES}",
                         "student": name,
                         "registry_pick": name == Path(model_path_for(
                             "chandelier", w, h, STUDENTS_DIR)).name,
                         "small_light_hits_guided":
                             int(st_g.small_light_hits),
                         "small_light_hits_traditional": trad,
                         "small_light_improvement":
                             int(st_g.small_light_hits) / max(trad, 1),
                         "fb_used": int(st_g.fb_used),
                         "fb_success": int(st_g.fb_success)})
            check(trad > 0 and int(st_g.small_light_hits) > 0,
                  f"guided_hits: no small-light hit ({hits[-1]})")
    emit({"phase": "guided_hits", "cells": hits,
          "seconds": time.perf_counter() - t0})

    # level_kernel: every level of a guided hybrid trace through the level
    # kernel and its plain version on the same inputs, bit for bit; then
    # the hybrid trace against the whole-trace kernel.
    t0 = time.perf_counter()
    kernel_level = cuda_level.path_level
    recorded, level_equal, level_err = [], [], [0.0]

    def checked_level(lo, ld, lrun, lu, ltable, **kw):
        a = kernel_level(lo, ld, lrun, lu, ltable, **kw)
        b = cuda_level.path_level_plain(lo, ld, lrun, lu, ltable, **kw)
        level_equal.append(all(
            (x is None and y is None) or bool(torch.equal(x, y))
            for x, y in zip(a, b)))
        level_err[0] = max([level_err[0]] + [
            float((x - y).abs().max()) for x, y in zip(a[1:], b[1:])
            if x is not None])
        recorded.append(((lo, ld, lrun, lu, ltable), kw, a.state))
        return a

    # While it stands in for the wrapper, the wrapper's launches land on
    # checked_level.launches: launches made to compare do not count.
    checked_level.launches = 0
    cuda_level.path_level = checked_level
    try:
        rh, sh = trace("hybrid", guide)
    finally:
        cuda_level.path_level = kernel_level
    rk, sk = trace("kernel", guide)
    ok_h, rep_h = compare_guided(rh, sh, rk, sk, exact=False)
    one_hot = DistilledGuide(student_params("one_hot"), (G_WIDTH, G_WIDTH)
                             ).as_guide_fn()
    rh1, sh1 = trace("hybrid", one_hot)
    rk1, sk1 = trace("kernel", one_hot)
    ok_h1, rep_h1 = compare_guided(rh1, sh1, rk1, sk1, exact=True)
    emit({"phase": "level_kernel", "levels": len(level_equal),
          "levels_bit_equal": level_equal,
          "hybrid_vs_kernel_shipped": rep_h,
          "hybrid_vs_kernel_one_hot": rep_h1,
          "seconds": time.perf_counter() - t0})
    check(len(level_equal) == BOUNCES and all(level_equal),
          f"path_level kernel vs plain differ: {level_equal}")
    check(ok_h and ok_h1, f"hybrid vs whole-trace kernel: {rep_h}, {rep_h1}")

    # guided_times: both kernels at the guided frame's shapes on the card's
    # clock, their bounds from this run's data, the frames' wall times.
    t0 = time.perf_counter()
    gkw = dict(max_bounces=BOUNCES, background=BG, guide=guide,
               fb_uniforms=f, fb_prob=G_FB_PROB)
    _, cnt = cuda_path.path_trace(o, d, u, table, **gkw)
    for _ in range(2):
        cuda_path.path_trace(o, d, u, table, **gkw)
    g_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **gkw), 5)
    g_plain_ms = cuda_ms(lambda: cuda_path.path_trace_plain(
        o, d, u, table, **gkw), 1)
    # The level's work on the guided frame's data: the hybrid's levels,
    # which are the plain version's (level_kernel holds the level kernel to
    # level_plain bit for bit), the kernel's up to the samples where the
    # tensor cores' student differs (guided_main).
    l_work = {}
    for (lo, ld, lrun, lu, ltable), kw, _ in recorded:
        add_work(l_work, level_edges.level_work(lo, ld, lrun, lu, ltable))
    l_ops, l_ops_plain = level_ops(l_work)
    f32_ops = l_ops + OPS_PER_RAY * R
    fb_used = int(cnt[:, 4].sum(dtype=torch.int64))
    mlp_flops = STUDENT_FLOPS * fb_used
    g_bytes = G_BYTES_PER_RAY * R + G_BYTES_FB * fb_used
    t_ops = f32_ops / PEAK_F32_OPS * 1e3 + mlp_flops / PEAK_BF16 * 1e3
    t_bytes = g_bytes / PEAK_BYTES * 1e3
    g_bound = max(t_ops, t_bytes)
    g_by = "operations" if t_ops >= t_bytes else "bytes"
    # The split: the same kernel at fb_prob 0, no lane guided (its paths
    # take cosine bounces instead, so its ray-levels differ; both counted).
    gkw0 = dict(gkw, fb_prob=0.0)
    _, cnt0 = cuda_path.path_trace(o, d, u, table, **gkw0)
    g0_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **gkw0), 5)
    # Its work: the unguided plain trace on the same uniforms (guided_edges
    # holds the two kernels equal at fb_prob 0).
    _, _, work0 = traced_work(o, d, u, table, max_bounces=BOUNCES,
                              background=BG)
    f32_ops0 = level_ops(work0)[0] + OPS_PER_RAY * R
    g0_bound, g0_by = bound(f32_ops0, BYTES_PER_RAY * R)
    levels = {name: int(torch.clamp_max(c[:, 0], BOUNCES).sum(
        dtype=torch.int64)) for name, c in (("fb_prob_1", cnt),
                                            ("fb_prob_0", cnt0))}
    # The unguided kernel (one thread a ray) on that same work: guided_edges
    # holds the two equal.
    ukw = dict(max_bounces=BOUNCES, background=BG)
    cuda_path.path_trace(o, d, u, table, **ukw)
    u0_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **ukw), 5)
    # The shipped student in f32 on the scalar route (csrc/path_trace.cu).
    gkw32 = dict(gkw, guide=DistilledGuide.load(
        STUDENTS_DIR / "fb_chandelier_distilled.npz").as_guide_fn(None))
    cuda_path.path_trace(o, d, u, table, **gkw32)
    g32_ms = cuda_ms(lambda: cuda_path.path_trace(o, d, u, table, **gkw32),
                     2)

    def level_frame():
        for args, kw, _ in recorded:
            kernel_level(*args, **kw)

    level_frame()
    l_ms = cuda_ms(level_frame, 5)
    l_plain_ms = cuda_ms(lambda: [cuda_level.path_level_plain(*a, **kw)
                                  for a, kw, _ in recorded], 1)
    l_bytes = 0
    for (lo, ld, lrun, lu, _), kw, st in recorded:
        diffuse = int((((st & cuda_level.ST_CONT) != 0)
                       & ((st & cuda_level.ST_MIRROR) == 0)).sum())
        l_bytes += ((LVL_BYTES_PER_RAY
                     + (LVL_BYTES_HIT if kw.get("want_hit") else 0))
                    * lo.shape[0] + LVL_BYTES_U * diffuse)
    l_bound, l_by = bound(l_ops, l_bytes)
    walls = {}
    for impl in ("kernel", "hybrid"):
        walls[impl] = []
        for _ in range(3):
            t1 = time.perf_counter()
            render_path(scene, impl=impl,
                        generator=torch.Generator(dev).manual_seed(SEED + 11),
                        **fkw)
            torch.cuda.synchronize()
            walls[impl].append((time.perf_counter() - t1) * 1e3)
    emit({"phase": "guided_times", **card,
          "frame": f"{W}x{H}@{SPP}spp/{BOUNCES} guided", "rays": R,
          "path_trace_guided_ms": g_ms,
          "path_trace_guided_plain_ms": g_plain_ms,
          "path_trace_guided_bound_ms": g_bound,
          "path_trace_guided_bound_by": g_by,
          "path_trace_guided_bound_f32_ops": f32_ops,
          "path_trace_guided_bound_mlp_flops": mlp_flops,
          "path_trace_guided_bound_bytes": g_bytes,
          "path_trace_guided_bound_share": g_bound / g_ms,
          "guided_ray_levels": fb_used,
          "path_trace_guided_fb_prob_0_ms": g0_ms,
          "path_trace_guided_fb_prob_0_bound_ms": g0_bound,
          "path_trace_guided_fb_prob_0_bound_by": g0_by,
          "path_trace_guided_fb_prob_0_bound_f32_ops": f32_ops0,
          "ray_levels_run": levels,
          "path_trace_unguided_fb_prob_0_work_ms": u0_ms,
          "path_trace_guided_f32_student_ms": g32_ms,
          "path_level_ms_per_frame": l_ms, "path_level_launches": len(recorded),
          "path_level_plain_ms_per_frame": l_plain_ms,
          "path_level_bound_ms": l_bound, "path_level_bound_by": l_by,
          "path_level_bound_ops": l_ops, "path_level_bound_bytes": l_bytes,
          "path_level_bound_share": l_bound / l_ms,
          "path_level_plain_ops": l_ops_plain, "level_work": l_work,
          "render_path_kernel_wall_ms": walls["kernel"],
          "render_path_hybrid_wall_ms": walls["hybrid"],
          "library_ms": None,
          "library_note": "no single PyTorch call computes either function",
          "seconds": time.perf_counter() - t0})

    return [
        {"name": "path_trace_guided", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/path_guided.cu",
         "replaces": "raytracer_tpu/core/pallas_path.py:142",
         "launches": launches["kernel"]["path_trace"],
         "max_abs_err": float((frames["kernel"][0]
                               - frames["plain"][0]).abs().max()),
         "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": None},
        {"name": "path_level", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/path_level.cu",
         "replaces": "raytracer_tpu/core/pallas_path.py:562",
         "launches": launches["hybrid"]["path_level"],
         "max_abs_err": level_err[0],
         "ms": l_ms, "plain_ms": l_plain_ms, "bound_ms": l_bound,
         "bound_by": l_by, "library_ms": None}]


def agent_guide_flops(cfg):
    """Flops of one guide row at ``cfg``'s widths, two a multiply-add: the
    encoder's products (obs->e, its three residual blocks, the attention's
    value and out projections, e->e, e->2z) and the backward model's trunk
    and mean head (2z->b, two residual blocks, b->2)."""
    e, b, z = cfg.e_hidden_dim, cfg.b_hidden_dim, cfg.z_dim
    enc = cfg.obs_dim * e + 3 * 2 * e * e + 2 * e * e + e * e + e * 2 * z
    bwd = 2 * z * b + 2 * 2 * b * b + b * cfg.action_dim
    return 2 * (enc + bwd)


class TimedGuide:
    """A guide with CUDA events around each call; ``ms()`` sums them."""

    def __init__(self, guide):
        self.guide, self.events = guide, []

    def __call__(self, obs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.guide(obs)
        b.record()
        self.events.append((a, b))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def device_ms(fn, kernel):
    """``(device ms, launches)`` of the CUDA kernels whose name holds
    ``kernel`` in one call of ``fn``, from ``torch.profiler``'s kernel
    events: at small shapes the wrapper's host time exceeds the kernel's,
    so events around a run of launches time the host."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    return sum(us) / 1e3, len(us)


def recorded_launches(module, name, frame):
    """Run ``frame()`` with ``module.<name>`` (a kernel wrapper) recording
    its calls: ``[(args, kwargs, output)]``.  While it stands in for the
    wrapper, the wrapper's launches land on the recorder's own count."""
    real, calls = getattr(module, name), []

    def recorder(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    recorder.launches = 0
    setattr(module, name, recorder)
    try:
        frame()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return calls


def fb_agent_phases(dev, card, scene, params):
    """The full FB agent's phases (bench.py's full-agent cell): the main
    path through render_path on three routes, each bit for bit against the
    others where their semantics meet, then their times and one larger
    frame."""
    # fb_agent: f32 stays f32 on the card (TF32 is another precision).
    t0 = time.perf_counter()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 is on: TF32 matmuls")
    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is "
          f"{torch.get_float32_matmul_precision()!r}, not 'highest'")
    cfg = FBConfig()
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           params["camera_position"], config=cfg, seed=SEED,
                           device=dev)
    guide = agent.as_guide_fn()
    fkw = dict(width=A_W, height=A_H, spp=SPP, max_bounces=BOUNCES,
               fov=params["fov"], camera_position=params["camera_position"],
               mirror_threshold=G_THRESHOLD, background=BG, device=dev,
               fb_prob=G_FB_PROB)
    routes = {"stepwise": dict(impl="stepwise"),
              f"stepwise_guide_max_level_{A_GML}": dict(
                  impl="stepwise", guide_max_level=A_GML),
              "hybrid": dict(impl="hybrid")}

    def frame(rkw, g=guide, **kw):
        out = render_path(scene, guide_fn=g, **rkw, **dict(fkw, **kw),
                          generator=torch.Generator(dev).manual_seed(
                              SEED + 40))
        torch.cuda.synchronize()
        return out

    frames, launches = {}, {}
    for name, rkw in routes.items():
        reset_counts()
        img, st = frame(rkw)
        launches[name] = {
            "nearest_hit": cuda_intersect.nearest_hit.launches,
            "path_level": cuda_level.path_level.launches,
            "path_trace": cuda_path.path_trace.launches}
        frames[name] = (img, st.as_dict())
        check(tuple(img.shape) == (A_H, A_W, 3)
              and bool(torch.isfinite(img).all()),
              f"fb_agent {name}: image {tuple(img.shape)} not finite")
        check(st.as_dict()["fb_used"] > 0, f"fb_agent {name}: no guided "
              f"bounce ({st.as_dict()})")
    gml = f"stepwise_guide_max_level_{A_GML}"
    for name in ("stepwise", gml):
        check(launches[name]["nearest_hit"] == BOUNCES
              and launches[name]["path_level"] == 0,
              f"fb_agent {name}: launches {launches[name]}, not one "
              f"nearest_hit a level")
    check(launches["hybrid"]["path_level"] == BOUNCES
          and launches["hybrid"]["nearest_hit"] == 0,
          f"fb_agent hybrid: launches {launches['hybrid']}")

    # The same agent on the frame's draws through trace_path: the stepwise
    # route with the kernel sweep and with nearest_hit_plain as its sweep,
    # the hybrid, and guide_max_level=3 against the hybrid whose fb plane is
    # 2.0 (never below fb_prob) from level 3 on.
    gen = torch.Generator(dev).manual_seed(SEED + 41)
    jitter = torch.rand((SPP, A_H, A_W, 2), device=dev, generator=gen)
    o, d = perspective_rays(A_W, A_H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    tkw = dict(max_bounces=BOUNCES, mirror_threshold=G_THRESHOLD,
               background=BG, uniforms=u, fb_uniforms=f, fb_prob=G_FB_PROB,
               guide_fn=guide)

    def trace(impl, **kw):
        rgb, st = trace_path(scene, o, d, impl=impl, **dict(tkw, **kw))
        torch.cuda.synchronize()
        return rgb, st.as_dict()

    out = {"stepwise": trace("stepwise")}
    kernel_hit = cuda_intersect.nearest_hit
    cuda_intersect.nearest_hit = cuda_intersect.nearest_hit_plain
    try:
        out["stepwise_plain_sweep"] = trace("stepwise")
    finally:
        cuda_intersect.nearest_hit = kernel_hit
    out["hybrid"] = trace("hybrid")
    out[gml] = trace("stepwise", guide_max_level=A_GML)
    f3 = f.clone()
    f3[A_GML:] = 2.0
    out[f"hybrid_fb_plane_past_level_{A_GML}"] = trace("hybrid",
                                                       fb_uniforms=f3)

    def same(a, b):
        return bool(torch.equal(out[a][0], out[b][0])) and out[a][1] == \
            out[b][1]

    agree = {
        "stepwise_kernel_vs_plain_sweep": same("stepwise",
                                               "stepwise_plain_sweep"),
        "stepwise_vs_hybrid": same("stepwise", "hybrid"),
        f"{gml}_vs_hybrid_fb_plane_past_level_{A_GML}": same(
            gml, f"hybrid_fb_plane_past_level_{A_GML}"),
        "render_path_stepwise_vs_hybrid": bool(torch.equal(
            frames["stepwise"][0], frames["hybrid"][0]))
        and frames["stepwise"][1] == frames["hybrid"][1]}
    fb_full, fb_gml = out["stepwise"][1]["fb_used"], out[gml][1]["fb_used"]
    emit({"phase": "fb_agent", "frame": f"{A_W}x{A_H}@{SPP}spp/{BOUNCES}",
          "agent": f"FBConfig() z {cfg.z_dim}, encoder {cfg.e_hidden_dim}, "
                   f"backward {cfg.b_hidden_dim}, seeded (seed {SEED})",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "launches": launches, "bit_equal": agree,
          "max_abs_err_stepwise_vs_hybrid": float(
              (out["stepwise"][0] - out["hybrid"][0]).abs().max()),
          "stats": {k: v[1] for k, v in out.items()},
          "render_path_stats": {k: v[1] for k, v in frames.items()},
          "seconds": time.perf_counter() - t0})
    check(all(agree.values()), f"fb_agent: routes differ: {agree}")
    check(0 < fb_gml < fb_full, f"fb_agent: guide_max_level={A_GML} "
          f"guided {fb_gml} bounces, every level {fb_full}")

    # fb_agent_times: each route's frame on the host clock, the guide in
    # CUDA events around its calls, the route's kernels a frame (their
    # launches recorded in one frame and replayed: device time from the
    # profiler, and the wrapper calls in CUDA events), peak memory.
    t0 = time.perf_counter()
    row_flops = agent_guide_flops(cfg)
    times = {}
    for name, rkw in routes.items():
        frame(rkw)
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            frame(rkw)
            walls.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        timed = TimedGuide(guide)
        frame(rkw, timed)
        guide_ms, guide_calls = timed.ms(), len(timed.events)
        hybrid = rkw["impl"] == "hybrid"
        mod, attr, plain = ((cuda_level, "path_level",
                             cuda_level.path_level_plain) if hybrid else
                            (cuda_intersect, "nearest_hit",
                             cuda_intersect.nearest_hit_plain))
        calls = recorded_launches(mod, attr, lambda: frame(rkw))
        real = getattr(mod, attr)

        def replay(fn=real):
            for args, kw, _ in calls:
                fn(*args, **kw)

        replay()
        k_ms = cuda_ms(replay, 5)
        k_dev_ms, k_dev_launches = device_ms(replay, attr + "_kernel")
        k_plain_ms = cuda_ms(lambda: replay(plain), 1)
        if hybrid:
            work, k_bytes = {}, 0
            for (lo, ld, lrun, lu, ltable), kw, lv in calls:
                add_work(work, level_edges.level_work(lo, ld, lrun, lu,
                                                      ltable))
                diffuse = int((((lv.state & cuda_level.ST_CONT) != 0)
                               & ((lv.state & cuda_level.ST_MIRROR) == 0))
                              .sum())
                k_bytes += ((LVL_BYTES_PER_RAY + (LVL_BYTES_HIT if
                                                  kw.get("want_hit") else 0))
                            * lo.shape[0] + LVL_BYTES_U * diffuse)
            k_ops = level_ops(work)[0]
        else:
            work, k_bytes = {}, 0
            for (lo, ld, sup, stable), kw, _ in calls:
                add_work(work, cuda_intersect.sweep_work(
                    lo, ld, sup, stable, fast=kw.get("fast", False)))
                k_bytes += (W_BYTES_IN + NH_BYTES_OUT) * lo.shape[0]
            k_ops = sweep_ops(work)[0]
        k_bound, k_by = bound(k_ops, k_bytes)
        g_levels = A_GML if "guide_max_level" in rkw else BOUNCES
        g_flops = g_levels * R * row_flops
        g_bound = g_flops / PEAK_F32_FLOPS * 1e3
        wall = sorted(walls)[1]
        times[name] = {
            "frame_wall_ms": walls, "frame_wall_ms_median": wall,
            "guide_ms": guide_ms, "guide_calls": guide_calls,
            "guide_share_of_wall": guide_ms / wall,
            "guide_flops": g_flops, "guide_bound_ms": g_bound,
            "guide_bound_share": g_bound / guide_ms,
            "kernel": attr, "kernel_launches": len(calls),
            "kernel_device_ms_per_frame": k_dev_ms,
            "kernel_device_ms_per_launch": k_dev_ms / max(k_dev_launches,
                                                          1),
            "kernel_profiled_launches": k_dev_launches,
            "kernel_wrapper_ms_per_frame": k_ms,
            "kernel_plain_ms_per_frame": k_plain_ms,
            "kernel_bound_ms_per_frame": k_bound,
            "kernel_bound_by": k_by, "kernel_bound_ops": k_ops,
            "kernel_bound_bytes": k_bytes,
            "kernel_bound_share": k_bound / max(k_dev_ms, 1e-9),
            "kernel_work": work,
            "max_memory_allocated_bytes": peak}
    emit({"phase": "fb_agent_times", **card,
          "frame": f"{A_W}x{A_H}@{SPP}spp/{BOUNCES}", "rays": R,
          "guide_flops_per_row": row_flops,
          "guide_bound_rate_flops": PEAK_F32_FLOPS, "routes": times,
          "library_ms": None,
          "library_note": "no single PyTorch call computes either kernel's "
                          "function",
          "seconds": time.perf_counter() - t0})

    # fb_agent_800x600: the stepwise route once at 800x600@8spp/8 with
    # guide_max_level=3: its time, its guide's and its peak memory, or the
    # out-of-memory error.
    t0 = time.perf_counter()
    big = {"frame": f"{A_BIG_W}x{A_BIG_H}@{SPP}spp/{BOUNCES}",
           "guide_max_level": A_GML}
    del out, frames, calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timed = TimedGuide(guide)
    try:
        t1 = time.perf_counter()
        img, st = frame(routes[gml], timed, width=A_BIG_W, height=A_BIG_H)
        big["wall_ms"] = (time.perf_counter() - t1) * 1e3
        big["guide_ms"] = timed.ms()
        big["guide_bound_ms"] = (A_GML * A_BIG_W * A_BIG_H * SPP * row_flops
                                 / PEAK_F32_FLOPS * 1e3)
        big["guide_bound_share"] = big["guide_bound_ms"] / big["guide_ms"]
        big["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        big["stats"] = st.as_dict()
        big["fits"] = True
        check(bool(torch.isfinite(img).all()) and st.as_dict()["fb_used"] > 0,
              f"fb_agent_800x600: {st.as_dict()}")
    except torch.cuda.OutOfMemoryError as e:
        big.update(fits=False, error=str(e)[:600],
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                       dev))
    img = st = timed = None
    torch.cuda.empty_cache()
    emit({"phase": "fb_agent_800x600", **card, **big,
          "seconds": time.perf_counter() - t0})


def level_edges_phase(dev):
    """Phase level_edges: on seeded scenes built to cross the shared level's
    rewrites (radii with T(r) != fl(r*r) and rays grazing them, lights whose
    cut passes through the hit points, grazing normals), the unguided path
    kernel against its plain version (bit for bit at mirror_threshold 0,
    exact and fast; at 0.9 the diffuse bound of diffuse_and_ragged), the
    level kernel against its plain version level by level on the same
    inputs, and the hybrid against the whole-trace kernel, bit for bit."""
    t0 = time.perf_counter()
    cells, ok = [], True
    for seed in EDGE_SEEDS:
        scene, o, d = level_edges.edge_scene(seed, EDGE_RAYS, dev)
        R = o.shape[0]
        spec, em = scene_spec(scene), emissive_indices(scene)
        gen = torch.Generator(dev).manual_seed(seed)
        u9 = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
        for thr, fast, u in ((0.0, False, None), (0.0, True, None),
                             (0.9, False, u9)):
            table = cuda_path.path_table(spec, em, thr, dev)
            kw = dict(max_bounces=BOUNCES, background=BG, fast=fast)
            rk, ck = cuda_path.path_trace(o, d, u, table, **kw)
            rp, cp = cuda_path.path_trace_plain(o, d, u, table, **kw)
            levels_equal = []

            def checked(lo, ld, lrun, lu, ltable, **lkw):
                a = cuda_level.path_level(lo, ld, lrun, lu, ltable, **lkw)
                b = cuda_level.path_level_plain(lo, ld, lrun, lu, ltable,
                                                **lkw)
                levels_equal.append(all(
                    (x is None and y is None) or bool(torch.equal(x, y))
                    for x, y in zip(a, b)))
                return a

            rh, ch = cuda_path.trace_levels(checked, o, d, u, table, **kw)
            torch.cuda.synchronize()
            equal = bool(torch.equal(rk, rp)) and bool(torch.equal(ck, cp))
            frac = float((rk == rp).all(-1).double().mean())
            sums_k = ck.sum(0, dtype=torch.int64).tolist()
            sums_p = cp.sum(0, dtype=torch.int64).tolist()
            hybrid_equal = (bool(torch.equal(rh, rk))
                            and bool(torch.equal(ch, ck)))
            # The first level's tests on the rewrites' edges.
            dn = torch.stack(vec.normalise_safe_c(*d.unbind(1)), -1)
            lv = cuda_level.path_level_plain(
                o, dn, torch.ones(R, dtype=torch.bool, device=dev),
                None if u is None else u[0], table, fast=fast,
                want_hit=True)
            edges = level_edges.edge_counts(
                o, dn, table, lv.hit, (lv.state & cuda_level.ST_CONT) != 0)
            cell_ok = (all(levels_equal) and len(levels_equal) == BOUNCES
                       and hybrid_equal and all(v > 0 for v in
                                                edges.values())
                       and (equal if thr == 0.0 else (
                           frac >= 0.95 and stats_close(
                               dict(enumerate(sums_k)),
                               dict(enumerate(sums_p)), 0.02))))
            ok &= cell_ok
            cells.append({"seed": seed, "mirror_threshold": thr,
                          "precision": "fast" if fast else "exact",
                          "rays": R, "kernel_vs_plain_bit_equal": equal,
                          "samples_equal_fraction": frac,
                          "counts_kernel": sums_k, "counts_plain": sums_p,
                          "levels_bit_equal": levels_equal,
                          "hybrid_vs_kernel_bit_equal": hybrid_equal,
                          "first_level_edges": edges, "ok": cell_ok})
    emit({"phase": "level_edges", "cells": cells,
          "seconds": time.perf_counter() - t0})
    check(ok, "level_edges: a kernel differs from its plain version, the "
          "hybrid from the kernel, or a scene crosses no edge: "
          f"{[c for c in cells if not c['ok']]}")


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
        for n in ("whitted_trace", "nearest_hit")}})

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
    # The plain trace, its work counted level by level for the bound.
    rgb_p, cnt_p, work = traced_work(o, d, None, table, **tkw)
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

    # The square roots and divides of the frame's levels, counted on its
    # data (tools/level_edges.py::level_work): as the plain version and
    # the parent kernel take them, and as the kernel takes them now.
    per_level = {k: v / work["ray_levels"] for k, v in work.items()
                 if k.startswith(("before", "after"))}

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

    level_edges_phase(dev)

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
    ops, ops_plain = level_ops(work)
    ops += OPS_PER_RAY * n_rays
    nbytes = BYTES_PER_RAY * n_rays
    bms, bby = bound(ops, nbytes)
    emit({"phase": "times", **card, "frame": f"{W}x{H}@{SPP}spp/{BOUNCES}",
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "render_path_wall_ms": walls, "render_path_wall_ms_min": min(walls),
          "total_rays": sk["total_rays"], "camera_rays": n_rays,
          "rays_per_s_kernel": sk["total_rays"] / (kernel_ms / 1e3),
          "rays_per_s_wall": sk["total_rays"] / (min(walls) / 1e3),
          "bound_ms": bms, "bound_by": bby, "bound_ops": ops,
          "bound_bytes": nbytes, "bound_share": bms / kernel_ms,
          "plain_ops": ops_plain + OPS_PER_RAY * n_rays,
          "level_work": work, "sqrt_div_per_ray_level": per_level,
          "max_memory_allocated_bytes": peak,
          "library_ms": None,
          "library_note": "no single PyTorch call computes this function",
          "seconds": time.perf_counter() - t0})

    whitted_kernels = whitted_phases(dev, card)
    guided_kernels = guided_phases(dev, card, scene, params, libs)
    fb_agent_phases(dev, card, scene, params)

    emit({"kernels": [{
        "name": "path_trace", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/path_trace.cu",
        "replaces": "raytracer_tpu/core/pallas_path.py:213",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "library_ms": None}] + whitted_kernels + guided_kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
