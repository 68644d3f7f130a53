"""Variants of the nearest-hit kernel, timed against it.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 -m raytracer_tpu_torch.tools.sweep_variants [--parent DIR]``.
It builds ``csrc/nearest_hit.cu`` as shipped and in variants made by
replacing text in copies of the sources (block shape and rays a thread,
a branch a ray instead of one for the thread's rays, the sphere loop
unrolled, the table staged
before the rays are read, scalar ray loads and stores, the sweep with the
plain version's two square roots a sphere, d2 and t for every sphere) under
``build/variants/sweep/``, all with ``core/native.py``'s flags and in
parallel; with ``--parent``, also the ``nearest_hit.cu`` of another
checkout (its own headers), which takes the same C interface.  Then it
times each, on the card's clock (CUDA events, 50 launches after a
warm-up), in the sweep's two shapes: (a) planets2 2001x2001@10's shadow
sweep toward the first point light (signed t, exact, the shaded sphere
suppressed) and (b) the stepwise path level's sweep on the chandelier's
800x600@8spp camera rays (|t|, nothing suppressed), exact and fast.  Each
result is held against ``nearest_hit_plain`` bit for bit.  One JSON line a
variant, the card's name and power limit first; the shipped kernel is
timed again last, so that drift shows.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..core import cuda_intersect, native
from ..render.camera import grid_rays
from ..render.renderer import material_flags
from ..scene import library
from ..trace.whitted import trace_whitted
from . import sweep_edges

OUT = native.BUILD_DIR / "variants" / "sweep"
SEED = 4


def _text(old, new, fname="nearest_hit.cu"):
    return (fname, old, new)


def _shape(threads, rays):
    return [_text("constexpr int kThreads = 128;",
                  f"constexpr int kThreads = {threads};"),
            _text("constexpr int kRays = 4;                  // rays a thread",
                  f"constexpr int kRays = {rays};")]


STAGE = "  sphere::stage(tb, spheres, ids, n_spheres, fast != 0);\n"
STAGE_FIRST = [_text(STAGE, ""),
               _text("  // This thread's rays, first:", STAGE
                     + "  // This thread's rays, first:")]
# Each ray's test branches on its own tca (sphere.cuh::test), not once for
# the thread's rays.
PER_RAY_BRANCH = [_text("""    sphere::Front f[kRays];
    bool ahead = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      f[k] = sphere::front(c, o[3 * k], o[3 * k + 1], o[3 * k + 2],
                           d[3 * k], d[3 * k + 1], d[3 * k + 2]);
      ahead |= f[k].tca >= 0.0f;
    }
    if (!ahead) continue;              // the common case: one branch
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      if (f[k].tca >= 0.0f)
        sphere::finish(h[k], tb, s, c, f[k], sup[k], by_abs != 0);
""", """#pragma unroll
    for (int k = 0; k < kRays; ++k)
      sphere::test(h[k], tb, s, c, o[3 * k], o[3 * k + 1], o[3 * k + 2],
                   d[3 * k], d[3 * k + 1], d[3 * k + 2], sup[k],
                   by_abs != 0);
""")]
LOOP = "  for (int s = 0; s < n_spheres; ++s) {\n"


def _unroll(k):
    return [_text(LOOP, f"#pragma unroll {k}\n" + LOOP)]


SCALAR_IO = [_text("  const bool whole = aligned != 0 && here == kRays;",
                   "  const bool whole = false;")]
# The plain version's sweep (and the parent kernel's): d2, thc and t for
# every sphere, the exact test as sqrt(d2) <= r (r staged in attr.y, which
# this kernel does not read otherwise), a branch a ray.
TWO_SQRT = [
    _text("    tb.attr[s] = make_float4(rr, row[4], row[5], row[6]);",
          "    tb.attr[s] = make_float4(rr, r, row[5], row[6]);",
          "sphere.cuh"),
    _text("""  const float d2 = max_nan(f.lx * f.lx + f.ly * f.ly + f.lz * f.lz -
                               f.tca * f.tca,
                           0.0f);
  if (!(d2 <= c.w) || tb.id[s] == sup) return;
  const float t = f.tca - sqrtf(max_nan(tb.attr[s].x - d2, 0.0f));
""", """  const float d2 = max_nan(f.lx * f.lx + f.ly * f.ly + f.lz * f.lz -
                               f.tca * f.tca,
                           0.0f);
  const float4 at = tb.attr[s];
  const float t = f.tca - sqrtf(max_nan(at.x - d2, 0.0f));
  const bool inside = c.w == at.x ? d2 <= at.x : sqrtf(d2) <= at.y;
  if (!((f.tca >= 0.0f) && inside && tb.id[s] != sup)) return;
""", "sphere.cuh"),
    _text("  if (f.tca >= 0.0f) finish(h, tb, s, c, f, sup, by_abs);",
          "  finish(h, tb, s, c, f, sup, by_abs);", "sphere.cuh"),
] + PER_RAY_BRANCH
VARIANTS = {
    "shipped_128x4": [],
    "threads_64x4": _shape(64, 4),
    "threads_256x4": _shape(256, 4),
    "threads_512x4": _shape(512, 4),
    "rays_128x8": _shape(128, 8),
    "rays_128x2": _shape(128, 2),
    "rays_128x1": _shape(128, 1),
    "per_ray_branch": PER_RAY_BRANCH,
    "spheres_unrolled_2": _unroll(2),
    "spheres_unrolled_4": _unroll(4),
    "stage_first": STAGE_FIRST,
    "scalar_io": SCALAR_IO,
    "two_sqrt": TWO_SQRT,
}


def _build(name, src_dir, edits):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in list(src_dir.glob("*.cuh")) + [src_dir / "nearest_hit.cu"]:
        shutil.copy(f, d / f.name)
    for fname, old, new in edits:
        text = (d / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        (d / fname).write_text(text.replace(old, new))
    proc = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "nearest_hit.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    fn = ctypes.CDLL(str(d / "lib.so")).nearest_hit_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]


def _ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cases(dev):
    """``{name: (origins, dirs, suppress_id, table, by_abs, fast)}``: the
    shadow sweep (a) and the level's sweep (b), exact and fast."""
    scene, _, pl, p = library.planets2_scene(device=dev)
    o, d, _, _ = grid_rays(p["ray_count"], p["ray_step"], 10,
                           origin=p["camera_position"], device=dev)
    eg, em = material_flags(scene)
    table = cuda_intersect.sphere_table(scene, eg, em)
    res = trace_whitted(scene, o, d, p["max_bounces"], impl="kernel",
                        enable_glass=eg, enable_mirror=em)
    so, sd, sup = sweep_edges.shadow_rays(res, pl, table)
    ltable, lo, ld = sweep_edges.level_rays(dev, SEED)
    return {"a_shadow_planets2": (so, sd, sup, table, False, False),
            "b_level_chandelier_exact": (lo, ld, None, ltable, True, False),
            "b_level_chandelier_fast": (lo, ld, None, ltable, True, True)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose nearest_hit.cu is "
                         "timed beside these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_variants: no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    jobs = {name: (native.SRC_DIR, edits) for name, edits in VARIANTS.items()}
    if args.parent is not None:
        jobs["parent"] = (args.parent.resolve() / "raytracer_tpu_torch"
                          / "csrc", [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda n: _build(n, *jobs[n]),
                                        jobs)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    inputs = cases(dev)
    plain = {c: cuda_intersect.nearest_hit_plain(o, d, s, t, by_abs=a,
                                                 fast=f)
             for c, (o, d, s, t, a, f) in inputs.items()}
    order = list(built) + ["shipped_128x4"]
    for name in order:
        fn, ptxas = built[name]
        row = {"variant": name, "ptxas": ptxas}
        for case, (o, d, sup, table, by_abs, fast) in inputs.items():
            R = o.shape[0]
            t = torch.empty(R, device=dev)
            idx = torch.empty(R, dtype=torch.int32, device=dev)
            found = torch.empty(R, dtype=torch.bool, device=dev)

            def call():
                err = fn(o.data_ptr(), d.data_ptr(),
                         None if sup is None else sup.data_ptr(),
                         table.spheres.data_ptr(), table.ids.data_ptr(),
                         len(table.spec), R, int(by_abs), int(fast),
                         t.data_ptr(), idx.data_ptr(), found.data_ptr(),
                         stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            row[case] = {"ms": _ms(call), "equals_plain": all(
                bool(torch.equal(x, y))
                for x, y in zip((t, idx, found), plain[case]))}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
