"""Variants of the tensor-core guided path kernel, timed against it.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
``python3 -m raytracer_tpu_torch.tools.guided_variants``.  It builds
``csrc/path_guided.cu`` as shipped and in variants made by replacing text
in copies of the sources (block shape and resident blocks, the hidden
epilogue as scalar f32 steps, a grid-stride tile schedule, the MLP left
out) under ``build/variants/``, all with ``core/native.py``'s flags and
in parallel.  Then, on the guided frame of ``chip_smoke.py``
(chandelier 800x600@8spp/8, mirror_threshold 0.9, the shipped bf16
student), it times each at fb_prob 1 and 0 on the card's clock (CUDA
events, 5 launches after one warm-up), checks each against the shipped
kernel's output, and times the unguided kernel on the fb_prob-0 work.
One JSON line per variant; the card's name and power limit first.
"""
import ctypes
import json
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core import cuda_path, native
from ..fb.registry import STUDENTS_DIR, guide_for
from ..render.camera import perspective_rays
from ..scene.library import chandelier_scene
from ..trace.path import emissive_indices, scene_spec

OUT = native.BUILD_DIR / "variants"
W, H, SPP, BOUNCES, SEED = 800, 600, 8, 8, 10


def _shape(threads, blocks):
    return [("path_guided.cu", "constexpr int kThreads = 448;",
             f"constexpr int kThreads = {threads};"),
            ("path_guided.cu", "constexpr int kMinBlocks = 2;",
             f"constexpr int kMinBlocks = {blocks};")]


SCALAR_EPILOGUE = [("student_mma.cuh", """\
  a[0] = hidden2(c0[0], c0[1], bias + 2 * t);
  a[1] = hidden2(c0[2], c0[3], bias + 2 * t);
  a[2] = hidden2(c1[0], c1[1], bias + 8 + 2 * t);
  a[3] = hidden2(c1[2], c1[3], bias + 8 + 2 * t);""", """\
  float b[4];
  for (int j = 0; j < 4; ++j)
    b[j] = __bfloat162float(bias[(j / 2) * 8 + 2 * t + j % 2]);
  const auto f = [](float x, float y) {
    return student::finish<true>(x, y, true);
  };
  a[0] = pack2(f(c0[0], b[0]), f(c0[1], b[1]));
  a[1] = pack2(f(c0[2], b[0]), f(c0[3], b[1]));
  a[2] = pack2(f(c1[0], b[2]), f(c1[1], b[3]));
  a[3] = pack2(f(c1[2], b[2]), f(c1[3], b[3]));""")]
STATIC_TILES = [("path_guided.cu",
                 "    if (lane == 0) next = atomicAdd(p.next_tile, 1ull);",
                 "    next = tile + first_free;"),
                ("path_guided.cu",
                 "    tile = first_free + static_cast<long long>(next);",
                 "    tile = static_cast<long long>(next);")]
NO_MLP = [("path_guided.cu",
           "        smma::forward(s_w, s_tile, p.dims, n, row, lane, a0, a1);",
           "        a0 = a1 = 0.0f;")]
VARIANTS = {
    "shipped_448x2": [],
    "blocks_128x4": _shape(128, 4),
    "blocks_256x3": _shape(256, 3),
    "blocks_512x2": _shape(512, 2),
    "blocks_1024x1": _shape(1024, 1),
    "scalar_epilogue": SCALAR_EPILOGUE,
    "static_tiles": STATIC_TILES,
    "no_mlp": NO_MLP,
}


def _build(name):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in list(native.SRC_DIR.glob("*.cuh")) + [
            native.SRC_DIR / "path_guided.cu"]:
        shutil.copy(f, d / f.name)
    for fname, old, new in VARIANTS[name]:
        text = (d / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        (d / fname).write_text(text.replace(old, new))
    proc = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / "path_guided.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.path_guided_launch
    fn.argtypes = [cuda_path._CTYPES[c] for c in
                   cuda_path._SIGNATURES["path_guided"]["path_guided_launch"]]
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("guided_variants: no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(_build, VARIANTS)))
    scene, _, _, params = chandelier_scene(device=dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    jitter = torch.rand((SPP, H, W, 2), device=dev, generator=gen)
    o, d = perspective_rays(W, H, fov=params["fov"],
                            origin=params["camera_position"],
                            sample_xy=jitter)
    o = o.contiguous()
    R = o.shape[0]
    u = torch.rand((BOUNCES, R, 2), device=dev, generator=gen)
    f = torch.rand((BOUNCES, R), device=dev, generator=gen)
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.9, dev)
    guide = guide_for("chandelier", W, H, STUDENTS_DIR)
    sargs = cuda_path.student_args(guide, "bf16_mma", dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rgb = torch.empty((R, 3), device=dev)
    cnt = torch.empty((R, 6), dtype=torch.int32, device=dev)
    shipped = {}
    for name, (fn, ptxas) in built.items():
        row = {"variant": name, "ptxas": ptxas}
        for fb in (1.0, 0.0):
            def call():
                nxt = torch.zeros(1, dtype=torch.int64, device=dev)
                err = fn(o.data_ptr(), d.data_ptr(), u.data_ptr(),
                         f.data_ptr(), fb, table.spheres.data_ptr(),
                         table.flags.data_ptr(), table.emissive.data_ptr(),
                         table.inside.data_ptr(), table.light_cut.data_ptr(),
                         len(table.spec), len(table.emissive_idx), R,
                         BOUNCES, 2.0, 2.0, 5.0, 0, *sargs, rgb.data_ptr(),
                         cnt.data_ptr(), nxt.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = _ms(call)
            shipped.setdefault(fb, (rgb.clone(), cnt.clone()))
            row[f"fb_prob_{fb:g}"] = {
                "ms": ms, "equals_shipped": bool(
                    torch.equal(rgb, shipped[fb][0])
                    and torch.equal(cnt, shipped[fb][1]))}
        print(json.dumps(row), flush=True)
    kw = dict(max_bounces=BOUNCES, background=(2.0, 2.0, 5.0))
    ms = _ms(lambda: cuda_path.path_trace(o, d, u, table, **kw))
    rgb_u, cnt_u = cuda_path.path_trace(o, d, u, table, **kw)
    print(json.dumps({"variant": "unguided_kernel_fb_prob_0_work", "ms": ms,
                      "equals_shipped_fb_prob_0": bool(
                          torch.equal(rgb_u, shipped[0.0][0])
                          and torch.equal(cnt_u, shipped[0.0][1][:, :4]))}),
          flush=True)


if __name__ == "__main__":
    main()
