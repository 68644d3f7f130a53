"""Command-line interface of the PyTorch/CUDA port: the commands whose
slices have landed, with the JAX CLI's (``raytracer_tpu/cli.py``)
arguments and defaults, plus ``--device`` (``cuda`` by default; ``cpu``
runs the plain PyTorch versions).

    raytracer-tpu-torch render --scene true_original
    raytracer-tpu-torch train-fb [--quick] [--scenes N]
    raytracer-tpu-torch train-fb-chandelier [--quick] [--scenes N]
    raytracer-tpu-torch train-fb-complex [--quick] [--scenes N]
    raytracer-tpu-torch compare-chandelier [--model PATH]
    raytracer-tpu-torch compare-complex [--model PATH]
    raytracer-tpu-torch experiment [--mode balanced_mode]

(also ``python -m raytracer_tpu_torch.cli ...``).  ``compare-*
--spp-chunk N`` renders both sides in chunks of N samples through
impl ``"kernel"``.  The JAX CLI's ``animate``, ``train-ppo``,
``train-sac``, ``train-q``, ``demo``, ``interactive`` and ``rl-pipeline``
are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json
import time

SCENES = ("true_original", "planets2", "marbles4", "chandelier", "custom")


def cmd_render(args):
    """A library scene through the Whitted renderer, saved as a PNG."""
    import numpy as np
    import torch

    from .core.device import resolve_device
    from .render.camera import grid_rays, perspective_rays
    from .render.renderer import render_whitted
    from .scene import library
    from .utils.io import save_image

    dev = resolve_device(args.device)
    scene, gl, pl, p = getattr(library, f"{args.scene}_scene")(device=dev)
    if "ray_count" in p:
        origins, dirs, h, w = grid_rays(
            p["ray_count"], p["ray_step"],
            args.multiple or p.get("multiple", 1),
            origin=p["camera_position"], device=dev)
    else:
        w, h = args.width, args.height
        origins, dirs = perspective_rays(w, h, fov=p.get("fov", 60),
                                         origin=p["camera_position"],
                                         device=dev)
        origins = origins.contiguous()
    t0 = time.perf_counter()
    img = render_whitted(scene, gl, pl, origins, dirs, h, w,
                         max_bounces=p["max_bounces"],
                         background=p["background"],
                         miss_colour=p.get("sky_colour"), mode="unit")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    arr = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    save_image(args.out, arr)
    print(f"rendered {w}x{h} in {dt:.2f}s -> {args.out} "
          f"({h * w / dt / 1e6:.2f} Mrays/s, {dev})")


def _fb_args(args):
    if args.quick:
        return 10, 50
    return args.scenes, 150


def cmd_train_fb(args, trainer_cls=None):
    from .fb.trainer import (ChandelierOnlyTrainer, MultiSceneFBTrainer,
                             RayTracedComplexTrainer)
    cls = {None: MultiSceneFBTrainer,
           "chandelier": ChandelierOnlyTrainer,
           "complex": RayTracedComplexTrainer}[trainer_cls]
    scenes, steps = _fb_args(args)
    tr = cls(num_training_scenes=scenes, device=args.device)
    if args.probe_every:
        tr.probe_every = args.probe_every
    report = tr.run_training(num_scenes=scenes, scenes_per_batch=20,
                             training_steps_per_scene=steps)
    hist = report["training_summary"].get("render_probe_history")
    if hist:
        print(f"render probe: best improvement "
              f"{max(h['improvement'] for h in hist):.2f}x "
              f"(best_render_probe.npz)")
    if trainer_cls == "chandelier":
        tr.test_on_chandelier(num_tests=200)
    else:
        tr.test_on_complex(num_tests=200)
    print(f"avg hit rate: "
          f"{report['performance_statistics']['avg_hit_rate']:.3f}")
    print(f"outputs -> {tr.output_dir}")


def cmd_compare(args, which):
    from .compare.harness import chandelier_comparison, complex_comparison
    fn = chandelier_comparison if which == "chandelier" else complex_comparison
    kw = {}
    if args.spp_chunk:
        kw = dict(spp_chunk=args.spp_chunk, impl="kernel")
    stats = fn(model_path=args.model, width=args.width, height=args.height,
               samples_per_pixel=args.spp, max_bounces=args.bounces,
               fb_samples_per_pixel=args.fb_spp, out_dir=args.out,
               timing_iters=args.timing_iters, device=args.device, **kw)
    print(json.dumps(stats["comparison"], indent=2))


def cmd_experiment(args):
    from .compare.experiment import CustomSceneExperiment
    exp = CustomSceneExperiment(mode=args.mode, device=args.device)
    out = exp.run_custom_scene_experiment()
    print(f"results -> {out}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn):
        c = sub.add_parser(name)
        c.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the "
                            "plain PyTorch versions)")
        c.set_defaults(fn=fn)
        return c

    r = command("render", cmd_render)
    r.add_argument("--scene", default="true_original", choices=SCENES)
    r.add_argument("--out", default="render_output.png")
    r.add_argument("--width", type=int, default=800)
    r.add_argument("--height", type=int, default=600)
    r.add_argument("--multiple", type=int, default=None)

    for name, which in [("train-fb", None),
                        ("train-fb-chandelier", "chandelier"),
                        ("train-fb-complex", "complex")]:
        t = command(name, lambda a, w=which: cmd_train_fb(a, w))
        t.add_argument("--quick", action="store_true")
        t.add_argument("--scenes", type=int, default=100)
        t.add_argument("--probe-every", type=int, default=None,
                       help="run the render-level probe every N scenes and "
                            "snapshot best_render_probe.npz")

    for name in ("compare-chandelier", "compare-complex"):
        c = command(name, lambda a, w=name.split("-")[1]: cmd_compare(a, w))
        c.add_argument("--model", default=None)
        c.add_argument("--width", type=int, default=200)
        c.add_argument("--height", type=int, default=100)
        c.add_argument("--spp", type=int, default=8)
        c.add_argument("--bounces", type=int, default=8)
        c.add_argument("--fb-spp", type=int, default=None,
                       help="matched-signal mode: FB samples per pixel")
        c.add_argument("--spp-chunk", type=int, default=None,
                       help="bounded-memory high-spp accumulation chunk "
                            "(switches both sides to impl 'kernel')")
        c.add_argument("--out", default=None, help="output directory")
        c.add_argument("--timing-iters", type=int, default=1,
                       help="best-of-N wall-clock")

    e = command("experiment", cmd_experiment)
    e.add_argument("--mode", default="balanced_mode",
                   choices=["fast_mode", "balanced_mode", "quality_mode"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
