"""Command-line interface of the PyTorch/CUDA port: the commands whose
slices have landed, with the JAX CLI's (``raytracer_tpu/cli.py``)
arguments and defaults, plus ``--device`` (``cuda`` by default; ``cpu``
runs the plain PyTorch versions).

    raytracer-tpu-torch render --scene true_original
    raytracer-tpu-torch animate --scene planets2 --frames 24
    raytracer-tpu-torch animate --scene chandelier --tracer path --guide registry
    raytracer-tpu-torch train-ppo --timesteps 50000
    raytracer-tpu-torch train-sac --timesteps 50000
    raytracer-tpu-torch train-q --episodes 1000
    raytracer-tpu-torch demo
    raytracer-tpu-torch interactive  (the reference's menus)
    raytracer-tpu-torch rl-pipeline --algo ppo|sac  (train, evaluate, bench)
    raytracer-tpu-torch train-fb [--quick] [--scenes N]
    raytracer-tpu-torch train-fb-chandelier [--quick] [--scenes N]
    raytracer-tpu-torch train-fb-complex [--quick] [--scenes N]
    raytracer-tpu-torch compare-chandelier [--model PATH]
    raytracer-tpu-torch compare-complex [--model PATH]
    raytracer-tpu-torch experiment [--mode balanced_mode]

(also ``python -m raytracer_tpu_torch.cli ...``).  ``compare-*
--spp-chunk N`` renders both sides in chunks of N samples through
impl ``"kernel"``.  ``train-* --analyze`` prints the behaviour statistics
and writes their CSV and, where matplotlib is installed, the six-panel
figure (otherwise it says the figure was not drawn); ``rl-pipeline
--cpu`` is ``--device cpu``.  ``animate`` renders its frames one by one
(``render/animation.py``), where JAX maps one program over them; its path
frames draw from a ``torch.Generator`` seeded with ``--seed``, so their
noise is not JAX's.  ``interactive`` is the reference's ``input()`` menus
with JAX's prompts; its option 4 prints the port's integration example.
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


def _animate_scene(name, tracer, dev):
    """``(scene, glights, plights, params)`` of a library scene or, path
    tracer only, a template ``name[:variation]`` (emissive-sphere lit, no
    global or point lights)."""
    from .scene import library
    from .scene.templates import TEMPLATES, generate_scene

    if name in SCENES:
        return getattr(library, f"{name}_scene")(device=dev)
    tname, _, var = name.partition(":")
    if tname not in TEMPLATES or (var and not var.isdigit()):
        raise SystemExit(
            f"unknown scene {name!r}; expected one of {sorted(SCENES)} or "
            f"a template {sorted(TEMPLATES)} with an optional integer "
            f"variation (cornell_box:7)")
    if tracer != "path":
        raise SystemExit(f"template scene {name!r} has no global/point "
                         f"lights; use --tracer path")
    scene, _ = generate_scene(tname, int(var) if var else 0, device=dev)
    return scene, None, None, {"camera_position": (0.0, 0.5, 0.0),
                               "max_bounces": 8,
                               "background": (2.0, 2.0, 5.0)}


def cmd_animate(args):
    """A turntable: ``--frames`` look-at frames around the scene's focus,
    written as frame_%03d.png, a contact sheet, an APNG and
    animation_stats.json (the JAX CLI's files and keys)."""
    import os

    import numpy as np
    import torch

    from .core.device import resolve_device
    from .render.animation import (camera_path_rays, render_path_frames,
                                   render_whitted_frames, turntable)
    from .utils.io import save_apng, save_image

    dev = resolve_device(args.device)
    scene, gl, pl, p = _animate_scene(args.scene, args.tracer, dev)
    eyes, target, radius, y = turntable(
        scene, p["camera_position"], args.frames, target=args.target,
        radius=args.radius, y=args.y, sweep=args.sweep, device=dev)
    bounces = args.bounces or p["max_bounces"]
    extra = {}
    t0 = time.perf_counter()
    if args.tracer == "path":
        guide_fn = None
        if args.guide == "registry":
            from .fb.registry import STUDENTS_DIR, guide_for
            guide_fn = guide_for(args.scene, args.width, args.height,
                                 STUDENTS_DIR)
        elif args.guide:
            from .fb.distill import DistilledGuide
            guide_fn = DistilledGuide.load(args.guide).as_guide_fn()
        frames, stats = render_path_frames(
            scene, eyes, target, width=args.width, height=args.height,
            spp=args.spp, max_bounces=bounces, fov=args.fov,
            background=p.get("background", (2.0, 2.0, 5.0)),
            guide_fn=guide_fn, fb_prob=1.0,
            generator=torch.Generator(dev).manual_seed(args.seed),
            device=dev)
        st = stats.as_dict()
        extra = {"tracer": "path", "spp": args.spp,
                 "guided": bool(guide_fn),
                 **{k: st[k] for k in ("total_rays", "light_hits",
                                       "small_light_hits", "fb_used",
                                       "fb_success")}}
    else:
        origins, dirs = camera_path_rays(eyes, target, args.width,
                                         args.height, fov=args.fov)
        frames = render_whitted_frames(scene, gl, pl, origins, dirs,
                                       args.height, args.width,
                                       max_bounces=bounces,
                                       background=p["background"],
                                       miss_colour=p.get("sky_colour"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    arr = (np.clip(frames.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    for i in range(arr.shape[0]):
        save_image(os.path.join(args.out_dir, f"frame_{i:03d}.png"), arr[i])
    cols = min(args.frames, 6)
    rows = -(-args.frames // cols)
    sheet = np.zeros((rows * args.height, cols * args.width, 3), np.uint8)
    for i in range(arr.shape[0]):
        r, c = divmod(i, cols)
        sheet[r * args.height:(r + 1) * args.height,
              c * args.width:(c + 1) * args.width] = arr[i]
    save_image(os.path.join(args.out_dir, "contact_sheet.png"), sheet)
    save_apng(os.path.join(args.out_dir, "animation.png"), arr, fps=args.fps)
    # Path tracer: the rays traced (PathStats); Whitted: primary rays.
    rays = extra.get("total_rays") or args.frames * args.width * args.height
    stats = {"frames": args.frames, "width": args.width,
             "height": args.height, "bounces": bounces,
             "wall_s": round(dt, 4),
             "ms_per_frame": round(dt * 1e3 / args.frames, 3),
             "mrays_per_s": round(rays / dt / 1e6, 2),
             "target": [round(float(v), 4) for v in np.asarray(target)],
             "radius": round(radius, 4), "y": round(y, 4), **extra}
    with open(os.path.join(args.out_dir, "animation_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats))


def _make_rl_env(device, variant="rl", max_bounces=5):
    """The JAX CLI's training env: ``training_scene_v1`` at 800x600."""
    from .env.raytracer_env import RayTracerEnv
    from .env.scenes import training_scene_v1
    scene, gl, pl = training_scene_v1(device=device)
    return RayTracerEnv(scene, image_width=800, image_height=600, fov=90,
                        max_bounces=max_bounces, global_lights=gl,
                        point_lights=pl, variant=variant)


def _train(args, trainer_cls, config_cls, prefix):
    from .core.device import resolve_device
    env = _make_rl_env(resolve_device(args.device))
    tr = trainer_cls(env, config_cls(learning_rate=args.lr,
                                     tensorboard_log=args.tensorboard_log),
                     seed=args.seed)
    out = tr.train(args.timesteps)
    print(json.dumps(out))
    tr.save(args.out)
    print(f"saved -> {args.out}")
    if args.analyze:
        _post_training_analysis(env, tr, prefix)


def cmd_train_ppo(args):
    from .agents.ppo import PPOConfig, PPOTrainer
    _train(args, PPOTrainer, PPOConfig, "ppo_analysis")


def cmd_train_sac(args):
    from .agents.sac import SACConfig, SACTrainer
    _train(args, SACTrainer, SACConfig, "sac_analysis")


def _post_training_analysis(env, trainer, prefix):
    """Behaviour statistics, the six-panel figure and the CSV
    (RL/train_raytracer_improved.py:349-507).  Without matplotlib the
    figure is skipped with a line saying so."""
    from .agents.analytics import (advanced_analysis_png,
                                   analyze_agent_behavior)
    from .utils.figures import figure_or_note
    from .utils.metrics import write_csv
    behavior = analyze_agent_behavior(env, trainer.predict, episodes=200)
    print(json.dumps(behavior, indent=2, default=str))
    drawn = figure_or_note(advanced_analysis_png, behavior,
                           trainer.episode_rewards, f"{prefix}.png",
                           name=f"{prefix}.png")
    write_csv(f"{prefix}.csv",
              [{"metric": k, "value": json.dumps(v, default=str)}
               for k, v in behavior.items()])
    print(f"analysis -> {prefix}.png / {prefix}.csv" if drawn
          else f"analysis -> {prefix}.csv")


def cmd_train_q(args):
    from .agents.tabular_q import TabularQConfig, TabularQTrainer
    from .core.device import resolve_device
    env = _make_rl_env(resolve_device(args.device), max_bounces=5)
    tr = TabularQTrainer(env, TabularQConfig(), seed=args.seed)
    hist = tr.train(num_episodes=args.episodes)
    print(f"episodes={len(hist)} avg_reward_last_100="
          f"{sum(hist[-100:]) / max(1, len(hist[-100:])):.3f} "
          f"test={tr.test():.3f}")


def cmd_demo(args):
    """A scripted episode, step by step (the textual form of the
    reference's demos, RL/train_raytracer.py:232-297)."""
    import numpy as np
    import torch

    from .core.device import resolve_device
    dev = resolve_device(args.device)
    env = _make_rl_env(dev)
    state, obs = env.reset(1, generator=torch.Generator(dev).manual_seed(
        args.seed))
    print(f"pixel={tuple(int(v) for v in state.pixel[0])} "
          f"hit={bool(state.hit[0])}")
    rng = np.random.default_rng(args.seed)
    for step in range(env.max_bounces + 1):
        a = np.asarray([[rng.uniform(0, np.pi / 2),
                         rng.uniform(0, 2 * np.pi)]], np.float32)
        state, obs, r, term, info = env.step(state, a)
        print(f"step {step}: action=({a[0, 0]:.2f},{a[0, 1]:.2f})"
              f" reward={float(r[0]):+.3f} bounce={int(info['bounce'][0])}"
              f" done={bool(term[0])}")
        if bool(term[0]):
            break
    print(f"total reward: {float(state.total_reward[0]):+.3f}")


INTEGRATION_EXAMPLE = '''\
# Integration: trained policy as a sampling guide inside a renderer
# (the PyTorch/CUDA form of RL/ray_tracer_rl_complete.py:268-426's
# template; everything runs on the card, device "cuda").
import torch
from raytracer_tpu_torch.agents import SHIPPED_DIR
from raytracer_tpu_torch.compare.workbench import load_policy
from raytracer_tpu_torch.compare.rl_renderer import RayTracerRL
from raytracer_tpu_torch.env.raytracer_env import RayTracerEnv
from raytracer_tpu_torch.env.scenes import training_scene_complete

scene, gl, pl = training_scene_complete()
env = RayTracerEnv(scene, image_width=400, image_height=300, fov=75,
                   max_bounces=8, global_lights=gl, point_lights=pl)
policy = load_policy(SHIPPED_DIR / "ppo_raytracer.npz", env)  # .npz, .pkl
                                       # or an SB3 .zip (utils/sb3_import.py)
renderer = RayTracerRL(model_path=str(SHIPPED_DIR / "sac_raytracer.npz"))
renderer.render_comparison(width=200, height=150)

# FB guides plug into the path tracer the same way:
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR, guide_for
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene.library import chandelier_scene

scene, _, _, p = chandelier_scene()
guide = guide_for("chandelier", 800, 600, STUDENTS_DIR)
img, stats = render_path(scene, width=800, height=600, spp=8, max_bounces=8,
                         camera_position=p["camera_position"],
                         guide_fn=guide, fb_prob=1.0,
                         generator=torch.Generator("cuda").manual_seed(0))
# Full walk-through: docs/INTEGRATION.md and README.md's port section.
'''


def cmd_interactive(args, input_fn=input):
    """The reference's ``input()`` menu flows as one subcommand
    (RL/ray_tracer_rl_complete.py:498-545 options menu;
    RL/train_raytracer_improved.py:349-412 training-mode menu), with the
    JAX CLI's prompts.  Invalid or EOF input falls back to option 1, as in
    the reference.  Mode 2 runs the curriculum with SAC, whose parameters
    the port carries across phases (the JAX package's SAC cannot)."""
    from .agents.sac import SACConfig, SACTrainer
    from .compare.workbench import (check_model_exists, compare_rl_vs_random,
                                    evaluate_policy, load_policy)
    from .core.device import resolve_device

    dev = resolve_device(args.device)

    def ask(prompt, default):
        try:
            return input_fn(prompt) or default
        except Exception:
            return default

    print("=" * 80)
    print("RAY TRACING REINFORCEMENT LEARNING - COMPLETE SOLUTION")
    print("=" * 80)
    print("\nOptions:")
    print("1. Train a new model")
    print("2. Evaluate existing model")
    print("3. Demonstrate model behavior")
    print("4. Show integration example")
    print("5. Run performance benchmark (RL vs random)")
    print("6. Full pipeline (train -> evaluate -> benchmark)")
    try:
        choice = int(ask("\nSelect option (1-6): ", "1"))
    except Exception:
        choice = 1

    if choice == 1:
        # The improved-training sub-menu (train_raytracer_improved.py:355-364)
        print("\nTraining Modes:")
        print("1. Standard training (faster)")
        print("2. Curriculum learning (better results, slower)")
        print("3. Continue from saved model")
        try:
            mode = int(ask("\nSelect mode (1-3): ", "1"))
        except Exception:
            mode = 1
        timesteps = int(ask("Training timesteps (e.g., 20000): ", "20000"))
        name = ask("Model name (e.g., raytracer_sac): ", "raytracer_sac")
        if mode == 2:
            from .agents.adaptive import train_with_curriculum
            from .env.raytracer_env import RayTracerEnv
            from .env.scenes import dynamic_scene

            def phase_env(phase):
                scene, gl, pl = dynamic_scene(phase, device=dev)
                return RayTracerEnv(scene, image_width=800, image_height=600,
                                    fov=90, max_bounces=5, global_lights=gl,
                                    point_lights=pl)

            t3 = max(1, timesteps // 3)
            tr, _ = train_with_curriculum(phase_env, SACTrainer,
                                          steps_per_phase=(t3, t3, t3),
                                          seed=args.seed)
            env = tr.env
        else:
            env = _make_rl_env(dev)
            tr = SACTrainer(env, SACConfig(), seed=args.seed)
            if mode == 3:
                path = check_model_exists(name)
                if path is not None:
                    tr.load(str(path))
                    print(f"Loaded existing model: {path}")
                else:
                    print("No saved model found, starting fresh")
            print(json.dumps(tr.train(timesteps)))
        tr.save(f"{name}.pkl")
        print(json.dumps(evaluate_policy(env, tr.predict, episodes=20)))
    elif choice == 2:
        name = ask("Model name (without .zip): ", "raytracer_sac_model")
        env = _make_rl_env(dev)
        path = check_model_exists(name)
        if path is None:
            print(f"Model '{name}' not found")
            return
        policy = load_policy(str(path), env)
        print(json.dumps(evaluate_policy(env, policy.predict, episodes=20)))
    elif choice == 3:
        cmd_demo(args)
    elif choice == 4:
        print("\n" + "=" * 80)
        print("INTEGRATION EXAMPLE")
        print("=" * 80)
        print(INTEGRATION_EXAMPLE)
    elif choice == 5:
        env = _make_rl_env(dev)
        name = ask("Model name (blank = random policy): ", "")
        path = check_model_exists(name) if name else None
        if path is not None:
            policy = load_policy(str(path), env).predict
        else:
            # reference-style graceful fallback: uniform-random policy
            import numpy as np
            rng = np.random.default_rng(args.seed)
            policy = lambda obs: rng.uniform(  # noqa: E731
                [0.0, 0.0], [np.pi / 2, 2 * np.pi],
                size=(obs.shape[0], 2)).astype(np.float32)
        print(json.dumps(compare_rl_vs_random(env, policy, episodes=50),
                         indent=2))
    else:
        args.timesteps = int(ask("Training timesteps (e.g., 20000): ",
                                 "20000"))
        args.out = "raytracer_final.pkl"
        cmd_rl_pipeline(args)


def cmd_rl_pipeline(args):
    """RL/ray_tracer_rl_complete.py's pipeline: train, evaluate, benchmark
    against random actions.  ``--algo ppo`` trains with
    ``PPOTrainer.train_on_device``; ``sac`` with the host replay buffer."""
    from pathlib import Path

    from .compare.workbench import compare_rl_vs_random, evaluate_policy
    from .core.device import resolve_device
    from .env.raytracer_env import RayTracerEnv
    from .env.scenes import training_scene_complete

    dev = resolve_device("cpu" if getattr(args, "cpu", False)
                         else args.device)
    scene, gl, pl = training_scene_complete(device=dev)
    env = RayTracerEnv(scene, image_width=400, image_height=300, fov=75,
                       max_bounces=8, global_lights=gl, point_lights=pl,
                       variant="rl")
    tb_log = getattr(args, "tensorboard_log", None)
    if getattr(args, "algo", "sac") == "ppo":
        from .agents.ppo import PPOConfig, PPOTrainer
        tr = PPOTrainer(env, PPOConfig(tensorboard_log=tb_log),
                        seed=args.seed)
        print(f"training (PPO on {dev})...")
        print(json.dumps(tr.train_on_device(args.timesteps)))
    else:
        from .agents.sac import SACConfig, SACTrainer
        tr = SACTrainer(env, SACConfig(
            learning_starts=min(1000, args.timesteps // 4),
            tensorboard_log=tb_log), seed=args.seed)
        print("training...")
        print(json.dumps(tr.train(args.timesteps)))
    tr.save(args.out)
    print("evaluating...")
    print(json.dumps(evaluate_policy(env, tr.predict, episodes=50)))
    print("benchmark vs random...")
    bench_out = str(Path(args.out).with_suffix("")) + "_benchmark.json"
    print(json.dumps(compare_rl_vs_random(env, tr.predict, episodes=100,
                                          out_path=bench_out), indent=2))
    print(f"wrote {bench_out}")


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

    an = command("animate", cmd_animate)
    an.add_argument("--scene", default="chandelier",
                    help="library scene (true_original/planets2/marbles4/"
                         "chandelier/custom) or, with --tracer path, a "
                         "multi-scene template (cornell_box[:var])")
    an.add_argument("--frames", type=int, default=12)
    an.add_argument("--width", type=int, default=320)
    an.add_argument("--height", type=int, default=240)
    an.add_argument("--fov", type=float, default=60.0)
    an.add_argument("--fps", type=float, default=10.0,
                    help="APNG playback rate")
    an.add_argument("--tracer", default="whitted",
                    choices=["whitted", "path"])
    an.add_argument("--spp", type=int, default=4,
                    help="path tracer samples per pixel")
    an.add_argument("--guide", default=None,
                    help="path tracer FB guide: a student .npz, or "
                         "'registry' for per-camera dispatch")
    an.add_argument("--seed", type=int, default=0)
    an.add_argument("--bounces", type=int, default=None)
    an.add_argument("--radius", type=float, default=None,
                    help="orbit radius (default: camera-target distance)")
    an.add_argument("--y", type=float, default=None,
                    help="camera height (default: the scene camera's y)")
    an.add_argument("--sweep", type=float, default=6.283185307179586,
                    help="arc in radians (default full turn)")
    an.add_argument("--target", type=float, nargs=3, default=None)
    an.add_argument("--out-dir", default="animation_out")

    for name, fn in [("train-ppo", cmd_train_ppo),
                     ("train-sac", cmd_train_sac)]:
        t = command(name, fn)
        t.add_argument("--timesteps", type=int, default=50_000)
        t.add_argument("--lr", type=float, default=3e-4)
        t.add_argument("--seed", type=int, default=0)
        t.add_argument("--out", default=f"{name.replace('-', '_')}_model.pkl")
        t.add_argument("--analyze", action="store_true")
        t.add_argument("--tensorboard-log", default=None,
                       help="write SB3-style TensorBoard events under "
                            "this dir (e.g. ./raytracer_ppo_tensorboard/)")

    q = command("train-q", cmd_train_q)
    q.add_argument("--episodes", type=int, default=1000)
    q.add_argument("--seed", type=int, default=0)

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

    dm = command("demo", cmd_demo)
    dm.add_argument("--seed", type=int, default=0)

    it = command("interactive", cmd_interactive)
    it.add_argument("--seed", type=int, default=0)

    rp = command("rl-pipeline", cmd_rl_pipeline)
    rp.add_argument("--algo", default="sac", choices=["sac", "ppo"],
                    help="ppo: PPOTrainer.train_on_device; sac: the host "
                         "replay buffer")
    rp.add_argument("--timesteps", type=int, default=20_000)
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--out", default="raytracer_final.pkl")
    rp.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    rp.add_argument("--tensorboard-log", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
