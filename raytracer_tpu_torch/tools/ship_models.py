"""Recipes for the FB models: teachers, students and their held-out
reports, on the card.

Counterpart of ``scripts/ship_models.py``, with its subcommands,
arguments and defaults, and ``--device`` (``cuda`` by default; ``cpu``
runs the plain PyTorch versions) in place of ``--tpu``:

    python -m raytracer_tpu_torch.tools.ship_models train-chandelier [--scenes 160] [--steps 200]
    python -m raytracer_tpu_torch.tools.ship_models train-complex    [--scenes 100] [--steps 150]
    python -m raytracer_tpu_torch.tools.ship_models train-multi
    python -m raytracer_tpu_torch.tools.ship_models eval-multi [--model M] [--type cornell_box]
    python -m raytracer_tpu_torch.tools.ship_models distill --scene chandelier \\
        --teacher build/ship/fb_chandelier_trained.npz \\
        --out build/ship/fb_chandelier_distilled.npz [--sharpen]
    python -m raytracer_tpu_torch.tools.ship_models distill-ensemble --scene chandelier --teachers A B --out S
    python -m raytracer_tpu_torch.tools.ship_models distill-episodes --type occluded_lights --out S
    python -m raytracer_tpu_torch.tools.ship_models eval --scene chandelier --model S [--size 100x50]
    python -m raytracer_tpu_torch.tools.ship_models heldout-chandelier

Training runs the FB method as the port's trainers define it
(``fb/trainer.py``: walks through the nearest-hit kernel, hindsight
relabelling); ``train-*`` run it in three chunks at ``guide_prob`` 0,
0.25 and ``--guide-prob`` (train-chandelier with ``--wall-schedule``'s
wall-start fraction a chunk).  Outputs go under ``build/ship/`` (the JAX
script writes ``models/``, which stays the JAX package's); checkpoints
are the native ``.npz`` that both packages' ``load_fb`` read, students
the flat ``.npz`` of ``DistilledGuide``.  The readers default to those
outputs (``heldout-chandelier``'s student to the deployed student's copy
in ``fb/students/``).  Draws come from ``torch.Generator``s seeded as the
script seeds its keys, so the walks are not JAX's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

OUT = "build/ship"


def _override_config(args, base):
    """``--z-dim/--e-hidden/--f-hidden/--b-hidden`` on top of a trainer's
    default config; None (keep the default) when no flag is set."""
    if not any(v is not None for v in (args.z_dim, args.e_hidden,
                                       args.f_hidden, args.b_hidden)):
        return None
    return dataclasses.replace(
        base,
        z_dim=args.z_dim or base.z_dim,
        e_hidden_dim=args.e_hidden or base.e_hidden_dim,
        f_hidden_dim=args.f_hidden or base.f_hidden_dim,
        b_hidden_dim=args.b_hidden or base.b_hidden_dim)


def chunks(scenes: int, guide_prob: float):
    """The guide-in-the-loop curriculum: random-walk exploration, then a
    quarter of the steps policy-driven, then ``guide_prob``."""
    return [(scenes // 4, 0.0), (scenes // 4, 0.25),
            (scenes // 2, guide_prob)]


def _save(agent, out):
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    agent.save(out)


def cmd_train_chandelier(args):
    from ..fb import trainer as fb_trainer
    from ..fb.config import FBConfig

    cfg = _override_config(args, FBConfig(max_bounces=8, f_hidden_dim=512,
                                          b_hidden_dim=256))
    tr = fb_trainer.ChandelierOnlyTrainer(
        num_training_scenes=args.scenes, seed=args.seed,
        output_dir=args.workdir, guide_prob=0.0, config=cfg,
        resume_from=args.resume_from, device=args.device)
    plan = chunks(args.scenes, args.guide_prob)
    wall = args.wall_schedule or [tr.WALL_FRAC] * len(plan)
    if len(wall) != len(plan):
        raise SystemExit("--wall-schedule needs 3 values")
    done = 0
    for (n, gp), wf in zip(plan, wall):
        tr.guide_prob = gp
        tr.WALL_FRAC = wf
        tr.num_training_scenes = n
        tr.run_training(num_scenes=n, scenes_per_batch=20,
                        training_steps_per_scene=args.steps)
        done += n
        print(f"[train-chandelier] {done} scenes done (guide_prob={gp}, "
              f"wall_frac={wf}), noise={tr.agent.noise_scale:.4f}",
              flush=True)
    out = args.out or f"{OUT}/fb_chandelier_trained.npz"
    _save(tr.agent, out)
    held = tr.test_on_chandelier(num_tests=500)
    print(json.dumps(held, indent=2))
    print(f"saved teacher -> {out}")


def cmd_train_complex(args):
    from ..fb import trainer as fb_trainer
    from ..fb.config import FBConfig

    cfg = _override_config(args, FBConfig(max_bounces=8))
    tr = fb_trainer.RayTracedComplexTrainer(
        num_training_scenes=args.scenes, seed=args.seed,
        output_dir=args.workdir, guide_prob=0.0, config=cfg,
        resume_from=args.resume_from, device=args.device)
    for n, gp in chunks(args.scenes, args.guide_prob):
        tr.guide_prob = gp
        tr.run_training(num_scenes=n, scenes_per_batch=20,
                        training_steps_per_scene=args.steps)
        print(f"[train-complex] +{n} scenes (guide_prob={gp})", flush=True)
    out = args.out or f"{OUT}/fb_complex_trained.npz"
    _save(tr.agent, out)
    print(json.dumps(tr.test_on_complex(num_tests=500), indent=2))
    print(f"saved teacher -> {out}")


def cmd_train_multi(args):
    """The reference protocol (fb_multi_scene_training_*): scenes cycling
    the 8 templates, ``--steps`` walker episodes a scene; the average hit
    rate against the reference's recorded 34.7%
    (final_training_report.json)."""
    from ..fb import trainer as fb_trainer
    from ..fb.config import FBConfig

    cfg = _override_config(args, FBConfig())
    tr = fb_trainer.MultiSceneFBTrainer(
        num_training_scenes=args.scenes, seed=args.seed,
        output_dir=args.workdir, guide_prob=0.0, config=cfg,
        resume_from=args.resume_from, device=args.device)
    report = None
    for n, gp in chunks(args.scenes, args.guide_prob):
        tr.guide_prob = gp
        report = tr.run_training(num_scenes=n, scenes_per_batch=20,
                                 training_steps_per_scene=args.steps)
        print(f"[train-multi] +{n} scenes (guide_prob={gp})", flush=True)
    out = args.out or f"{OUT}/fb_multi_scene_trained.npz"
    _save(tr.agent, out)
    stats = report["performance_statistics"]
    print(json.dumps({"avg_hit_rate": stats["avg_hit_rate"],
                      "by_type": report["scene_type_performance"]},
                     indent=2))
    print(f"saved multi-scene agent -> {out}")


def config_from_ckpt(path):
    """The ``FBConfig`` a checkpoint was trained with (``save_fb`` keeps
    ``config.to_dict()`` in the npz's ``__meta__``)."""
    import numpy as np

    from ..fb.config import FBConfig

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
    fields = {f.name for f in dataclasses.fields(FBConfig)}
    return FBConfig(**{k: v for k, v in meta.get("config", {}).items()
                       if k in fields})


def _lights(scene):
    """The small lights, else every real emissive sphere."""
    import numpy as np

    from ..fb.inference import small_light_indices
    idx = small_light_indices(scene)
    if idx.size == 0:
        em = scene.emitive.cpu().numpy() > 0
        real = scene.radius.cpu().numpy() > 0
        idx = np.nonzero(em & real)[0]
    return idx


def cmd_eval_multi(args):
    """Held-out multi-scene evaluation: the strict episode hit fraction
    (did a walk of at most ``max_bounces`` steps land on an emissive
    sphere) of the deterministic policy with a per-scene light prototype,
    against the cosine random walk, on scenes the trainer never saw
    (variations 1000+, cycling the 8 templates).  ``--type`` keeps one
    template; ``--model`` may be a distilled student."""
    import numpy as np
    import torch

    from ..compare.harness import _is_distilled
    from ..core.device import resolve_device
    from ..fb.inference import TrainedFBAgent
    from ..fb.trainer import _CYCLE
    from ..fb.trajectory import draw_walk, generate_trajectories
    from ..scene import templates

    dev = resolve_device(args.device)
    distilled = _is_distilled(args.model)
    if distilled:
        from ..fb.config import FBConfig
        from ..fb.distill import DistilledGuide
        guide = DistilledGuide.load(args.model).as_guide_fn(dtype=None)
        cfg = FBConfig()                     # max_bounces=8, episode budget
    else:
        cfg = config_from_ckpt(args.model)
    gen = torch.Generator(dev).manual_seed(args.seed)
    rows = []
    for i in range(args.scenes):
        stype = args.type or _CYCLE[i % len(_CYCLE)]
        scene, name = templates.generate_scene(stype, 1000 + i, pad_to=64,
                                               device=dev)
        if not distilled:
            guide = TrainedFBAgent(args.model, scene, _lights(scene),
                                   (0.0, 2.0, 0.0), config=cfg,
                                   device=dev).as_guide_fn(dtype=None)

        def walk(**kw):
            draws = draw_walk(args.episodes, scene.num_spheres,
                              cfg.max_bounces, start_bias="small",
                              guided=bool(kw), generator=gen, device=dev)
            return generate_trajectories(scene, draws,
                                         max_steps=cfg.max_bounces,
                                         start_bias="small", **kw)
        pol = walk(guide=guide, guide_prob=1.0, guide_noise=0.0)
        rnd = walk()
        rows.append({
            "scene": name, "scene_type": stype.split("_")[0],
            "policy_hit_rate": float(pol.episode_hit.float().mean()),
            "random_hit_rate": float(rnd.episode_hit.float().mean()),
        })
        if (i + 1) % 20 == 0:
            print(f"[eval-multi] {i + 1}/{args.scenes} scenes", flush=True)
    p_all = float(np.mean([r["policy_hit_rate"] for r in rows]))
    r_all = float(np.mean([r["random_hit_rate"] for r in rows]))
    by_type = {}
    for r in rows:
        by_type.setdefault(r["scene_type"], []).append(
            (r["policy_hit_rate"], r["random_hit_rate"]))
    report = {
        "model": str(args.model),
        "num_scenes": args.scenes,
        "episodes_per_scene": args.episodes,
        "seed": args.seed,
        "policy_hit_rate": p_all,
        "random_hit_rate": r_all,
        "ratio": (p_all / r_all) if r_all > 0 else None,
        "by_type": {t: {"policy": float(np.mean([p for p, _ in v])),
                        "random": float(np.mean([r for _, r in v]))}
                    for t, v in by_type.items()},
    }
    out = args.out or f"{OUT}/fb_multi_scene_held_out.json"
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: report[k] for k in
                      ("policy_hit_rate", "random_hit_rate", "ratio")},
                     indent=2))
    print(f"wrote {out}")


def scene_setup(which: str, device):
    """``chandelier``, ``complex`` or a multi-scene template, optionally
    with a variation (``cornell_box:7``): ``(scene, camera_position)``."""
    if which == "chandelier":
        from ..scene.library import chandelier_scene
        scene, _, _, p = chandelier_scene(device=device)
        return scene, p["camera_position"]
    if which == "complex":
        from ..scene.complex import (create_camera_for_scene,
                                     create_complex_scene)
        scene, _, _ = create_complex_scene(device=device)
        return scene, create_camera_for_scene()
    from ..scene.templates import TEMPLATES, generate_scene
    name, _, var = which.partition(":")
    if name not in TEMPLATES or (var and not var.isdigit()):
        raise SystemExit(f"unknown scene {which!r}; expected chandelier, "
                         f"complex, or one of {sorted(TEMPLATES)} with an "
                         f"optional integer variation (cornell_box:7)")
    scene, _ = generate_scene(name, int(var) if var else 0, device=device)
    # Template interiors sit around (0, ~0.5-1, 4); the path camera looks
    # +z from the origin plane.
    return scene, (0.0, 0.5, 0.0)


def _teacher(path, scene, cam, dev):
    """A trained teacher at its checkpoint's widths (the script builds
    ``FBConfig()``'s, so it distills default-width teachers only)."""
    from ..fb.inference import TrainedFBAgent, small_light_indices
    agent = TrainedFBAgent(path, scene, small_light_indices(scene), cam,
                           config=config_from_ckpt(path), device=dev)
    if not agent.loaded:
        raise SystemExit(f"teacher failed to load: {path}")
    return agent


def cmd_distill(args):
    from ..core.device import resolve_device
    from ..fb.distill import distill_agent

    dev = resolve_device(args.device)
    scene, cam = scene_setup(args.scene, dev)
    agent = _teacher(args.teacher, scene, cam, dev)
    guide, res = distill_agent(
        agent, scene, seed=args.seed, camera_position=cam,
        frames=args.frames, epochs=args.epochs,
        hidden=tuple(args.hidden), hit_weight_bonus=args.bonus,
        hindsight_sharpen=args.sharpen)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    guide.save(args.out)
    print(f"distilled {args.teacher} -> {args.out}: "
          f"n_obs={res.n_obs:,} final_loss={res.final_loss:.2e} "
          f"hidden={tuple(args.hidden)} sharpen={args.sharpen}")


def cmd_distill_ensemble(args):
    """One student imitating, observation by observation, whichever of
    several trained teachers lands its action on a (small) light; the
    first teacher wins ties."""
    from ..core.device import resolve_device
    from ..fb.distill import distill_ensemble

    dev = resolve_device(args.device)
    scene, cam = scene_setup(args.scene, dev)
    agents = [_teacher(p, scene, cam, dev) for p in args.teachers]
    guide, res = distill_ensemble(
        agents, scene, seed=args.seed, camera_position=cam,
        frames=args.frames, epochs=args.epochs, hidden=tuple(args.hidden),
        hit_weight_bonus=args.bonus)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    guide.save(args.out)
    print(f"ensemble-distilled {len(agents)} teachers -> {args.out}: "
          f"n_obs={res.n_obs:,} final_loss={res.final_loss:.2e} "
          f"hidden={tuple(args.hidden)}")


def cmd_distill_episodes(args):
    """Episode-walk distillation for open-geometry templates: the pool
    comes from teacher-guided episode walks over training variations
    (the distribution ``eval-multi`` measures), hindsight-sharpened with
    ``--sharpen``, and one student is fitted to it."""
    import numpy as np
    import torch

    from ..core.device import resolve_device
    from ..fb.distill import (DistilledGuide, distill, hindsight_aim_targets,
                              light_hit_weights)
    from ..fb.inference import TrainedFBAgent
    from ..fb.trajectory import draw_walk, generate_trajectories
    from ..scene import templates

    dev = resolve_device(args.device)
    cfg = config_from_ckpt(args.teacher)
    gen = torch.Generator(dev).manual_seed(args.seed)
    all_obs, all_tgt, all_w = [], [], []
    for i in range(args.scenes):
        # Training variations (< 1000); eval-multi holds out 1000+.
        scene, _ = templates.generate_scene(args.type, i, pad_to=64,
                                            device=dev)
        ta = TrainedFBAgent(args.teacher, scene, _lights(scene),
                            (0.0, 2.0, 0.0), config=cfg, device=dev)
        tfn = ta.as_guide_fn(dtype=None)
        draws = draw_walk(args.walkers, scene.num_spheres, cfg.max_bounces,
                          start_bias="small", guided=True, generator=gen,
                          device=dev)
        batch = generate_trajectories(
            scene, draws, max_steps=cfg.max_bounces, start_bias="small",
            guide=tfn, guide_prob=1.0, guide_noise=args.noise)
        valid = batch.valid.reshape(-1)
        obs_t = batch.obs.reshape(-1, 22)[valid]
        obs = obs_t.cpu().numpy()
        # Targets: the deterministic per-scene policy (what eval-multi
        # deploys), not the noisy exploration actions.
        acts = np.clip(tfn(obs_t).cpu().numpy(), -1.0, 1.0)
        if args.sharpen:
            tgt, w = hindsight_aim_targets(scene, obs, acts,
                                           bonus=args.bonus, device=dev)
        else:
            tgt = acts
            w = light_hit_weights(scene, obs, acts, bonus=args.bonus,
                                  device=dev)
        all_obs.append(obs)
        all_tgt.append(tgt)
        all_w.append(w)
        if (i + 1) % 8 == 0:
            print(f"[distill-episodes] {i + 1}/{args.scenes} scenes, "
                  f"{sum(o.shape[0] for o in all_obs):,} obs", flush=True)
    obs = np.concatenate(all_obs)
    tgt = np.concatenate(all_tgt)
    w = np.concatenate(all_w)
    # Episode pools are small next to render pools (open-geometry walks
    # mostly escape after a step or two): a smaller batch keeps a useful
    # number of optimiser steps.
    bs = min(args.batch_size, max(4096, obs.shape[0] // 8))
    res = distill(None, obs, seed=args.seed, hidden=tuple(args.hidden),
                  epochs=args.epochs, targets=tgt, weights=w,
                  batch_size=bs, device=dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    DistilledGuide(res.params, res.hidden).save(args.out)
    print(f"episode-distilled {args.teacher} on {args.type} -> {args.out}: "
          f"n_obs={res.n_obs:,} final_loss={res.final_loss:.2e} "
          f"hidden={tuple(args.hidden)} sharpen={args.sharpen}")


def cmd_eval(args):
    from ..compare.harness import (chandelier_comparison, complex_comparison,
                                   run_comparison)
    w, h = (int(x) for x in args.size.split("x"))
    if args.scene == "chandelier":
        fn = chandelier_comparison
    elif args.scene == "complex":
        fn = complex_comparison
    else:
        scene, cam = scene_setup(args.scene, "cpu")

        def fn(**kw):
            return run_comparison(scene, camera_position=cam,
                                  scene_name=args.scene.replace(":", "_v"),
                                  impl="kernel", **kw)
    stats = fn(model_path=args.model, width=w, height=h,
               samples_per_pixel=args.spp, max_bounces=args.bounces,
               seed=args.seed, save_png=False,
               fb_samples_per_pixel=args.fb_spp,
               out_dir=args.out or f"{OUT}/eval", device=args.device)
    print(json.dumps({"traditional": stats["traditional"],
                      "fb": stats["fb"],
                      "comparison": stats["comparison"]}, indent=2))
    return stats


def cmd_heldout_chandelier(args):
    """The held-out report of the shipped chandelier pipeline on variation
    99, which the trainer never saw (FB/train_chandelier_only.py:199-300):
    the teacher's one-step surface probe against solid-angle random, the
    student's on the same draws, a render-level comparison on the
    deployment scene, and why the two kinds of number diverge."""
    import torch

    from ..compare.harness import run_comparison
    from ..core.device import resolve_device
    from ..fb.distill import DistilledGuide
    from ..fb.trainer import ChandelierOnlyTrainer
    from ..scene import templates

    dev = resolve_device(args.device)
    cfg = config_from_ckpt(args.teacher)
    tr = ChandelierOnlyTrainer(num_training_scenes=0, config=cfg,
                               output_dir=f"{OUT}/heldout_probe",
                               seed=args.seed, device=dev)
    tr.agent.load(args.teacher)
    scene, _ = templates.generate_scene("chandelier_scene", 99,
                                        pad_to=tr.PAD_TO, device=dev)
    tr._gen = torch.Generator(dev).manual_seed(args.seed + 99)
    teacher = tr.test_on_scene(scene, num_tests=args.tests)

    sfn = DistilledGuide.load(args.student).as_guide_fn(dtype=None)
    tr._gen = torch.Generator(dev).manual_seed(args.seed + 99)  # same draws
    stud = tr.test_on_scene(scene, num_tests=args.tests, action_fn=sfn)

    # The render-level probe runs on the deployment scene (the library
    # chandelier the student is registered for): the held-out variation's
    # jittered light cluster sits outside the default camera's reach, and
    # neither sampler records a small-light hit there.
    scene_r, cam = scene_setup("chandelier", dev)
    w, h = (int(x) for x in args.render_size.split("x"))
    rstats = run_comparison(
        scene_r, camera_position=cam, width=w, height=h,
        samples_per_pixel=args.render_spp, max_bounces=8,
        model_path=args.student, seed=args.render_seed, save_png=False,
        impl="kernel", out_dir=f"{OUT}/heldout_render",
        scene_name="chandelier_heldout", traditional_mirror_threshold=0.0,
        device=dev)
    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu")
    report = {
        "protocol": {
            "held_out_scene": "chandelier_scene variation 99 "
                              "(training used variations < num_scenes)",
            "one_step_probe": "FB/train_chandelier_only.py:199-300 - "
                              "random surface point, one policy ray, hit "
                              "rate vs cosine random baseline",
            "render_probe": f"{w}x{h}@{args.render_spp}spp max_bounces=8 "
                            f"seed={args.render_seed} equal-spp comparison "
                            "(compare/harness.py) on the DEPLOYMENT scene "
                            "(see render_level.note)",
            "teacher": str(args.teacher),
            "student": str(args.student),
            "num_tests": args.tests,
        },
        "teacher_one_step": teacher,
        "student_one_step": stud,
        "render_level": {
            "note": "deployment (library) chandelier scene - the held-out "
                    "variation has no camera-reachable light signal for "
                    "either sampler",
            "backend": backend,
            "small_light_improvement":
                rstats["comparison"]["small_light_improvement"],
            "speedup": rstats["comparison"]["speedup"],
            "fb_success_rate": rstats["fb"].get("fb_success_rate"),
        },
        "explanation": (
            "One-step surface-probe hit rates and multi-bounce render "
            "improvement measure different skills and may diverge: the "
            "probe draws uniform random surface points and counts "
            "single-ray light hits; the render metric accumulates guided "
            "bounces along camera-reachable paths over 8 levels."),
    }
    out = args.out or f"{OUT}/fb_chandelier_held_out.json"
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))
    print(f"wrote {out}")
    return report


def build_parser() -> argparse.ArgumentParser:
    from ..fb.registry import STUDENTS_DIR

    p = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch.tools.ship_models")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn):
        c = sub.add_parser(name)
        c.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the "
                            "plain PyTorch versions)")
        c.set_defaults(fn=fn)
        return c

    for name, fn in (("train-chandelier", cmd_train_chandelier),
                     ("train-complex", cmd_train_complex),
                     ("train-multi", cmd_train_multi)):
        c = command(name, fn)
        c.add_argument("--scenes", type=int, default=160)
        c.add_argument("--steps", type=int, default=200)
        c.add_argument("--guide-prob", type=float, default=0.5)
        c.add_argument("--seed", type=int, default=0)
        c.add_argument("--out", default=None)
        c.add_argument("--workdir", default=f"{OUT}/fb_ship_training")
        c.add_argument("--resume-from", default=None,
                       help="continue training from a saved checkpoint "
                            "(final or per-batch npz)")
        c.add_argument("--wall-schedule", type=float, nargs=3, default=None,
                       help="wall-start fraction per curriculum chunk "
                            "(train-chandelier only; default 0.35 0.35 "
                            "0.35, the shipped v4/v5 recipe)")
        c.add_argument("--z-dim", type=int, default=None)
        c.add_argument("--e-hidden", type=int, default=None)
        c.add_argument("--f-hidden", type=int, default=None)
        c.add_argument("--b-hidden", type=int, default=None)

    em = command("eval-multi", cmd_eval_multi)
    em.add_argument("--model", default=f"{OUT}/fb_multi_scene_trained.npz",
                    help="full agent .npz, or a distilled student")
    em.add_argument("--type", default=None,
                    help="restrict to one template type (e.g. cornell_box)")
    em.add_argument("--scenes", type=int, default=100)
    em.add_argument("--episodes", type=int, default=256)
    em.add_argument("--seed", type=int, default=0)
    em.add_argument("--out", default=None)

    d = command("distill", cmd_distill)
    d.add_argument("--scene", required=True,
                   help="chandelier, complex, or a template "
                        "(cornell_box[:var])")
    d.add_argument("--teacher", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    d.add_argument("--frames", type=int, default=6)
    d.add_argument("--epochs", type=int, default=40)
    d.add_argument("--bonus", type=float, default=9.0)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--sharpen", action="store_true",
                   help="hindsight aim-sharpened targets")

    de = command("distill-ensemble", cmd_distill_ensemble)
    de.add_argument("--scene", required=True,
                    help="chandelier, complex, or a template "
                         "(cornell_box[:var])")
    de.add_argument("--teachers", nargs="+", required=True,
                    help="teacher checkpoints; the FIRST wins ties")
    de.add_argument("--out", required=True)
    de.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    de.add_argument("--frames", type=int, default=6)
    de.add_argument("--epochs", type=int, default=40)
    de.add_argument("--bonus", type=float, default=9.0)
    de.add_argument("--seed", type=int, default=0)

    dep = command("distill-episodes", cmd_distill_episodes)
    dep.add_argument("--type", required=True,
                     help="template type, e.g. occluded_lights")
    dep.add_argument("--teacher", default=f"{OUT}/fb_multi_scene_trained.npz")
    dep.add_argument("--out", required=True)
    dep.add_argument("--scenes", type=int, default=24)
    dep.add_argument("--walkers", type=int, default=8192)
    dep.add_argument("--batch-size", type=int, default=8192)
    dep.add_argument("--noise", type=float, default=0.05)
    dep.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    dep.add_argument("--epochs", type=int, default=40)
    dep.add_argument("--bonus", type=float, default=9.0)
    dep.add_argument("--seed", type=int, default=0)
    dep.add_argument("--sharpen", action="store_true")

    hc = command("heldout-chandelier", cmd_heldout_chandelier)
    hc.add_argument("--teacher", default=f"{OUT}/fb_chandelier_trained.npz")
    hc.add_argument("--student",
                    default=str(STUDENTS_DIR / "fb_chandelier_distilled.npz"))
    hc.add_argument("--tests", type=int, default=500)
    hc.add_argument("--render-size", default="200x100")
    hc.add_argument("--render-spp", type=int, default=8)
    hc.add_argument("--render-seed", type=int, default=5)
    hc.add_argument("--seed", type=int, default=0)
    hc.add_argument("--out", default=None)

    e = command("eval", cmd_eval)
    e.add_argument("--scene", required=True,
                   help="chandelier, complex, or a template "
                        "(cornell_box[:var])")
    e.add_argument("--model", required=True)
    e.add_argument("--size", default="100x50")
    e.add_argument("--spp", type=int, default=4)
    e.add_argument("--fb-spp", type=int, default=None)
    e.add_argument("--bounces", type=int, default=8)
    e.add_argument("--seed", type=int, default=5)
    e.add_argument("--out", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
