"""Recipes for the RL policies, trained on the card.

Counterparts of the JAX package's RL shipping scripts, as subcommands
(``--device``: ``cuda`` by default, ``cpu`` for the plain PyTorch
versions):

    python -m raytracer_tpu_torch.tools.ship_rl ppo-sweep [--scale 1.0] [--quick] [--round2]
    python -m raytracer_tpu_torch.tools.ship_rl ppo-ship
    python -m raytracer_tpu_torch.tools.ship_rl sac-ship [--timesteps 400000]

* ``ppo-sweep`` (``scripts/ppo_train_to_win.py``): the reference's
  optimized recipe (RL/train_raytracer_optimized.py:146-250): three-stage
  entropy annealing 0.1 → 0.03 → 0.01 with ``cfg.ent_coef`` reset
  between stages, on ``PPOTrainer.train_on_device``, over the base env and
  the shaped env (``agents/adaptive.py``); each candidate is scored by the
  exact light-hit z-score against random.  ``--quick`` scales the stages
  by 0.25 whatever ``--scale`` says, as the script does.  Writes
  ``ppo_sweep.json`` and the best candidate's ``ppo_best.npz``.
* ``ppo-ship`` (``scripts/ppo_ship_best.py``): the sweep's winner
  (hidden 128x128, 512 envs, stages 0.4M/0.6M/1M) trained, evaluated over
  2,048 episodes, and its wall time set beside 100k steps of the same
  configuration on ``--device cpu`` (the script compared two JAX
  backends; ``scripts/ppo_tpu_artifact.py`` is not ported for that
  reason).  Writes ``ppo_raytracer.npz``, ``ppo_raytracer_benchmark.json``
  and ``ppo_card_train.json``.
* ``sac-ship`` (``scripts/sac_ship_tpu.py``): SAC with the ring buffer on
  the device (``SACTrainer.train_on_device``) at the reference's
  hyperparameters, evaluated, with a CPU probe.  Writes
  ``sac_raytracer_card.npz``, ``sac_raytracer_card_benchmark.json`` and
  ``sac_card_train.json``.

Every output goes under ``build/ship/`` (the scripts write ``models/``
and ``/tmp``).  The env is ``training_scene_complete`` at 400x300, fov
75, 8 bounces, the RL variant; the light ids of the shaped env 99 and
100.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

OUT = Path("build/ship")

# (ent_coef, timesteps) a stage; ppo-sweep scales them.
SWEEP_STAGES = {
    "round1": [(0.1, 100_000), (0.03, 100_000), (0.01, 200_000)],
    # Round 2 scales steps, batch and width instead of stopping at round
    # 1's local optimum.
    "round2": [(0.1, 400_000), (0.03, 600_000), (0.01, 1_000_000)],
}
# env "base" or "shaped"; ent None: the stage's annealed value.
SWEEP_CANDIDATES = {
    "round1": {
        "long_flat": dict(env="base", anneal=False, ent=0.0),
        "anneal": dict(env="base", anneal=True, ent=None),
        "shaped_anneal": dict(env="shaped", anneal=True, ent=None),
    },
    "round2": {
        "shaped_anneal_2m": dict(env="shaped", anneal=True, ent=None),
        "shaped_anneal_2m_big": dict(env="shaped", anneal=True, ent=None,
                                     hidden=(128, 128), batch_envs=512),
        "anneal_2m_big": dict(env="base", anneal=True, ent=None,
                              hidden=(128, 128), batch_envs=512),
    },
}

SHIP_STAGES = [(0.1, 400_000), (0.03, 600_000), (0.01, 1_000_000)]
SHIP_HIDDEN = (128, 128)
SHIP_BATCH = 512
SHIP_EVAL_EPISODES = 2048
CPU_PROBE_STEPS = 100_000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def hit_z(p1, n1, p0, n0):
    """Two-proportion z of a light-hit-rate difference."""
    p = (p1 * n1 + p0 * n0) / (n1 + n0)
    se = math.sqrt(max(p * (1 - p) * (1 / n1 + 1 / n0), 1e-12))
    return (p1 - p0) / se


def sweep_stages(scale: float, quick: bool, round2: bool):
    sc = 0.25 if quick else scale
    base = SWEEP_STAGES["round2" if round2 else "round1"]
    return [(e, int(n * sc)) for e, n in base]


def make_env(device):
    """The recipes' env: ``training_scene_complete`` 400x300, fov 75, 8
    bounces, the RL variant."""
    from ..env.raytracer_env import RayTracerEnv
    from ..env.scenes import training_scene_complete
    scene, gl, pl = training_scene_complete(device=device)
    return RayTracerEnv(scene, image_width=400, image_height=300, fov=75,
                        max_bounces=8, global_lights=gl, point_lights=pl,
                        variant="rl")


def _device_name(dev):
    import torch
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def train_stages(tr, stages, ent=None):
    """``train_on_device`` a stage at a time, ``cfg.ent_coef`` set to the
    stage's value (or ``ent``) before each.  Returns the stage records."""
    recs = []
    for e, steps in stages:
        e = e if ent is None else ent
        tr.cfg = dataclasses.replace(tr.cfg, ent_coef=e)
        rec = tr.train_on_device(steps)
        recs.append({"ent_coef": e, **rec})
        log(f"  stage ent={e}: {rec['timesteps']} steps, "
            f"mean_ep_reward={rec['mean_episode_reward']:.3f}, "
            f"{rec['wall_seconds']:.1f}s")
    return recs


def cmd_ppo_sweep(args):
    from ..agents.adaptive import AdaptiveRewardRayTracerEnv
    from ..agents.ppo import PPOConfig, PPOTrainer
    from ..compare.workbench import evaluate_policy
    from ..core.device import resolve_device

    dev = resolve_device(args.device)
    log(f"device: {_device_name(dev)}")
    envs = {"base": make_env(dev)}
    envs["shaped"] = AdaptiveRewardRayTracerEnv(envs["base"],
                                                light_ids=(99, 100))
    stages = sweep_stages(args.scale, args.quick, args.round2)
    candidates = SWEEP_CANDIDATES["round2" if args.round2 else "round1"]
    n_eval = args.eval_episodes
    # Exact hit counting by sphere identity (compare/workbench.py).
    rnd = evaluate_policy(envs["base"], None, episodes=n_eval, seed=1)
    log(f"random: hit_rate={rnd['light_hit_rate']:.4f} "
        f"avg_reward={rnd['avg_reward']:.3f}")
    OUT.mkdir(parents=True, exist_ok=True)
    sweep, best = {}, None
    for name, cand in candidates.items():
        log(f"=== {name} ===")
        t0 = time.perf_counter()
        cfg = PPOConfig(hidden=cand.get("hidden", (64, 64)),
                        batch_envs=cand.get("batch_envs", 256))
        tr = PPOTrainer(envs[cand["env"]], cfg, seed=0)
        recs = train_stages(tr, stages,
                            ent=None if cand["anneal"] else cand["ent"])
        wall = time.perf_counter() - t0
        ev = evaluate_policy(envs["base"], tr.predict, episodes=n_eval,
                             seed=1)
        z = hit_z(ev["light_hit_rate"], n_eval, rnd["light_hit_rate"],
                  n_eval)
        log(f"  eval: hit_rate={ev['light_hit_rate']:.4f} "
            f"(random {rnd['light_hit_rate']:.4f}, z={z:+.2f}) "
            f"avg_reward={ev['avg_reward']:.3f} wall={wall:.1f}s")
        sweep[name] = {"timesteps": sum(r["timesteps"] for r in recs),
                       "wall_seconds": wall, "eval": ev,
                       "hit_z_vs_random": z,
                       "stages": [{"ent_coef": r["ent_coef"], "steps": s}
                                  for r, (_, s) in zip(recs, stages)],
                       "shaped": cand["env"] == "shaped",
                       "backend": recs[-1]["backend"],
                       "device": recs[-1]["device"]}
        if best is None or z > sweep[best]["hit_z_vs_random"]:
            best = name
            tr.save(OUT / "ppo_best.npz")
    log(f"best: {best} (z={sweep[best]['hit_z_vs_random']:+.2f})")
    out = {"sweep": sweep, "best": best, "random": rnd,
           "eval_episodes": n_eval,
           "recipe": "RL/train_raytracer_optimized.py:146-250 3-stage "
                     "entropy annealing on train_on_device chunks"}
    with open(OUT / "ppo_sweep.json", "w") as f:
        json.dump(out, f, indent=1, default=float)
    log(f"wrote {OUT / 'ppo_sweep.json'} and {OUT / 'ppo_best.npz'} "
        "(ship with ppo-ship once a winner clears z>=3)")
    return out


def cmd_ppo_ship(args, stages=None, eval_episodes=None,
                 cpu_probe_steps=None):
    """``ppo-ship``; ``stages``, ``eval_episodes`` and
    ``cpu_probe_steps`` default to the script's ``SHIP_STAGES``,
    ``SHIP_EVAL_EPISODES`` and ``CPU_PROBE_STEPS`` (the CLI takes no
    option for them, as the script takes none)."""
    import torch

    from ..agents.ppo import PPOConfig, PPOTrainer
    from ..compare.workbench import compare_rl_vs_random
    from ..core.device import resolve_device

    stages = SHIP_STAGES if stages is None else stages
    episodes = SHIP_EVAL_EPISODES if eval_episodes is None \
        else eval_episodes
    probe_steps = CPU_PROBE_STEPS if cpu_probe_steps is None \
        else cpu_probe_steps
    dev = resolve_device(args.device)
    log(f"device: {_device_name(dev)}")
    env = make_env(dev)
    tr = PPOTrainer(env, PPOConfig(hidden=SHIP_HIDDEN,
                                   batch_envs=SHIP_BATCH), seed=0)
    t0 = time.perf_counter()
    recs = train_stages(tr, stages)
    wall = time.perf_counter() - t0
    total = sum(r["timesteps"] for r in recs)
    OUT.mkdir(parents=True, exist_ok=True)
    tr.save(OUT / "ppo_raytracer.npz")
    bench = compare_rl_vs_random(env, tr.predict,
                                 episodes=episodes)
    z = hit_z(bench["rl"]["light_hit_rate"], episodes,
              bench["random"]["light_hit_rate"], episodes)
    bench["light_hit_z"] = z
    with open(OUT / "ppo_raytracer_benchmark.json", "w") as f:
        json.dump(bench, f, indent=2, default=float)
    log(f"hit_rate rl={bench['rl']['light_hit_rate']:.4f} "
        f"random={bench['random']['light_hit_rate']:.4f} z={z:+.2f}")

    # The matched configuration on the CPU, probe_steps steps.
    rec = PPOTrainer(make_env(torch.device("cpu")),
                     PPOConfig(hidden=SHIP_HIDDEN, batch_envs=SHIP_BATCH,
                               ent_coef=0.1),
                     seed=0).train_on_device(probe_steps)
    cpu = {k: rec[k] for k in ("backend", "wall_seconds", "timesteps")}
    # Steady state from the stages after the first (the first pays the
    # kernels' first launches).
    ss = recs[1:] or recs
    ss_steps = sum(r["timesteps"] for r in ss)
    ss_wall = sum(r["wall_seconds"] for r in ss)
    report = {
        "config": {
            "recipe": "3-stage entropy annealing 0.1/0.03/0.01 "
                      "(RL/train_raytracer_optimized.py:146-250 pattern) "
                      "on train_on_device chunks",
            "hidden": list(SHIP_HIDDEN), "batch_envs": SHIP_BATCH,
            "stages": [{k: r[k] for k in ("ent_coef", "timesteps",
                                          "wall_seconds",
                                          "mean_episode_reward")}
                       for r in recs],
            "seed": 0,
            "env": "training_scene_complete 400x300 fov75 mb8 rl",
        },
        "card": {
            "device": _device_name(dev), "wall_seconds": wall,
            "timesteps": total,
            "dispatches": sum(r["dispatches"] for r in recs),
            "steps_per_sec": total / wall, "eval": bench["rl"],
            "light_hit_z_vs_random": z,
        },
        "cpu_probe_100k_steps": {**cpu, "steps": probe_steps},
        "card_100k_steady_state_seconds":
            100_000 * ss_wall / max(ss_steps, 1),
        "card_steady_state_steps_per_sec": ss_steps / max(ss_wall, 1e-9),
    }
    with open(OUT / "ppo_card_train.json", "w") as f:
        json.dump(report, f, indent=1, default=float)
    log(f"wrote {OUT}/ppo_raytracer.npz, ppo_raytracer_benchmark.json, "
        "ppo_card_train.json")
    return report


def cmd_sac_ship(args):
    import torch

    from ..agents.sac import SACConfig, SACTrainer
    from ..compare.workbench import compare_rl_vs_random
    from ..core.device import resolve_device

    dev = resolve_device(args.device)
    log(f"device: {_device_name(dev)}")
    env = make_env(dev)
    tr = SACTrainer(env, SACConfig(), seed=0)
    t0 = time.perf_counter()
    rec = tr.train_on_device(args.timesteps, iters_per_dispatch=8)
    wall = time.perf_counter() - t0
    log(f"trained: {rec['total_steps']} active steps, "
        f"{rec['dispatches']} dispatches, {wall:.1f}s wall, "
        f"ep_rew={rec['mean_episode_reward']:.3f}")
    OUT.mkdir(parents=True, exist_ok=True)
    tr.save(OUT / "sac_raytracer_card.npz")
    bench = compare_rl_vs_random(env, tr.predict,
                                 episodes=args.eval_episodes)
    z = hit_z(bench["rl"]["light_hit_rate"], args.eval_episodes,
              bench["random"]["light_hit_rate"], args.eval_episodes)
    bench["light_hit_z"] = z
    with open(OUT / "sac_raytracer_card_benchmark.json", "w") as f:
        json.dump(bench, f, indent=2, default=float)
    log(f"hit_rate rl={bench['rl']['light_hit_rate']:.4f} "
        f"random={bench['random']['light_hit_rate']:.4f} z={z:+.2f}")
    probe = SACTrainer(make_env(torch.device("cpu")), SACConfig(),
                       seed=0).train_on_device(args.cpu_probe_steps,
                                               iters_per_dispatch=8)
    cpu = {k: probe[k] for k in ("backend", "wall_seconds", "total_steps")}
    report = {
        "config": {
            "recipe": "SACTrainer.train_on_device: device ring replay "
                      "buffer (validity-weighted slots); reference "
                      "hyperparameters RL/ray_tracer_rl_complete.py:108-126",
            "nominal_timesteps": args.timesteps, "seed": 0,
            "env": "training_scene_complete 400x300 fov75 mb8 rl",
        },
        "card": {**{k: rec[k] for k in ("total_steps", "buffer_capacity",
                                        "dispatches", "wall_seconds",
                                        "mean_episode_reward",
                                        "critic_loss", "backend",
                                        "device")},
                 "eval": bench["rl"], "light_hit_z_vs_random": z},
        "cpu_probe": {**cpu, "nominal_timesteps": args.cpu_probe_steps},
    }
    with open(OUT / "sac_card_train.json", "w") as f:
        json.dump(report, f, indent=1, default=float)
    log(f"wrote {OUT}/sac_raytracer_card.npz, "
        "sac_raytracer_card_benchmark.json, sac_card_train.json")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch.tools.ship_rl")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn):
        c = sub.add_parser(name)
        c.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the "
                            "plain PyTorch versions)")
        c.set_defaults(fn=fn)
        return c

    sw = command("ppo-sweep", cmd_ppo_sweep)
    sw.add_argument("--scale", type=float, default=1.0,
                    help="multiply stage timesteps")
    sw.add_argument("--quick", action="store_true")
    sw.add_argument("--round2", action="store_true")
    sw.add_argument("--eval-episodes", type=int, default=512)

    command("ppo-ship", cmd_ppo_ship)

    ss = command("sac-ship", cmd_sac_ship)
    ss.add_argument("--timesteps", type=int, default=400_000,
                    help="nominal env timesteps (the active-step count is "
                         "lower: episodes end in ~1-3 bounces)")
    ss.add_argument("--eval-episodes", type=int, default=2048)
    ss.add_argument("--cpu-probe-steps", type=int, default=40_000)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
