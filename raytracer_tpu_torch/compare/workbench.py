"""Trained-model workbench (RL/use_trained_model.py): model discovery
across path conventions (:53-74), batched N-episode evaluation (:77-237),
RL against random actions with the rays-per-light-hit efficiency
(:604-807) and the orthographic debug renderer (:879-962).

Counterpart of ``raytracer_tpu/compare/workbench.py``, with its
matplotlib figures ``plot_scene_3d`` (:809-877) and ``performance_plots``
(:513-602), matplotlib imported inside each (``utils/figures.py``).
A policy maps ``[R, 18]`` observation tensors on the env's device to
``[R, 2]`` actions (a tensor or an array).  Randomness comes in as inputs:
``evaluate_policy`` takes its reset pixels and, for the random policy, its
actions ``[max_bounces + 2, episodes, 2]``, or draws them from a
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..core import cuda_intersect
from ..env.raytracer_env import RayTracerEnv
from ..scene.types import Scene

MODEL_PATH_CANDIDATES = [
    "{name}", "{name}.pkl", "{name}.npz", "{name}.zip", "models/{name}",
    "models/{name}.pkl", "models/{name}.zip", "./checkpoints/{name}.pkl",
]


def load_policy(path, env: RayTracerEnv, algo: Optional[str] = None):
    """A trainer with the checkpoint's weights, ready to ``predict``: the
    trainers' ``.npz`` or pickle files, or an SB3 ``.zip`` (its algorithm
    sniffed from the state dict's keys when ``algo`` is None)."""
    from ..agents.ppo import PPOTrainer
    from ..agents.sac import SACTrainer

    path = str(path)
    if path.endswith(".zip"):
        if algo is None:
            from ..utils.sb3_import import load_sb3_zip
            keys = load_sb3_zip(path)["policy"]
            algo = ("sac" if any(k.startswith("actor.") for k in keys)
                    else "ppo")
        tr = (SACTrainer if algo == "sac" else PPOTrainer)(env)
        tr.load_sb3(path)
        return tr
    tr = (SACTrainer if algo == "sac" else PPOTrainer)(env)
    tr.load(path)
    return tr


def check_model_exists(name: str, base: str = ".") -> Optional[Path]:
    """Model discovery across the reference's path conventions (:53-74)."""
    for pattern in MODEL_PATH_CANDIDATES:
        p = Path(base) / pattern.format(name=name)
        if p.exists():
            return p
    return None


def random_actions(env: RayTracerEnv, episodes: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """``[max_bounces + 2, episodes, 2]`` uniform actions over the
    variant's box."""
    u = torch.rand((env.max_bounces + 2, episodes, 2), generator=generator,
                   device=env.device)
    if env.variant == "rl":
        hi = torch.tensor([math.pi / 2, 2 * math.pi], device=env.device)
        return u * hi
    return u * 2.0 - 1.0


def evaluate_policy(env: RayTracerEnv, policy: Optional[Callable], *,
                    episodes: int = 50, seed: int = 0, pixel=None,
                    actions: Optional[torch.Tensor] = None) -> dict:
    """Batched ``episodes``-episode evaluation: rewards, light hits,
    best and worst episodes.  ``policy`` None takes random actions.

    Light hits are counted by sphere identity: a step whose ray lands on an
    emissive sphere (RL variant) or on the sun sphere (FB variant)."""
    gen = torch.Generator(env.device).manual_seed(seed)
    state, obs = env.reset(episodes, pixel=pixel, generator=gen)
    if policy is None and actions is None:
        actions = random_actions(env, episodes, gen)
    em = env.scene.emitive > 0
    ids = env.scene.id
    light_hit = torch.zeros((episodes,), dtype=torch.bool, device=env.device)
    for t in range(env.max_bounces + 2):
        a = actions[t] if policy is None else torch.as_tensor(
            policy(obs), dtype=torch.float32, device=env.device)
        prev_done = state.done
        state, obs, _, _, _ = env.step(state, a)
        landed = ((ids[state.idx] == env.sun_id) if env.variant == "fb"
                  else em[state.idx])
        light_hit |= landed & state.hit & ~prev_done
        if bool(state.done.all()):
            break
    rewards = state.total_reward.cpu().numpy()
    bounces = state.bounce.cpu().numpy()
    light_hit = light_hit.cpu().numpy()
    return {
        "episodes": episodes,
        "avg_reward": float(rewards.mean()),
        "std_reward": float(rewards.std()),
        "best_episode": {"index": int(rewards.argmax()),
                         "reward": float(rewards.max()),
                         "bounces": int(bounces[rewards.argmax()])},
        "worst_episode": {"index": int(rewards.argmin()),
                          "reward": float(rewards.min())},
        "avg_bounces": float(bounces.mean()),
        "light_hit_rate": float(light_hit.mean()),
    }


def compare_rl_vs_random(env: RayTracerEnv, policy: Callable, *,
                         episodes: int = 100, seed: int = 0,
                         out_path: Optional[str] = None) -> dict:
    """The policy against random actions (seed + 1), with the
    rays-per-light-hit efficiency (:604-807)."""
    rl = evaluate_policy(env, policy, episodes=episodes, seed=seed)
    rnd = evaluate_policy(env, None, episodes=episodes, seed=seed + 1)

    def efficiency(stats):
        hits = stats["light_hit_rate"] * stats["episodes"]
        rays = stats["avg_bounces"] * stats["episodes"]
        return rays / hits if hits else float("inf")

    result = {
        "rl": rl, "random": rnd,
        "reward_improvement": rl["avg_reward"] - rnd["avg_reward"],
        "rays_per_light_hit": {"rl": efficiency(rl),
                               "random": efficiency(rnd)},
    }
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def orthographic_render(scene: Scene, *, width: int = 200, height: int = 150,
                        span: float = 12.0, z_start: float = 5.0,
                        background=(20, 20, 30)) -> np.ndarray:
    """Parallel -z rays on a plane, the flat colour of the first hit (the
    nearest-hit kernel on the card): ``[H, W, 3]`` uint8."""
    xs = np.linspace(-span / 2, span / 2, width)
    ys = np.linspace(span / 2 * height / width, -span / 2 * height / width,
                     height)
    X, Y = np.meshgrid(xs, ys)
    dev = scene.device
    o = torch.from_numpy(np.stack([X, Y, np.full_like(X, z_start)], -1)
                         .reshape(-1, 3)).to(torch.float32).to(dev)
    d = torch.tensor([0.0, 0.0, -1.0], device=dev).expand_as(o).contiguous()
    table = cuda_intersect.sphere_table(scene)
    _, idx, found = cuda_intersect.nearest_hit(o, d, None, table)
    bg = torch.tensor(background, dtype=torch.float32, device=dev)
    col = torch.where(found[:, None], scene.colour[idx], bg[None])
    return col.cpu().numpy().reshape(height, width, 3).astype(np.uint8)


def plot_scene_3d(scene: Scene, out_path: str) -> None:
    """3-D scene scatter (:809-877): spheres under radius 50 by colour,
    lights edged gold."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    c = scene.centre.cpu().numpy()
    r = scene.radius.cpu().numpy()
    col = np.clip(scene.colour.cpu().numpy() / 255.0, 0, 1)
    emis = scene.emitive.cpu().numpy() > 0
    keep = r < 50     # skip the giant walls for readability
    ax.scatter(c[keep, 0], c[keep, 2], c[keep, 1],
               s=np.clip(r[keep] * 200, 10, 400), c=col[keep],
               edgecolors=np.where(emis[keep], "gold", "none"))
    ax.set_xlabel("x"); ax.set_ylabel("z"); ax.set_zlabel("y")
    plt.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def performance_plots(history: dict, out_path: str) -> None:
    """Six-panel performance dashboard (:513-602): the first six non-empty
    series of ``history``, a ``*_hist`` one as a histogram, others as a
    line with its moving average past 20 points."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    panels = [(k, v) for k, v in history.items() if len(v)][:6]
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    for ax, (name, series) in zip(axes.ravel(), panels):
        series = np.asarray(series, dtype=float)
        if name.endswith("_hist"):
            ax.hist(series, bins=30)
        else:
            ax.plot(series)
            if len(series) > 20:
                w = max(1, len(series) // 20)
                ma = np.convolve(series, np.ones(w) / w, mode="valid")
                ax.plot(np.arange(len(ma)) + w - 1, ma, lw=2)
        ax.set_title(name)
    for ax in axes.ravel()[len(panels):]:
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
