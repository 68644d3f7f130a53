"""Agent behaviour analytics and their figures.

Counterpart of ``raytracer_tpu/agents/analytics.py``:

* ``RewardLogger``                  — RL/train_raytracer_improved.py:20-49
* ``analyze_agent_behavior``        — :113-205 (hit frequency by object id,
                                      success by bounce count, termination
                                      reasons)
* ``canonical_pixel_policy_probe``  — the policy at 5 canonical pixels,
                                      :279-346
* ``collect_3d_paths``, ``plot_3d_paths`` — RL/train_raytracer_optimized.py:
                                      366-446
* ``compare_algorithms`` PPO vs SAC — :449-546
* ``advanced_analysis_png``         — the six-panel figure,
                                      RL/train_raytracer_improved.py:430-507

The figures are JAX's (panels, data, titles, sizes, dpi), drawn with
matplotlib imported inside each function: without it they raise
``ImportError`` (``utils/figures.py``).

A policy maps ``[R, 18]`` observation tensors to ``[R, 2]`` actions.
Random actions (``policy`` None) are uniform over the RL variant's box,
drawn from a ``torch.Generator`` seeded with ``seed``, which also draws
the reset pixels.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..env.raytracer_env import RayTracerEnv


class RewardLogger:
    """Episode reward logger (the SB3 callback's counterpart)."""

    def __init__(self):
        self.episode_rewards: list[float] = []
        self.episode_lengths: list[int] = []

    def log_batch(self, total_rewards, bounces):
        self.episode_rewards.extend(np.asarray(total_rewards, float).tolist())
        self.episode_lengths.extend(np.asarray(bounces, int).tolist())


def _actions(env, policy, obs, gen):
    if policy is not None:
        return torch.as_tensor(policy(obs), dtype=torch.float32,
                               device=env.device)
    u = torch.rand((obs.shape[0], 2), generator=gen, device=env.device)
    return u * torch.tensor([np.pi / 2, 2 * np.pi], dtype=torch.float32,
                            device=env.device)


def analyze_agent_behavior(env: RayTracerEnv, policy: Optional[Callable],
                           *, episodes: int = 200, seed: int = 0) -> dict:
    """Batched rollouts to behavioural statistics."""
    gen = torch.Generator(env.device).manual_seed(seed)
    state, obs = env.reset(episodes, generator=gen)
    first_hit = state.hit.cpu().numpy().copy()
    reasons = np.full(episodes, "", dtype=object)
    for _ in range(env.max_bounces + 2):
        prev_done = state.done.cpu().numpy()
        state, obs, r, term, info = env.step(
            state, _actions(env, policy, obs, gen))
        now_done = state.done.cpu().numpy() & ~prev_done
        trunc = info["truncated"].cpu().numpy()
        hit = state.hit.cpu().numpy()
        for i in np.nonzero(now_done)[0]:
            reasons[i] = ("max_bounces" if trunc[i]
                          else ("ray_escaped" if not hit[i] else "terminal"))
        if bool(state.done.all()):
            break
    ids = env.scene.id.cpu().numpy()
    final_ids = np.where(state.hit.cpu().numpy(),
                         ids[state.idx.cpu().numpy()], -1)
    rewards = state.total_reward.cpu().numpy()
    bounces = state.bounce.cpu().numpy()
    success = rewards > 0
    by_bounce: dict[int, list[bool]] = {}
    for b, s in zip(bounces, success):
        by_bounce.setdefault(int(b), []).append(bool(s))
    return {
        "episodes": episodes,
        "avg_reward": float(rewards.mean()),
        "hit_frequency_by_id": dict(Counter(int(i) for i in final_ids)),
        "success_rate_by_bounce": {b: float(np.mean(v))
                                   for b, v in sorted(by_bounce.items())},
        "termination_reasons": dict(Counter(reasons.tolist())),
        "first_hit_rate": float(first_hit.mean()),
    }


def canonical_pixel_policy_probe(env: RayTracerEnv, policy: Callable) -> dict:
    """The policy's actions at the 5 canonical pixels (centre and the four
    mid-quadrants), RL/train_raytracer_improved.py:279-346."""
    w, h = env.image_width, env.image_height
    pixels = [(w // 2, h // 2), (w // 4, h // 4), (3 * w // 4, h // 4),
              (w // 4, 3 * h // 4), (3 * w // 4, 3 * h // 4)]
    out = {}
    for px in pixels:
        state, obs = env.reset(1, pixel=px)
        a = torch.as_tensor(policy(obs)).reshape(-1, 2)
        out[str(px)] = {"theta": float(a[0, 0]), "phi": float(a[0, 1]),
                        "hit": bool(state.hit[0])}
    return out


def collect_3d_paths(env: RayTracerEnv, policy: Optional[Callable], *,
                     episodes: int = 16, seed: int = 0) -> list[np.ndarray]:
    """Each episode's chain of bounce points, ``[k, 3]`` for the episodes
    with at least one bounce (RL/train_raytracer_optimized.py:366-446)."""
    gen = torch.Generator(env.device).manual_seed(seed)
    state, obs = env.reset(episodes, generator=gen)
    paths = [[p] for p in state.point.cpu().numpy()]
    for _ in range(env.max_bounces + 1):
        prev_done = state.done.cpu().numpy()
        state, obs, r, term, info = env.step(
            state, _actions(env, policy, obs, gen))
        pts = state.point.cpu().numpy()
        hit = state.hit.cpu().numpy()
        for i in range(episodes):
            if not prev_done[i] and hit[i]:
                paths[i].append(pts[i])
        if bool(state.done.all()):
            break
    return [np.stack(p) for p in paths if len(p) > 1]


def plot_3d_paths(paths, scene, out_path):
    """The scene's spheres (radius < 50) and the bounce-point chains in
    3-D, x/z/y axes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    c = scene.centre.cpu().numpy()
    r = scene.radius.cpu().numpy()
    keep = r < 50
    ax.scatter(c[keep, 0], c[keep, 2], c[keep, 1],
               s=np.clip(r[keep] * 150, 10, 300),
               c=np.clip(scene.colour.cpu().numpy()[keep] / 255, 0, 1))
    for p in paths:
        ax.plot(p[:, 0], p[:, 2], p[:, 1], alpha=0.6, lw=1)
    ax.set_xlabel("x"); ax.set_ylabel("z"); ax.set_zlabel("y")
    plt.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def compare_algorithms(make_env, *, timesteps: int = 10_000, seed: int = 0,
                       out_dir: Optional[str] = None) -> dict:
    """PPO against SAC on ``make_env()`` (RL/train_raytracer_optimized.py:
    449-546)."""
    from ..compare.workbench import evaluate_policy
    from .ppo import PPOConfig, PPOTrainer
    from .sac import SACConfig, SACTrainer

    results = {}
    env = make_env()
    ppo = PPOTrainer(env, PPOConfig(batch_envs=128), seed=seed)
    ppo_out = ppo.train(timesteps)
    results["ppo"] = {**ppo_out,
                      "eval": evaluate_policy(env, ppo.predict,
                                              episodes=100, seed=seed)}
    sac = SACTrainer(env, SACConfig(batch_envs=128,
                                    learning_starts=min(1000, timesteps // 4)),
                     seed=seed)
    sac_out = sac.train(timesteps)
    results["sac"] = {**sac_out,
                      "eval": evaluate_policy(env, sac.predict,
                                              episodes=100, seed=seed)}
    results["winner"] = max(("ppo", "sac"),
                            key=lambda k: results[k]["eval"]["avg_reward"])
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(out_dir) / "algorithm_comparison.json", "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results


def advanced_analysis_png(behavior: dict, reward_history, out_path):
    """The six-panel analysis figure (RL/train_raytracer_improved.py:
    430-507): rewards, their moving average and histogram, and the
    behaviour's hit frequency, success by bounce and termination reasons
    as bars."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    ax = axes.ravel()
    rh = np.asarray(reward_history, float)
    ax[0].plot(rh); ax[0].set_title("episode rewards")
    if len(rh) > 10:
        w = max(1, len(rh) // 20)
        ax[1].plot(np.convolve(rh, np.ones(w) / w, "valid"))
    ax[1].set_title("moving average")
    ax[2].hist(rh, bins=30); ax[2].set_title("reward distribution")
    hf = behavior["hit_frequency_by_id"]
    ax[3].bar([str(k) for k in hf], list(hf.values()))
    ax[3].set_title("hit frequency by object id")
    sb = behavior["success_rate_by_bounce"]
    ax[4].bar([str(k) for k in sb], list(sb.values()))
    ax[4].set_title("success rate by bounce")
    tr = behavior["termination_reasons"]
    ax[5].bar([str(k) for k in tr], list(tr.values()))
    ax[5].set_title("termination reasons")
    plt.tight_layout()
    plt.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
