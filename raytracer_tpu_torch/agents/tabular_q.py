"""Tabular Q-learning (RL/simple_train.py:61-245), vectorised over a batch
of parallel episodes.

Counterpart of ``raytracer_tpu/agents/tabular_q.py``: the Q table and the
ε-greedy draws are numpy, from ``np.random.default_rng(seed)`` as in the
JAX package; the env runs on its device, its reset pixels drawn from a
``torch.Generator`` seeded with ``seed`` (JAX draws them from its key).

Preserved semantics: 8×8 (θ, φ) action bins via ``np.linspace`` bin edges
(``discretize_action``/``continuous_from_discrete`` round-trip included),
4³ position bins over [-5, 5], ε-greedy TD updates (α=0.1, γ=0.95,
ε 1.0→0.01 decay 0.995/episode), Q-table init ``randn * 0.01``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..env.raytracer_env import RayTracerEnv


def discretize_action(action_continuous, num_bins: int = 8) -> int:
    """RL/simple_train.py:61-71 (np.digitize over linspace bins)."""
    theta_bins = np.linspace(0, np.pi / 2, num_bins)
    phi_bins = np.linspace(0, 2 * np.pi, num_bins)
    theta_d = np.digitize(action_continuous[0], theta_bins) - 1
    phi_d = np.digitize(action_continuous[1], phi_bins) - 1
    return int(theta_d * num_bins + phi_d)


def continuous_from_discrete(action_idx, num_bins: int = 8) -> np.ndarray:
    """RL/simple_train.py:74-85."""
    theta_bins = np.linspace(0, np.pi / 2, num_bins)
    phi_bins = np.linspace(0, 2 * np.pi, num_bins)
    return np.array([theta_bins[action_idx // num_bins],
                     phi_bins[action_idx % num_bins]], np.float32)


def _state_idx(obs: np.ndarray, state_bins: int = 4) -> np.ndarray:
    """Coarse position binning (RL/simple_train.py:162-166): first three
    obs entries mapped through (x+5)·bins/10, clipped."""
    idx = ((obs[..., :3] + 5.0) * state_bins / 10.0).astype(np.int64)
    return np.clip(idx, 0, state_bins - 1)


@dataclasses.dataclass
class TabularQConfig:
    num_bins: int = 8
    state_bins: int = 4
    num_episodes: int = 1000
    max_steps: int = 10
    learning_rate: float = 0.1
    discount: float = 0.95
    epsilon: float = 1.0
    epsilon_min: float = 0.01
    epsilon_decay: float = 0.995
    batch_envs: int = 64


class TabularQTrainer:
    def __init__(self, env: RayTracerEnv,
                 config: Optional[TabularQConfig] = None, seed: int = 0):
        self.env = env
        self.cfg = config or TabularQConfig()
        c = self.cfg
        self.rng = np.random.default_rng(seed)
        self.q = self.rng.standard_normal(
            (c.state_bins,) * 3 + (c.num_bins ** 2,)) * 0.01
        self.generator = torch.Generator(env.device).manual_seed(seed)
        self.rewards_history: list[float] = []
        self.epsilon = c.epsilon

    def train(self, num_episodes: Optional[int] = None) -> list[float]:
        c = self.cfg
        B = c.batch_envs
        episodes = num_episodes or c.num_episodes
        rounds = max(1, episodes // B)
        for _ in range(rounds):
            state, obs = self.env.reset(B, generator=self.generator)
            obs = obs.cpu().numpy()
            sidx = _state_idx(obs, c.state_bins)
            total = np.zeros(B)
            for step in range(c.max_steps):
                done = state.done.cpu().numpy()
                if done.all():
                    break
                explore = self.rng.random(B) < self.epsilon
                greedy = np.argmax(
                    self.q[sidx[:, 0], sidx[:, 1], sidx[:, 2]], axis=-1)
                rand = self.rng.integers(0, c.num_bins ** 2, B)
                aidx = np.where(explore, rand, greedy)
                actions = np.stack([continuous_from_discrete(int(a), c.num_bins)
                                    for a in aidx])
                state, nobs, r, term, _ = self.env.step(
                    state, np.asarray(actions, np.float32))
                nobs = nobs.cpu().numpy()
                r = r.cpu().numpy()
                nsidx = _state_idx(nobs, c.state_bins)
                active = ~done
                # TD update on active lanes.
                best_next = np.max(
                    self.q[nsidx[:, 0], nsidx[:, 1], nsidx[:, 2]], axis=-1)
                td_target = r + c.discount * best_next
                cur = self.q[sidx[:, 0], sidx[:, 1], sidx[:, 2], aidx]
                upd = cur + c.learning_rate * (td_target - cur)
                self.q[sidx[active, 0], sidx[active, 1], sidx[active, 2],
                       aidx[active]] = upd[active]
                total += r * active
                sidx = nsidx
            self.epsilon = max(c.epsilon_min,
                               self.epsilon * (c.epsilon_decay ** B))
            self.rewards_history.extend(total.tolist())
        return self.rewards_history

    def test(self, num_episodes: int = 10) -> float:
        c = self.cfg
        state, obs = self.env.reset(num_episodes, generator=self.generator)
        obs = obs.cpu().numpy()
        sidx = _state_idx(obs, c.state_bins)
        total = np.zeros(num_episodes)
        for _ in range(c.max_steps):
            done = state.done.cpu().numpy()
            if done.all():
                break
            aidx = np.argmax(self.q[sidx[:, 0], sidx[:, 1], sidx[:, 2]],
                             axis=-1)
            actions = np.stack([continuous_from_discrete(int(a), c.num_bins)
                                for a in aidx])
            state, obs, r, term, _ = self.env.step(
                state, np.asarray(actions, np.float32))
            obs = obs.cpu().numpy()
            total += r.cpu().numpy() * ~done
            sidx = _state_idx(obs, c.state_bins)
        return float(total.mean())
