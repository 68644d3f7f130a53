"""Gymnasium adapter over the batched env: one episode, one host round trip
a step, for SB3-style consumers (the reference trains stable-baselines3
against its Python env, RL/train_raytracer.py:123).

Counterpart of ``raytracer_tpu/env/gym_adapter.py``.  ``gymnasium`` is
optional: without it the class is a plain object with the same methods.
Reset pixels come from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
    _GYM = True
except ImportError:                                     # pragma: no cover
    _GYM = False
    gym = object

from .raytracer_env import OBS_DIM, RayTracerEnv  # noqa: F401 (re-exported)


class GymRayTracerEnv(gym.Env if _GYM else object):
    """Single-episode Gymnasium wrapper (spaces as RL/ray_tracer_env.py:
    89-119 for variant "rl" and the [-1, 1]² box of FB/ray_tracer_env.py:
    89-95 for variant "fb")."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

    def __init__(self, env: RayTracerEnv, seed: int = 0, render_mode=None):
        super().__init__()
        self.env = env
        self.render_mode = render_mode
        self._gen = torch.Generator(env.device).manual_seed(seed)
        self._state = None
        if not _GYM:
            return
        mb = float(env.max_bounces)
        self.observation_space = spaces.Box(
            low=np.array([-np.inf] * 3 + [-1] * 6 + [0, 0, 0, 1]
                         + [0] * 3 + [0, 0], dtype=np.float32),
            high=np.array([np.inf] * 3 + [1] * 6 + [1, 1, 1, 3]
                          + [1] * 3 + [mb, mb], dtype=np.float32),
            dtype=np.float32)
        if env.variant == "rl":
            self.action_space = spaces.Box(
                low=np.array([0.0, 0.0], dtype=np.float32),
                high=np.array([np.pi / 2, 2 * np.pi], dtype=np.float32),
                dtype=np.float32)
        else:
            self.action_space = spaces.Box(low=-1.0, high=1.0, shape=(2,),
                                           dtype=np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._gen.manual_seed(seed)
        pixel = None
        if options is not None and "pixel" in options:
            pixel = np.asarray(options["pixel"], np.int64)[None, :]
        self._state, obs = self.env.reset(1, pixel=pixel,
                                          generator=self._gen)
        info = {"pixel": tuple(int(v) for v in self._state.pixel[0])}
        return obs[0].cpu().numpy().astype(np.float32), info

    def step(self, action):
        a = np.asarray(action, np.float32)[None, :]
        self._state, obs, reward, terminated, info = self.env.step(
            self._state, a)
        return (obs[0].cpu().numpy().astype(np.float32), float(reward[0]),
                bool(terminated[0]), bool(info["truncated"][0]),
                {"bounce_count": int(info["bounce"][0]),
                 "total_reward": float(info["total_reward"][0])})

    def render(self):
        if self.render_mode == "rgb_array" and self._state is not None:
            img = np.zeros((self.env.image_height, self.env.image_width, 3),
                           np.uint8)
            px, py = (int(v) for v in self._state.pixel[0])
            img[py, px] = np.clip(self._state.acc_colour[0].cpu().numpy(),
                                  0, 255).astype(np.uint8)
            return img
        return None
