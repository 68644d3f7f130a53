"""EnhancedFBAgent: the *heuristic* (non-neural) FB stand-in of the 4-way
experiment (RL/output5.py:39-162).

A copy of ``raytracer_tpu/compare/heuristic_fb.py`` (numpy only; the port
imports nothing of the JAX package), the same draws from
``np.random.default_rng(seed)`` in the same order.

Faithful API and behavior: light-position memory (cap 20), successful
(θ, φ) direction memory (cap 10, last-5 averaging), exploration-rate decay
×0.95 after 5 hits (floor 0.1), strategies
``memory_guided`` / ``sun_seeking`` / ``exploration``, the 21-feature
observation with time signal and memory-usage features.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


class EnhancedFBAgent:
    def __init__(self, scene_id: str = "custom_scene", seed: int = 0):
        self.light_memory: list[np.ndarray] = []
        self.scene_memory = defaultdict(list)
        self.scene_id = scene_id
        self.learning_rate = 0.1
        self.exploration_rate = 0.3
        self.light_directions: list[tuple[float, float]] = []
        self.step_count = 0
        self.initial_bias = "balanced"
        self._rng = np.random.default_rng(seed)

    def create_observation(self, point, normal, ray_dir, material_vec,
                           object_id, bounce_count, accumulated_color,
                           scene_light_count):
        """21-feature observation (RL/output5.py:55-99).  ``material_vec``
        is (reflective, transparent, emitive, ior)."""
        return np.array([
            *point, *ray_dir, *normal, *material_vec,
            float(bounce_count) / 10.0,
            float(scene_light_count) / 10.0,
            float(object_id) / 100.0,
            accumulated_color[0] / 255.0,
            accumulated_color[1] / 255.0,
            accumulated_color[2] / 255.0,
            np.sin(self.step_count * 0.1),
            float(len(self.light_memory)) / 10.0,
        ], dtype=np.float32)

    def choose_direction(self, observation=None, scene_context="custom_scene"):
        self.step_count += 1
        rng = self._rng
        if self.light_memory and rng.random() < (1.0 - self.exploration_rate):
            if self.light_directions:
                avg_theta = float(np.mean([d[0] for d in
                                           self.light_directions[-5:]]))
                avg_phi = float(np.mean([d[1] for d in
                                         self.light_directions[-5:]]))
                theta = avg_theta + rng.normal(0, 0.1)
                phi = avg_phi + rng.normal(0, 0.2)
                strategy = "memory_guided"
            else:
                theta = rng.uniform(0, np.pi / 4)
                phi = rng.uniform(np.pi / 2, 3 * np.pi / 2)
                strategy = "sun_seeking"
        else:
            theta = rng.uniform(0, np.pi / 2)
            phi = rng.uniform(0, 2 * np.pi)
            strategy = "exploration"

        action = np.array([
            np.clip((theta / (np.pi / 2)) * 2 - 1, -1, 1),
            np.clip((phi / (2 * np.pi)) * 2 - 1, -1, 1),
        ])
        return action, {"strategy": strategy, "step": self.step_count}

    def record_light_hit(self, observation, direction):
        self.light_memory.append(np.asarray(observation)[:3])
        theta = float(np.arccos(np.clip(direction[2], -1, 1)))
        phi = float(np.arctan2(direction[1], direction[0]))
        self.light_directions.append((theta, phi))
        if len(self.light_memory) > 5:
            self.exploration_rate = max(0.1, self.exploration_rate * 0.95)
        if len(self.light_memory) > 20:
            self.light_memory.pop(0)
        if len(self.light_directions) > 10:
            self.light_directions.pop(0)

    def reset_for_new_rendering(self):
        self.step_count = 0
        self.light_directions = (self.light_directions[-5:]
                                 if self.light_directions else [])
