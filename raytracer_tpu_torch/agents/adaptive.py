"""Reward shaping and curriculum.

Counterpart of ``raytracer_tpu/agents/adaptive.py``: rebuilds of
``AdaptiveRewardRayTracerEnv`` (RL/train_raytracer_optimized.py:16-67),
``CurriculumCallback`` (:70-94) and the staged training flow
(``train_with_curriculum``, RL/train_raytracer_improved.py:208-276;
entropy annealing RL/train_raytracer_optimized.py:146-250).

The shaped env wraps the port's ``RayTracerEnv``: ``reset`` is the base
reset (the Whitted kernel on the card) and ``step`` the base step (the
nearest-hit kernel a level), with the shaping terms computed from the
pre-move state on top.  It keeps the JAX package's behaviour where the
reference's would differ:

* ``sc.id[idx]`` and ``sc.reflective[idx]`` gather on every lane; only
  the pre-move ``hit`` masks them afterwards (a miss lane's index is in
  range, as the base env's observation relies on).
* The counters advance wherever the pre-move ``hit`` is set, finished
  lanes included: a finished lane keeps its frozen ``hit`` and ``idx``, so
  a lane that ended on a light goes on counting.  Only the reward is
  zeroed there.
* The miss rewrite compares the float reward with ``== -0.1``.  The base
  RL env rewards a pre-move miss with ``-1.0`` (or ``0.0`` once done), so
  the rewrite never fires on it; it is kept as written.

``train_with_curriculum`` pops the caller's ``config`` inside the phase
loop, as JAX does: only the first phase gets it (with ``ent_coef``
replaced); later phases get ``config=None``, the trainer's defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..env.raytracer_env import EnvState, RayTracerEnv


@dataclasses.dataclass(frozen=True)
class AdaptiveState:
    """``EnvState`` with the shaping counters (``[B]`` int32 each)."""

    env: EnvState
    consecutive_light_hits: torch.Tensor
    total_light_hits: torch.Tensor

    # The trainers' rollouts read state.done and state.total_reward on
    # whichever env they drive.
    @property
    def done(self):
        return self.env.done

    @property
    def total_reward(self):
        return self.env.total_reward


class AdaptiveRewardRayTracerEnv:
    """Shaping on top of the batched env:

    * a miss's −0.1 becomes −0.5;
    * +2.0 on a light id, +0.5·streak beyond the first;
    * +0.3 when the surface is more than 0.5 reflective;
    * −0.1 when ``bounce < 2`` and the base reward is positive.

    Every other attribute is the wrapped env's."""

    def __init__(self, env: RayTracerEnv, light_ids=(99, 100)):
        self.env = env
        self.light_ids = tuple(light_ids)

    def reset(self, batch: int = 1, pixel=None, *,
              generator: Optional[torch.Generator] = None):
        state, obs = self.env.reset(batch, pixel, generator=generator)
        zi = torch.zeros((batch,), dtype=torch.int32, device=self.env.device)
        return AdaptiveState(env=state, consecutive_light_hits=zi,
                             total_light_hits=zi), obs

    def step(self, state: AdaptiveState, action):
        s = state.env
        sc = self.env.scene
        pre_hit = s.hit
        pre_idx = s.idx
        pre_bounce = s.bounce
        was_done = s.done

        nstate, obs, base_reward, terminated, info = self.env.step(s, action)

        lid = sc.id[pre_idx]
        is_light = torch.zeros_like(pre_hit)
        for l in self.light_ids:
            is_light = is_light | (lid == l)
        is_light = is_light & pre_hit

        streak = torch.where(is_light, state.consecutive_light_hits + 1, 0)
        light_bonus = torch.where(
            is_light, 2.0 + torch.where(streak > 1,
                                        0.5 * streak.to(torch.float32), 0.0),
            0.0)
        reflective_bonus = torch.where(
            pre_hit & (sc.reflective[pre_idx] > 0.5), 0.3, 0.0)
        short_path_penalty = torch.where(
            (pre_bounce < 2) & (base_reward > 0), -0.1, 0.0)
        base = torch.where(pre_hit, base_reward,
                           torch.where(base_reward == -0.1, -0.5,
                                       base_reward))
        reward = base + light_bonus + reflective_bonus + short_path_penalty
        reward = torch.where(was_done, 0.0, reward)

        new = AdaptiveState(env=nstate, consecutive_light_hits=streak,
                            total_light_hits=state.total_light_hits
                            + is_light.to(torch.int32))
        return new, obs, reward, terminated, info

    def __getattr__(self, name):
        # Only reached for names the wrapper lacks; "env" itself is looked
        # up before __init__ sets it when unpickling.
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)


@dataclasses.dataclass
class CurriculumSchedule:
    """Phase switching at cumulative step counts (10k → phase 2, +20k →
    phase 3), mirroring ``CurriculumCallback``."""

    phase1_steps: int = 10_000
    phase2_steps: int = 20_000

    def phase_for(self, steps: int) -> int:
        if steps < self.phase1_steps:
            return 1
        if steps < self.phase1_steps + self.phase2_steps:
            return 2
        return 3


def train_with_curriculum(make_env, trainer_cls, *, phases=(1, 2, 3),
                          steps_per_phase=(10_000, 20_000, 20_000),
                          ent_coefs=(0.1, 0.03, 0.01), seed: int = 0,
                          trainer_kwargs: Optional[dict] = None):
    """Staged training with parameter transfer between phases
    (``model2.set_parameters(model1.get_parameters())``,
    RL/train_raytracer_improved.py:258-274) and entropy annealing
    0.1 → 0.03 → 0.01 (RL/train_raytracer_optimized.py:146-250).
    Returns ``(last trainer, [each phase's train() result])``."""
    trainer_kwargs = dict(trainer_kwargs or {})
    prev_params = None
    trainer = None
    results = []
    for phase, steps, ent in zip(phases, steps_per_phase, ent_coefs):
        env = make_env(phase)
        cfg = trainer_kwargs.pop("config", None)
        if cfg is not None and hasattr(cfg, "ent_coef"):
            cfg = dataclasses.replace(cfg, ent_coef=ent)
        trainer = trainer_cls(env, config=cfg, seed=seed + phase,
                              **trainer_kwargs)
        if prev_params is not None:
            trainer.set_parameters(prev_params)
        results.append(trainer.train(steps))
        prev_params = trainer.get_parameters()
    return trainer, results
