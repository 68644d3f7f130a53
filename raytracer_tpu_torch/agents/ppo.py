"""PPO on the batched ray-tracing env.

Counterpart of ``raytracer_tpu/agents/ppo.py`` (SB3 PPO's hyperparameters:
lr 3e-4, γ 0.99, clip 0.2, GAE λ 0.95, RL/train_raytracer.py:123-153).
A whole batch of episodes advances a step at a time, and the update takes
the full masked ``T x B`` rollout grid (``T = max_bounces + 2``).

The optimiser is optax's ``chain(clip_by_global_norm(0.5), adam(lr))``:
the gradients scale by ``max_norm / norm`` only when ``norm >= max_norm``
(``clip_by_global_norm``), then ``torch.optim.Adam`` with optax's settings
(β 0.9/0.999, ε 1e-8 outside the root).

Randomness comes in as inputs: a rollout takes its reset pixels ``[B, 2]``
and its action noise ``[T, B, 2]``, an update its per-epoch permutations
``[epochs, N]`` (``rollout_draws`` and ``update_draws`` draw them from the
trainer's ``torch.Generator``; JAX draws them from its keys).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pickle
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..env.raytracer_env import RayTracerEnv
from .networks import (PPOActorCritic, flatten_tree, flax_to_state,
                       hidden_of, initialise, load_state, nest_flat,
                       state_to_flax)

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
HALF_LOG_2PIE = 0.5 * math.log(2 * math.pi * math.e)


@dataclasses.dataclass
class PPOConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    batch_envs: int = 256
    epochs: int = 4
    minibatches: int = 4
    max_grad_norm: float = 0.5
    hidden: Tuple[int, ...] = (64, 64)
    # SB3-style TensorBoard events under {tensorboard_log}/PPO_{N}/.
    tensorboard_log: Optional[str] = None


def action_bounds(variant: str, device):
    """``(low, high)`` of the env's action box."""
    if variant == "rl":
        lo, hi = (0.0, 0.0), (math.pi / 2, 2 * math.pi)
    else:
        lo, hi = (-1.0, -1.0), (1.0, 1.0)
    return (torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device))


def gaussian_logp(u, mean, log_std):
    """Diagonal Gaussian log-density, summed over the action axis."""
    z = (u - mean) / torch.exp(log_std)
    terms = -0.5 * z ** 2 - log_std - HALF_LOG_2PI
    return terms[..., 0] + terms[..., 1]


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the parameters' ``.grad``:
    ``g / norm * max_norm`` where ``norm >= max_norm``, unchanged below.
    Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    below = norm < max_norm
    for g in grads:
        g.copy_(torch.where(below, g, g / norm * max_norm))
    return norm


def gae(rewards, values, actives, last_value, gamma: float, lam: float):
    """The JAX package's masked GAE scan over ``[T, B]`` (its last step
    bootstraps nothing: the carried activity starts at 0)."""
    T = rewards.shape[0]
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    active_next = torch.zeros_like(last_value)
    gl = gamma * lam
    advs = [None] * T
    for t in range(T - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * active_next - values[t]
        adv = (delta + gl * adv_next * active_next) * actives[t]
        advs[t] = adv
        adv_next, v_next, active_next = adv, values[t], actives[t]
    return torch.stack(advs)


class PPOTrainer:
    def __init__(self, env: RayTracerEnv, config: Optional[PPOConfig] = None,
                 seed: int = 0):
        self.env = env
        self.device = env.device
        self.cfg = config or PPOConfig()
        self._seed = seed
        self._build(self.cfg.hidden)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.low, self.high = action_bounds(env.variant, self.device)
        self.episode_rewards: list[float] = []

    def _build(self, hidden):
        self.net = initialise(PPOActorCritic(hidden=tuple(hidden)),
                              torch.Generator().manual_seed(self._seed))
        self.net.to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(),
                                    lr=self.cfg.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)

    @property
    def steps_per_iter(self) -> int:
        return (self.env.max_bounces + 2) * self.cfg.batch_envs

    # -- draws -------------------------------------------------------------
    def rollout_draws(self):
        """``(pixel [B, 2], noise [T, B, 2])`` from the trainer's
        generator."""
        B, T = self.cfg.batch_envs, self.env.max_bounces + 2
        pixel = self.env.draw_pixels(B, self.generator)
        noise = torch.randn((T, B, 2), generator=self.generator,
                            device=self.device)
        return pixel, noise

    def update_draws(self):
        """``[epochs, N]`` permutations of the flattened rollout."""
        N = self.steps_per_iter
        return torch.stack([torch.randperm(N, generator=self.generator,
                                           device=self.device)
                            for _ in range(self.cfg.epochs)])

    # -- rollout (JAX ppo.py:72-103) ----------------------------------------
    @torch.no_grad()
    def rollout(self, pixel, noise):
        """``T`` batched env steps under the current policy.  Returns
        ``(recs, last_value, total_reward)``, ``recs`` the ``[T, B, ...]``
        tensors ``(obs, u, logp, value, reward, active)``; ``u`` is the
        unclipped Gaussian sample, clipped to the action box for the env."""
        env, net = self.env, self.net
        B = pixel.shape[0]
        state, obs = env.reset(B, pixel=pixel)
        recs = []
        for t in range(noise.shape[0]):
            mean, log_std, value = net(obs)
            u = mean + torch.exp(log_std) * noise[t]
            logp = gaussian_logp(u, mean, log_std)
            a_env = torch.clamp(u, self.low, self.high)
            active = ~state.done
            state, nobs, r, _, _ = env.step(state, a_env)
            recs.append((obs, u, logp, value, r, active))
            obs = nobs
        last_value = net(obs)[2]
        recs = tuple(torch.stack(x) for x in zip(*recs))
        return recs, last_value, state.total_reward

    # -- update (JAX ppo.py:109-181) ----------------------------------------
    def loss(self, batch):
        """The clipped surrogate with the masked weights: ``(loss, (pg,
        vf))`` on a minibatch ``(obs, actions, logp_old, adv, ret,
        mask)``."""
        cfg = self.cfg
        obs, actions, logp_old, adv, ret, mask = batch
        mean, log_std, value = self.net(obs)
        logp = gaussian_logp(actions, mean, log_std)
        ratio = torch.exp(logp - logp_old)
        w = mask / torch.clamp_min(mask.sum(), 1.0)
        pg = -torch.sum(w * torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv))
        vf = torch.sum(w * (value - ret) ** 2)
        ent = torch.sum(log_std + HALF_LOG_2PIE)
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent, (pg, vf)

    def prepare(self, recs, last_value):
        """GAE, returns and the normalised advantages of a rollout, flat:
        the update's data ``(obs, actions, logp, adv, ret, mask)``."""
        cfg = self.cfg
        obs, actions, logp, values, rewards, actives = recs
        actives = actives.to(rewards.dtype)
        adv = gae(rewards, values, actives, last_value, cfg.gamma,
                  cfg.gae_lambda)
        ret = adv + values

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        mask = flat(actives)
        adv_f = flat(adv)
        n = torch.clamp_min(mask.sum(), 1.0)
        adv_n = ((adv_f - (adv_f * mask).sum() / n)
                 / (torch.sqrt(((adv_f ** 2) * mask).sum() / n) + 1e-8))
        return (flat(obs), flat(actions), flat(logp), adv_n * mask,
                flat(ret), mask)

    def step_minibatch(self, mbatch) -> float:
        """One clipped-norm Adam step on a minibatch; the loss."""
        self.opt.zero_grad(set_to_none=True)
        loss, _ = self.loss(mbatch)
        loss.backward()
        clip_by_global_norm_(list(self.net.parameters()),
                             self.cfg.max_grad_norm)
        self.opt.step()
        return loss.detach()

    def update(self, recs, last_value, perms) -> float:
        """``epochs`` passes of ``minibatches`` steps over the rollout, in
        the order of ``perms [epochs, N]``.  Returns the mean loss."""
        cfg = self.cfg
        data = self.prepare(recs, last_value)
        N = data[0].shape[0]
        mb = N // cfg.minibatches
        epoch_losses = []
        for e in range(cfg.epochs):
            losses = []
            for i in range(cfg.minibatches):
                idx = perms[e, i * mb:(i + 1) * mb]
                losses.append(self.step_minibatch(tuple(x[idx]
                                                        for x in data)))
            epoch_losses.append(torch.stack(losses).mean())
        return float(torch.stack(epoch_losses).mean())

    def iterate(self) -> Tuple[float, float]:
        """One rollout and update on fresh draws: ``(loss, mean episode
        reward)``."""
        recs, last_value, ep_rewards = self.rollout(*self.rollout_draws())
        loss = self.update(recs, last_value, self.update_draws())
        return loss, float(ep_rewards.mean())

    # -- training loops ----------------------------------------------------
    def train(self, total_timesteps: int, log_every: int = 10) -> dict:
        iters = max(1, total_timesteps // self.steps_per_iter)
        losses = []
        tb = None
        if self.cfg.tensorboard_log:
            from ..utils.tb import SummaryWriter, next_run_dir
            tb = SummaryWriter(next_run_dir(self.cfg.tensorboard_log, "PPO"))
        for i in range(iters):
            loss, rew = self.iterate()
            losses.append(loss)
            self.episode_rewards.append(rew)
            if tb is not None:
                step = (i + 1) * self.steps_per_iter
                tb.add_scalar("rollout/ep_rew_mean", rew, step)
                tb.add_scalar("train/loss", loss, step)
        if tb is not None:
            tb.close()
        return {"iterations": iters, "final_loss": losses[-1],
                "mean_episode_reward": float(np.mean(
                    self.episode_rewards[-log_every:]))}

    def train_on_device(self, total_timesteps: int,
                        iters_per_dispatch: int = 8) -> dict:
        """:meth:`train` in chunks of ``iters_per_dispatch`` iterations,
        the JAX package's fused-chunk schedule and returned schema (every
        iteration runs on the env's device; nothing here is fused into one
        program)."""
        iters = max(1, total_timesteps // self.steps_per_iter)
        n_chunks = max(1, -(-iters // iters_per_dispatch))
        t0 = time.perf_counter()
        losses = []
        for _ in range(n_chunks * iters_per_dispatch):
            loss, rew = self.iterate()
            losses.append(loss)
            self.episode_rewards.append(rew)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return {"iterations": n_chunks * iters_per_dispatch,
                "timesteps": n_chunks * iters_per_dispatch
                * self.steps_per_iter,
                "final_loss": losses[-1],
                "mean_episode_reward": float(np.mean(
                    self.episode_rewards[-iters_per_dispatch:])),
                "wall_seconds": wall,
                "dispatches": n_chunks,
                "backend": self.device.type,
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu")}

    # -- inference and files -----------------------------------------------
    @torch.no_grad()
    def predict(self, obs, deterministic: bool = True):
        """Actions for ``[18]`` or ``[R, 18]`` observations, clipped to the
        action box: numpy in, numpy out (one row as ``[2]``); a tensor in,
        a tensor on the env's device out."""
        as_numpy = not isinstance(obs, torch.Tensor)
        x = torch.as_tensor(np.asarray(obs, np.float32) if as_numpy else obs,
                            device=self.device).to(torch.float32)
        x = torch.atleast_2d(x)
        mean, log_std, _ = self.net(x)
        if not deterministic:
            mean = mean + torch.exp(log_std) * torch.randn(
                mean.shape, generator=self.generator, device=self.device)
        a = torch.clamp(mean, self.low, self.high)
        if not as_numpy:
            return a
        a = a.cpu().numpy()
        return a[0] if a.shape[0] == 1 else a

    def save(self, path):
        """``.npz``: the JAX package's flat archive (``params/<flax path>``
        and ``__config__``), readable by its ``PPOTrainer.load``; any other
        suffix: its pickle layout."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        flat = state_to_flax(self.net)
        config = dataclasses.asdict(self.cfg)
        config["hidden"] = list(config["hidden"])
        if str(path).endswith(".npz"):
            arrays = {f"params/{k}": v for k, v in flat.items()}
            arrays["__config__"] = np.frombuffer(json.dumps(config).encode(),
                                                 np.uint8)
            np.savez(path, **arrays)
            return
        with open(path, "wb") as f:
            pickle.dump({"params": nest_flat(flat), "config": config}, f)

    def load(self, path):
        """Weights from either package's ``.npz`` or pickle; the network
        takes the file's widths."""
        if str(path).endswith(".npz"):
            with np.load(path) as z:
                flat = {k.partition("/")[2]: z[k] for k in z.files
                        if k != "__config__"}
        else:
            with open(path, "rb") as f:
                flat = flatten_tree(pickle.load(f)["params"])
        self.load_state(flax_to_state(flat))

    def load_state(self, state):
        hidden = hidden_of(state)
        if hidden != tuple(self.cfg.hidden):
            self.cfg = dataclasses.replace(self.cfg, hidden=hidden)
            self._build(hidden)
        load_state(self.net, state)

    # -- parameter transfer between curriculum phases ----------------------
    def get_parameters(self) -> dict:
        """The network's parameters as detached copies (a later phase
        cannot alias them); RL/train_raytracer_improved.py:258-274."""
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    @torch.no_grad()
    def set_parameters(self, params: dict) -> None:
        """Copy ``params`` into the existing network in place: the Adam
        state keeps its references to the parameter tensors."""
        for k, v in self.net.state_dict().items():
            v.copy_(params[k])

    def load_sb3(self, path):
        """A stable-baselines3 PPO ``.zip``: policy and value weights and
        ``log_std``, and the archive's action bounds when it has them."""
        from ..utils.sb3_import import (action_bounds as sb3_bounds,
                                        import_ppo_policy, load_sb3_zip)
        ck = load_sb3_zip(path)
        self.load_state(import_ppo_policy(ck["policy"]))
        try:
            low, high = sb3_bounds(ck["data"])
        except ValueError:
            return
        self.low = torch.from_numpy(low).to(self.device)
        self.high = torch.from_numpy(high).to(self.device)
