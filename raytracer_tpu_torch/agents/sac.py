"""SAC on the batched ray-tracing env.

Counterpart of ``raytracer_tpu/agents/sac.py`` (SB3 SAC's hyperparameters:
lr 3e-4, buffer 100k, learning_starts 5000, batch 256, τ 0.005, automatic
entropy, RL/ray_tracer_rl_complete.py:108-126): a tanh-squashed Gaussian
policy rescaled to the action box, twin Q critics with Polyak targets, and
the temperature tuned toward the target entropy −dim(A).  Three separate
Adams (optax's settings: β 0.9/0.999, ε 1e-8 outside the root), one of
them on the scalar ``log_alpha``.

``train`` keeps the replay buffer in host memory (``_Buffer``), as the
reference's off-policy loop does; ``train_on_device`` keeps a ring buffer
of ``[cap, ...]`` tensors on the env's device, writes each rollout's whole
``T x B`` block with a validity weight a slot, and trains with the
weighted losses (``update(..., weighted)``).

Randomness comes in as inputs: an update takes its two noise draws
``[batch, 2]``; the trainers draw them, the rollouts' actions, the reset
pixels and the buffer indices from the trainer's ``torch.Generator`` and
its numpy ``Generator``.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..env.raytracer_env import OBS_DIM, RayTracerEnv
from .networks import (SACActor, SACCritic, flatten_tree, flax_to_state,
                       hidden_of, initialise, load_state, nest_flat,
                       state_to_flax)
from .ppo import HALF_LOG_2PI, action_bounds


@dataclasses.dataclass
class SACConfig:
    learning_rate: float = 3e-4
    buffer_size: int = 100_000
    learning_starts: int = 5000
    batch_size: int = 256
    tau: float = 0.005
    gamma: float = 0.99
    batch_envs: int = 128
    hidden: Tuple[int, ...] = (256, 256)
    # SB3-style TensorBoard events under {tensorboard_log}/SAC_{N}/.
    tensorboard_log: Optional[str] = None


def _adam(params, lr):
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _step(opt, params, loss):
    """One Adam step of ``opt`` on the gradient of ``loss`` with respect to
    ``params`` only."""
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def _wmean(x, w):
    if w is None:
        return torch.mean(x)
    return torch.sum(x * w) / torch.clamp_min(torch.sum(w), 1.0)


class SACTrainer:
    def __init__(self, env: RayTracerEnv, config: Optional[SACConfig] = None,
                 seed: int = 0):
        self.env = env
        self.device = env.device
        self.cfg = config or SACConfig()
        self._seed = seed
        self._build(self.cfg.hidden)
        self.target_entropy = -2.0
        self.low, self.high = action_bounds(env.variant, self.device)
        self._bounds()
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.rng = np.random.default_rng(seed + 1)
        self.buffer = _Buffer(self.cfg.buffer_size, OBS_DIM, 2)
        self.total_steps = 0
        self.episode_rewards: list[float] = []

    def _build(self, hidden):
        gen = torch.Generator().manual_seed(self._seed)
        dev, lr = self.device, self.cfg.learning_rate
        self.actor = initialise(SACActor(hidden=tuple(hidden)), gen).to(dev)
        self.critic = initialise(SACCritic(hidden=tuple(hidden)),
                                 gen).to(dev)
        self.target_critic = SACCritic(hidden=tuple(hidden)).to(dev)
        self.target_critic.load_state_dict(self.critic.state_dict())
        self.target_critic.requires_grad_(False)
        self.log_alpha = torch.zeros((), device=dev, requires_grad=True)
        self.actor_opt = _adam(self.actor.parameters(), lr)
        self.critic_opt = _adam(self.critic.parameters(), lr)
        self.alpha_opt = _adam([self.log_alpha], lr)

    def _bounds(self):
        self.scale = (self.high - self.low) / 2.0
        self.mid = (self.high + self.low) / 2.0

    # -- squashed policy (JAX sac.py:83-93) ---------------------------------
    def sample_action(self, obs, noise, actor=None):
        """``(action, logp)``: ``mid + scale * tanh(mean + std * noise)``
        and its log-density with the squash's correction."""
        mean, log_std = (actor or self.actor)(obs)
        std = torch.exp(log_std)
        u = mean + std * noise
        t = torch.tanh(u)
        a = self.mid + self.scale * t
        terms = (-0.5 * ((u - mean) / std) ** 2 - log_std - HALF_LOG_2PI
                 - torch.log(self.scale * (1 - t ** 2) + 1e-6))
        return a, terms[..., 0] + terms[..., 1]

    # -- update (JAX sac.py:95-160) -----------------------------------------
    def update(self, batch, noise_next, noise_actor, weighted: bool = False):
        """One SAC update on ``batch`` ``(obs, action, reward, next_obs,
        done[, w])``: the critic's Adam step toward the target, the actor's
        against the updated critic, the temperature's, then the Polyak
        target.  ``weighted``: the batch's last member weighs each sample in
        all three losses.  Returns ``(critic_loss, actor_loss)`` tensors."""
        cfg = self.cfg
        if weighted:
            obs, action, reward, next_obs, done, w = batch
        else:
            (obs, action, reward, next_obs, done), w = batch, None
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            next_a, next_logp = self.sample_action(next_obs, noise_next)
            tq1, tq2 = self.target_critic(next_obs, next_a)
            target_q = reward + cfg.gamma * (1 - done) * (
                torch.minimum(tq1, tq2) - alpha * next_logp)

        cparams = list(self.critic.parameters())
        q1, q2 = self.critic(obs, action)
        closs = _wmean((q1 - target_q) ** 2 + (q2 - target_q) ** 2, w)
        _step(self.critic_opt, cparams, closs)

        aparams = list(self.actor.parameters())
        a, logp = self.sample_action(obs, noise_actor)
        q1, q2 = self.critic(obs, a)
        aloss = _wmean(alpha * logp - torch.minimum(q1, q2), w)
        _step(self.actor_opt, aparams, aloss)

        lloss = -_wmean(torch.exp(self.log_alpha)
                        * (logp.detach() + self.target_entropy), w)
        _step(self.alpha_opt, [self.log_alpha], lloss)

        with torch.no_grad():
            for t, s in zip(self.target_critic.parameters(), cparams):
                t.copy_((1 - cfg.tau) * t + cfg.tau * s)
        return closs.detach(), aloss.detach()

    def update_draws(self, batch: int):
        """The update's two noise draws, ``[batch, 2]`` each."""
        kw = dict(generator=self.generator, device=self.device)
        return torch.randn((batch, 2), **kw), torch.randn((batch, 2), **kw)

    def _uniform_actions(self, n: int):
        u = torch.rand((n, 2), generator=self.generator, device=self.device)
        return self.low + (self.high - self.low) * u

    # -- training loop with the host buffer (JAX sac.py:334-398) ------------
    def train(self, total_timesteps: int, updates_per_rollout: int = 8
              ) -> dict:
        env, cfg = self.env, self.cfg
        B = cfg.batch_envs
        T = env.max_bounces + 2
        closs = aloss = 0.0
        tb = None
        if cfg.tensorboard_log:
            from ..utils.tb import SummaryWriter, next_run_dir
            tb = SummaryWriter(next_run_dir(cfg.tensorboard_log, "SAC"))
        while self.total_steps < total_timesteps:
            state, obs = env.reset(B, generator=self.generator)
            for _ in range(T):
                if self.total_steps < cfg.learning_starts:
                    a = self._uniform_actions(B)
                else:
                    with torch.no_grad():
                        a, _ = self.sample_action(obs, torch.randn(
                            (B, 2), generator=self.generator,
                            device=self.device))
                active = ~state.done
                nstate, nobs, r, term, _ = env.step(state, a)
                act = active.cpu().numpy()
                if act.any():
                    self.buffer.add(*(x.cpu().numpy()[act] for x in (
                        obs, a, r, nobs, term.to(torch.float32))))
                self.total_steps += int(act.sum())
                state, obs = nstate, nobs
                if bool(state.done.all()):
                    break
            self.episode_rewards.append(float(state.total_reward.mean()))
            if (self.buffer.size >= cfg.batch_size
                    and self.total_steps >= cfg.learning_starts):
                for _ in range(updates_per_rollout):
                    batch = tuple(torch.from_numpy(b).to(self.device)
                                  for b in self.buffer.sample(
                                      self.rng, cfg.batch_size))
                    closs, aloss = self.update(
                        batch, *self.update_draws(cfg.batch_size))
            if tb is not None:
                tb.add_scalar("rollout/ep_rew_mean",
                              self.episode_rewards[-1], self.total_steps)
                tb.add_scalar("train/critic_loss", float(closs),
                              self.total_steps)
                tb.add_scalar("train/actor_loss", float(aloss),
                              self.total_steps)
                tb.add_scalar("train/ent_coef",
                              float(torch.exp(self.log_alpha)),
                              self.total_steps)
        if tb is not None:
            tb.close()
        return {"total_steps": self.total_steps,
                "critic_loss": float(closs), "actor_loss": float(aloss),
                "mean_episode_reward": float(np.mean(
                    self.episode_rewards[-20:]))}

    # -- training with the ring buffer on the device (JAX sac.py:164-330) ---
    @torch.no_grad()
    def _ring_rollout(self, explore: bool):
        """One batched rollout: the flat ``T x B`` block ``(obs, action,
        reward, next_obs, done, valid)`` and the episodes' total rewards."""
        env, B = self.env, self.cfg.batch_envs
        state, obs = env.reset(B, generator=self.generator)
        recs = []
        for _ in range(env.max_bounces + 2):
            if explore:
                a = self._uniform_actions(B)
            else:
                a, _ = self.sample_action(obs, torch.randn(
                    (B, 2), generator=self.generator, device=self.device))
            active = ~state.done
            state, nobs, r, term, _ = env.step(state, a)
            recs.append((obs, a, r, nobs, term.to(torch.float32),
                         active.to(torch.float32)))
            obs = nobs
        flat = tuple(torch.cat(x) for x in zip(*recs))
        return flat, state.total_reward

    def train_on_device(self, total_timesteps: int,
                        iters_per_dispatch: int = 8,
                        updates_per_rollout: int = 8) -> dict:
        """SAC with the ring buffer on the env's device: each iteration
        writes a rollout's ``T x B`` block (dead lanes with weight 0) at the
        write pointer (the capacity a block multiple, so a write never
        wraps), then, once the filled region holds a batch, runs
        ``updates_per_rollout`` weighted updates on uniform indices over
        it.  The JAX package's chunk schedule and returned schema."""
        cfg = self.cfg
        dev = self.device
        N = (self.env.max_bounces + 2) * cfg.batch_envs
        cap = max(cfg.buffer_size // N, 1) * N
        iters = max(1, total_timesteps // N)
        n_chunks = max(1, -(-iters // iters_per_dispatch))
        f32 = torch.float32
        buf = (torch.zeros((cap, OBS_DIM), dtype=f32, device=dev),
               torch.zeros((cap, 2), dtype=f32, device=dev),
               torch.zeros((cap,), dtype=f32, device=dev),
               torch.zeros((cap, OBS_DIM), dtype=f32, device=dev),
               torch.zeros((cap,), dtype=f32, device=dev),
               torch.zeros((cap,), dtype=f32, device=dev))
        ptr = size = total = 0
        t0 = time.perf_counter()
        closs = aloss = 0.0
        for _ in range(n_chunks * iters_per_dispatch):
            flat, ep_rew = self._ring_rollout(total < cfg.learning_starts)
            for b, x in zip(buf, flat):
                b[ptr:ptr + N] = x
            ptr = (ptr + N) % cap
            size = min(size + N, cap)
            total += int(flat[5].sum())
            cl, al = [], []
            if size >= cfg.batch_size:
                for _ in range(updates_per_rollout):
                    idx = torch.randint(0, max(size, 1), (cfg.batch_size,),
                                        generator=self.generator, device=dev)
                    c, a = self.update(tuple(b[idx] for b in buf),
                                       *self.update_draws(cfg.batch_size),
                                       weighted=True)
                    cl.append(c)
                    al.append(a)
                closs = float(torch.stack(cl).mean())
                aloss = float(torch.stack(al).mean())
            else:
                closs = aloss = 0.0
            self.episode_rewards.append(float(ep_rew.mean()))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        self.total_steps += total
        return {"total_steps": total, "buffer_capacity": cap,
                "critic_loss": closs, "actor_loss": aloss,
                "mean_episode_reward": float(np.mean(
                    self.episode_rewards[-iters_per_dispatch:])),
                "wall_seconds": wall, "dispatches": n_chunks,
                "backend": dev.type,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}

    # -- inference and files -----------------------------------------------
    @torch.no_grad()
    def predict(self, obs, deterministic: bool = True):
        """``mid + scale * tanh(mean)`` (plus noise unless
        ``deterministic``) for ``[18]`` or ``[R, 18]`` observations: numpy
        in, numpy out (one row as ``[2]``); a tensor in, a tensor out."""
        as_numpy = not isinstance(obs, torch.Tensor)
        x = torch.as_tensor(np.asarray(obs, np.float32) if as_numpy else obs,
                            device=self.device).to(torch.float32)
        mean, log_std = self.actor(torch.atleast_2d(x))
        u = mean
        if not deterministic:
            u = mean + torch.exp(log_std) * torch.randn(
                mean.shape, generator=self.generator, device=self.device)
        a = self.mid + self.scale * torch.tanh(u)
        if not as_numpy:
            return a
        a = a.cpu().numpy()
        return a[0] if a.shape[0] == 1 else a

    def save(self, path):
        """``.npz``: the shipped layout (``actor/...``, ``critic/...``,
        ``log_alpha``, ``__config__``), readable by the JAX package's
        ``SACTrainer.load``; any other suffix: its pickle layout."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        actor, critic = state_to_flax(self.actor), state_to_flax(self.critic)
        log_alpha = float(self.log_alpha.detach())
        config = dataclasses.asdict(self.cfg)
        config["hidden"] = list(config["hidden"])
        if str(path).endswith(".npz"):
            arrays = {f"actor/{k}": v for k, v in actor.items()}
            arrays.update({f"critic/{k}": v for k, v in critic.items()})
            arrays["log_alpha"] = np.asarray(log_alpha)
            arrays["__config__"] = np.frombuffer(json.dumps(config).encode(),
                                                 np.uint8)
            np.savez(path, **arrays)
            return
        with open(path, "wb") as f:
            pickle.dump({"actor": nest_flat(actor),
                         "critic": nest_flat(critic),
                         "log_alpha": log_alpha, "config": config}, f)

    def load(self, path):
        """Actor, critic and ``log_alpha`` from either package's ``.npz``
        or pickle (the target critic stays as it was, as in the JAX
        package); the networks take the file's widths."""
        if str(path).endswith(".npz"):
            with np.load(path) as z:
                trees = {"actor": {}, "critic": {}}
                for key in z.files:
                    if key in ("log_alpha", "__config__"):
                        continue
                    prefix, _, rest = key.partition("/")
                    trees[prefix][rest] = z[key]
                log_alpha = float(z["log_alpha"])
        else:
            with open(path, "rb") as f:
                ck = pickle.load(f)
            trees = {k: flatten_tree(ck[k]) for k in ("actor", "critic")}
            log_alpha = float(ck["log_alpha"])
        self.load_states(flax_to_state(trees["actor"]),
                         flax_to_state(trees["critic"]))
        with torch.no_grad():
            self.log_alpha.fill_(log_alpha)

    def load_states(self, actor, critic, target=None):
        hidden = hidden_of(actor)
        if hidden != tuple(self.cfg.hidden):
            self.cfg = dataclasses.replace(self.cfg, hidden=hidden)
            self._build(hidden)
        load_state(self.actor, actor)
        load_state(self.critic, critic)
        if target is not None:
            load_state(self.target_critic, target)

    # -- parameter transfer between curriculum phases ----------------------
    def get_parameters(self) -> dict:
        """Detached copies of the actor, the critic, the target critic and
        ``log_alpha`` (the JAX package's SAC has no such pair; SB3's, which
        the reference's curriculum used, moves all four)."""
        def copy(m):
            return {k: v.detach().clone() for k, v in m.state_dict().items()}
        return {"actor": copy(self.actor), "critic": copy(self.critic),
                "target_critic": copy(self.target_critic),
                "log_alpha": self.log_alpha.detach().clone()}

    @torch.no_grad()
    def set_parameters(self, params: dict) -> None:
        """Copy ``params`` into the existing modules in place: the three
        Adams keep their references to the parameter tensors."""
        for name in ("actor", "critic", "target_critic"):
            for k, v in getattr(self, name).state_dict().items():
                v.copy_(params[name][k])
        self.log_alpha.copy_(params["log_alpha"])

    def load_sb3(self, path):
        """A stable-baselines3 SAC ``.zip``: actor, both critics and the
        target critics, and the archive's action bounds when it has
        them."""
        from ..utils.sb3_import import (action_bounds as sb3_bounds,
                                        import_sac_policy, load_sb3_zip)
        ck = load_sb3_zip(path)
        trees = import_sac_policy(ck["policy"])
        self.load_states(trees["actor"], trees["critic"],
                         trees["target_critic"])
        try:
            low, high = sb3_bounds(ck["data"])
        except ValueError:
            return
        self.low = torch.from_numpy(low).to(self.device)
        self.high = torch.from_numpy(high).to(self.device)
        self._bounds()


class _Buffer:
    """Host replay buffer (numpy ring)."""

    def __init__(self, capacity, obs_dim, action_dim):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros((capacity, action_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.pos = 0
        self.size = 0

    def add(self, obs, action, reward, next_obs, done):
        n = obs.shape[0]
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.action[idx] = action
        self.reward[idx] = reward
        self.next_obs[idx] = next_obs
        self.done[idx] = done
        self.pos = int((self.pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng, batch):
        idx = rng.integers(0, self.size, batch)
        return (self.obs[idx], self.action[idx], self.reward[idx],
                self.next_obs[idx], self.done[idx])
