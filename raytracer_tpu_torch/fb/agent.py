"""FBResearchAgent: the FB learner.

Counterpart of ``raytracer_tpu/fb/agent.py`` (the redesign of the
reference's missing ``fb_ray_tracing.py``, FB/output6.py:38,
FB/train_chandelier_only.py:30):

* ``choose_direction_research(obs, ...)``: encode, aim the backward model
  at the light-prototype latent, add the decaying exploration noise;
* ``record_success(obs, action, next_obs, reward, hit_light)``: ingest
  transitions into the host ``ReplayBuffer``, keep the light-latent memory
  (the last 20), run one update for every ``update_freq`` records crossed
  (at most 64 a call), refresh the target encoder every
  ``target_update_freq // update_freq`` updates;
* ``save``/``load``: the native npz (``utils/checkpoint.py``), which JAX's
  ``load_fb`` reads too.

The loss (JAX :151-198) is the weighted sum of: ``fb``, the Gaussian NLL
of the taken action under ``backward(z, z')``, light-reaching transitions
weighted 10×; ``predictive``, each forward head's Gaussian NLL of the
target next latent; ``contrastive``, InfoNCE between the head-mean
prediction and the batch's next latents (temperature 0.1); ``norm``,
``(‖z‖ − 1)²``; ``diversity``, ``−mean(tanh(var over heads))``.  Log
variances are clipped to [−8, 4]; the next latent comes from the target
encoder under ``no_grad`` (JAX's ``stop_gradient``).  The optimiser is
``torch.optim.Adam`` as ``optax.adam`` is set (β 0.9/0.999, ε 1e-8 outside
the root), on the encoder, forward and backward models.  The products run
in f32 (TF32 stays off: ``torch.backends.cuda.matmul.allow_tf32``).

The replay buffer is numpy, as JAX's, so the same ``default_rng(seed)``
gives the same batches.  Initial values are flax's distributions drawn by a
``torch.Generator`` (``fb/networks.py::initialise``); their bits cannot be
JAX's, so the tests start both packages from one checkpoint.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..utils.checkpoint import PARTS, load_fb, networks_for, save_fb
from .config import FBConfig
from .inference import AgentGuide
from .networks import initialise

LOGVAR_MIN, LOGVAR_MAX = -8.0, 4.0
LIGHT_MEMORY = 20
MAX_UPDATES_PER_RECORD = 64


class ReplayBuffer:
    """Host-side ring buffer of transitions (JAX ``ReplayBuffer`` :45)."""

    def __init__(self, capacity: int, obs_dim: int, action_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros((capacity, action_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.hit_light = np.zeros((capacity,), np.float32)
        self.size = 0
        self.pos = 0

    def add(self, obs, action, next_obs, reward, hit_light):
        obs = np.atleast_2d(np.asarray(obs, np.float32))
        action = np.atleast_2d(np.asarray(action, np.float32))
        next_obs = np.atleast_2d(np.asarray(next_obs, np.float32))
        reward = np.atleast_1d(np.asarray(reward, np.float32))
        hit = np.atleast_1d(np.asarray(hit_light, np.float32))
        n = obs.shape[0]
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.action[idx] = action
        self.next_obs[idx] = next_obs
        self.reward[idx] = reward
        self.hit_light[idx] = hit
        self.pos = int((self.pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng: np.random.Generator, batch: int,
               hit_fraction: float = 0.25):
        """Uniform draw with a quota of light-hit transitions (a quarter of
        the batch, when there are any), JAX's draws from ``rng``."""
        idx = rng.integers(0, self.size, batch)
        if hit_fraction > 0:
            hits = np.nonzero(self.hit_light[:self.size] > 0)[0]
            if hits.size:
                k = max(1, int(batch * hit_fraction))
                idx[:k] = rng.choice(hits, k)
        return (self.obs[idx], self.action[idx], self.next_obs[idx],
                self.reward[idx], self.hit_light[idx])


def loss_terms(encoder, forward_model, backward, target_encoder, batch,
               config: FBConfig):
    """``(total, terms)`` of JAX's ``loss_fn`` on ``batch`` (tensors ``obs,
    action, next_obs, reward, hit``); ``terms`` holds ``fb``,
    ``predictive``, ``contrastive``, ``norm``, ``diversity`` and
    ``head_var`` as 0-d tensors."""
    obs, action, next_obs, _, hit = batch
    zd = config.z_dim
    z = encoder(obs)[:, :zd]
    with torch.no_grad():
        z_next = target_encoder(next_obs)[:, :zd]
    a_mean, a_logvar = backward(z, z_next)
    a_logvar = torch.clamp(a_logvar, LOGVAR_MIN, LOGVAR_MAX)
    w = 1.0 + 9.0 * hit
    nll = torch.sum(0.5 * ((action - a_mean) ** 2 * torch.exp(-a_logvar)
                           + a_logvar), dim=-1)
    fb = torch.sum(w * nll) / torch.clamp_min(torch.sum(w), 1.0)
    preds = forward_model(z, action)
    means = torch.stack([m for m, _ in preds])                  # [H, B, Z]
    logvars = torch.clamp(torch.stack([lv for _, lv in preds]),
                          LOGVAR_MIN, LOGVAR_MAX)
    predictive = torch.mean(0.5 * ((z_next[None] - means) ** 2
                                   * torch.exp(-logvars) + logvars))
    pred = means.mean(dim=0)
    pn = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-8)
    tn = z_next / (torch.linalg.vector_norm(z_next, dim=-1, keepdim=True)
                   + 1e-8)
    logits = pn @ tn.T / 0.1
    labels = torch.arange(logits.shape[0], device=logits.device)
    contrastive = F.cross_entropy(logits, labels)
    norm = torch.mean((torch.linalg.vector_norm(z, dim=-1) - 1.0) ** 2)
    head_var = torch.var(means, dim=0, correction=0)
    diversity = -torch.mean(torch.tanh(head_var))
    total = (config.fb_weight * fb
             + config.predictive_weight * predictive
             + config.contrastive_weight * contrastive
             + config.norm_weight * norm
             + config.diversity_weight * diversity)
    return total, dict(fb=fb, predictive=predictive, contrastive=contrastive,
                       norm=norm, diversity=diversity,
                       head_var=head_var.mean())


class FBResearchAgent:
    """Train and inference agent over the Enhanced network family, on
    ``device`` (``cuda`` by default).  ``seed`` seeds the initial values
    (a ``torch.Generator`` on the CPU), the replay draws
    (``np.random.default_rng(seed)``, as JAX) and the exploration noise (a
    ``torch.Generator`` on the device, seeded ``seed + 1``)."""

    def __init__(self, config: FBConfig, seed: int = 0, device=None):
        self.config = config
        self.device = resolve_device(device)
        nets = networks_for(config)
        gen = torch.Generator().manual_seed(seed)
        for name in ("encoder", "forward", "backward"):
            initialise(nets[name], gen)
        nets["target_encoder"].load_state_dict(nets["encoder"].state_dict())
        for name in PARTS:
            nets[name].to(self.device)
        self.encoder, self.forward_model, self.backward = (
            nets["encoder"], nets["forward"], nets["backward"])
        self.target_encoder = nets["target_encoder"]
        params = [p for m in (self.encoder, self.forward_model,
                              self.backward) for p in m.parameters()]
        for p in params:
            p.requires_grad_(True)
        self.optimizer = torch.optim.Adam(params, lr=config.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.buffer = ReplayBuffer(config.buffer_capacity, config.obs_dim,
                                   config.action_dim)
        self.rng = np.random.default_rng(seed)
        self._noise_gen = torch.Generator(self.device).manual_seed(seed + 1)
        self.noise_scale = config.noise_scale
        self.records = 0
        self.updates = 0
        self.light_memory: list = []
        self.losses: list = []
        self.stats = {"light_hits": 0, "total_transitions": 0}
        self.head_var_history: list = []
        self.scene_history: list = []
        self.generalization_scores: list = []
        self.choice_calls = 0
        self.guided_calls = 0

    @property
    def nets(self) -> dict:
        """The four networks under ``utils/checkpoint.py::PARTS``."""
        return dict(zip(PARTS, (self.encoder, self.forward_model,
                                self.backward, self.target_encoder)))

    # -- latents and the policy ---------------------------------------------
    def encode_mean(self, obs) -> torch.Tensor:
        obs = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        with torch.no_grad():
            return self.encoder(obs)[:, :self.config.z_dim]

    def light_prototype(self) -> np.ndarray:
        if not self.light_memory:
            return np.zeros((self.config.z_dim,), np.float32)
        proto = np.mean(np.stack(self.light_memory), axis=0)
        n = np.linalg.norm(proto)
        return (proto / n if n > 1e-8 else proto).astype(np.float32)

    def guide(self) -> AgentGuide:
        """The live policy's action mean against the current prototype, as
        a guide (``obs [R, 22] -> [R, 2]``, f32): JAX's ``guide_apply`` for
        the walk and the trainers' render probe."""
        proto = torch.from_numpy(self.light_prototype()).to(self.device)
        return AgentGuide(self.encoder, self.backward, proto,
                          self.config.z_dim)

    def choose_direction_research(self, obs, scene_context=None,
                                  exploration_phase: bool = False,
                                  noise: Optional[torch.Tensor] = None
                                  ) -> Tuple[np.ndarray, dict]:
        """Actions for ``obs`` (one row or ``[R, 22]``): the backward mean
        against the prototype plus ``noise_scale`` (at least ``min_noise``;
        0.3 in the exploration phase) times a standard normal, clipped to
        [-1, 1].  ``noise [R, 2]``: the standard normals as given, else
        drawn by the agent's generator (JAX's bits cannot be
        reproduced)."""
        obs = np.atleast_2d(np.asarray(obs, np.float32))
        scale = max(self.noise_scale, self.config.min_noise)
        if exploration_phase:
            scale = max(scale, 0.3)
        mean = self.guide()(torch.from_numpy(obs).to(self.device))
        if noise is None:
            noise = torch.randn(mean.shape, generator=self._noise_gen,
                                device=self.device)
        noise = noise.to(self.device, torch.float32) * scale
        action = torch.clamp(mean + noise, -1.0, 1.0).cpu().numpy()
        strategy = "fb_guided" if self.light_memory else "exploration"
        self.choice_calls += obs.shape[0]
        if strategy == "fb_guided":
            self.guided_calls += obs.shape[0]
        info = {"strategy": strategy, "noise_scale": scale,
                "memory_size": len(self.light_memory)}
        return (action[0] if action.shape[0] == 1 else action), info

    def choose_direction_batch(self, obs: torch.Tensor) -> torch.Tensor:
        """Noise-free batched policy (JAX: noise scale 0), clipped."""
        return torch.clamp(self.guide()(obs), -1.0, 1.0)

    # -- experience and updates ----------------------------------------------
    def record_success(self, obs, action, next_obs, reward, hit_light):
        self.buffer.add(obs, action, next_obs, reward, hit_light)
        n = np.atleast_2d(np.asarray(obs)).shape[0]
        self.records += n
        self.stats["total_transitions"] += n
        hits = np.atleast_1d(np.asarray(hit_light)).astype(bool)
        self.stats["light_hits"] += int(hits.sum())
        if hits.any():
            nxt = np.atleast_2d(np.asarray(next_obs, np.float32))[hits]
            for row in self.encode_mean(nxt).cpu().numpy():
                self.light_memory.append(row)
            self.light_memory = self.light_memory[-LIGHT_MEMORY:]
        f = self.config.update_freq
        crossings = self.records // f - (self.records - n) // f
        for _ in range(min(int(crossings), MAX_UPDATES_PER_RECORD)):
            self.train_step()

    def update(self, batch) -> Tuple[float, dict]:
        """One Adam step on ``batch`` (numpy or tensors ``obs, action,
        next_obs, reward, hit``): ``(total loss, terms as floats)``."""
        batch = tuple(torch.as_tensor(np.asarray(b, np.float32)).to(
            self.device) for b in batch)
        total, terms = loss_terms(self.encoder, self.forward_model,
                                  self.backward, self.target_encoder, batch,
                                  self.config)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        return float(total.detach()), {k: float(v.detach())
                                       for k, v in terms.items()}

    def train_step(self) -> Optional[float]:
        if self.buffer.size < max(2, min(self.config.batch_size, 32)):
            return None
        batch = self.buffer.sample(self.rng, min(self.config.batch_size,
                                                 self.buffer.size))
        loss, terms = self.update(batch)
        self.updates += 1
        self.noise_scale = max(self.config.min_noise,
                               self.noise_scale * self.config.noise_decay)
        if self.updates % max(1, self.config.target_update_freq
                              // self.config.update_freq) == 0:
            self.target_encoder.load_state_dict(self.encoder.state_dict())
        self.losses.append(loss)
        self.head_var_history.append(terms["head_var"])
        return loss

    # -- checkpoints ---------------------------------------------------------
    def save(self, path):
        save_fb(path, self.nets, self.config,
                light_memory=self.light_memory,
                noise_scale=self.noise_scale, updates=self.updates)

    @torch.no_grad()
    def load(self, path):
        """Parameters, light memory, noise scale and update count from a
        native checkpoint of either package; the optimiser's state and the
        buffer stay as they are (JAX ``load``)."""
        nets, _, extra = load_fb(path, self.config)
        for name, net in self.nets.items():
            for p, q in zip(net.parameters(), nets[name].parameters()):
                p.copy_(q)
        self.light_memory = list(extra.get("light_memory", []))
        self.noise_scale = float(extra.get("noise_scale", self.noise_scale))
        self.updates = int(extra.get("updates", self.updates))

    # -- measured-stat hooks (the trainers call them) -------------------------
    def note_scene_performance(self, scene_type: str, hit_rate: float):
        self.scene_history.append((str(scene_type), float(hit_rate)))

    def note_generalization(self, score: float):
        if np.isfinite(score):
            self.generalization_scores.append(float(score))

    def get_stats(self) -> dict:
        """The training report's ``agent_stats``, every value measured from
        this agent's history (JAX ``get_stats``)."""
        hv = self.head_var_history
        var_reduction = 0.0
        if len(hv) >= 4:
            k = max(2, min(10, len(hv) // 2))
            early, late = float(np.mean(hv[:k])), float(np.mean(hv[-k:]))
            if early > 1e-12:
                var_reduction = (early - late) / early
        by_type: dict = {}
        for stype, rate in self.scene_history:
            by_type.setdefault(stype, []).append(rate)
        speeds = []
        for rates in by_type.values():
            first = next((i for i, r in enumerate(rates) if r > 0), None)
            if first is not None:
                speeds.append(1.0 / (first + 1))
        total = max(self.stats["total_transitions"], 1)
        return {
            "performance": {
                "light_hit_rate": self.stats["light_hits"] / total,
                "avg_variance_reduction": var_reduction,
                "total_rays": self.stats["total_transitions"],
                "light_hits": self.stats["light_hits"],
            },
            "adaptability": {
                "avg_adaptation_speed": (float(np.mean(speeds))
                                         if speeds else 0.0),
                "num_scenes_encountered": len(self.scene_history),
                "scene_specific_memory": {
                    t: float(np.mean(v)) for t, v in by_type.items()},
            },
            "efficiency": {
                "buffer_utilization": self.buffer.size / self.buffer.capacity,
                "avg_fb_guided_ratio": (self.guided_calls
                                        / max(self.choice_calls, 1)),
                "current_noise_scale": self.noise_scale,
            },
            "generalization": {
                "avg_generalization_score": (
                    float(np.mean(self.generalization_scores))
                    if self.generalization_scores else 0.0),
                "light_memory_size": len(self.light_memory),
                "successful_paths": self.stats["light_hits"],
            },
        }
