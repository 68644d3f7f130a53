"""Trained-FB inference: the light prototype and the batched guide.

Counterpart of ``raytracer_tpu/fb/inference.py`` (``TrainedFBAgent``,
``small_light_indices``; FB/fb_vs_traditional_complex.py:147-256):

* the networks from a native checkpoint (``utils/checkpoint.py``), or
  seeded initial values;
* the **light prototype**: 5 random surface samples a small light (radius
  < 0.5), each seen along the to-camera direction, encoded; the mean
  latent, L2-normalised.  The samples come from
  ``np.random.default_rng(seed)`` in the JAX package's order, so both
  packages draw the same points;
* ``choose_direction(obs)``: the backward model's action mean on
  ``(encode(obs), prototype)``, clipped to [-1, 1];
* ``as_guide_fn(dtype)``: ``obs [R, 22] -> action [R, 2]`` for
  ``trace_path``, one batched forward a bounce level (the guide runs on
  every lane of a level, as in the JAX tracers): f32, bf16 (flax's bf16
  run: parameters, observation and prototype cast, LayerNorm statistics in
  f32, f32 out) or int8 (``fb/quantize.py``).
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..scene.types import Scene
from ..utils.checkpoint import load_fb, networks_for
from .config import FBConfig
from .networks import initialise


class AgentGuide:
    """``guide(obs [R, 22]) -> action mean [R, 2]`` float32, under
    ``torch.inference_mode()``: encoder, the mean half of its output, the
    backward model against the prototype, in ``dtype`` (f32, or bf16 on
    copies of the networks: JAX ``as_guide_fn(jnp.bfloat16)`` casts the
    parameters, the observation and the prototype).  ``obs`` must lie on
    the networks' device."""

    def __init__(self, encoder, backward, prototype: torch.Tensor,
                 z_dim: int, dtype=torch.float32):
        if dtype != torch.float32:
            encoder = copy.deepcopy(encoder).to(dtype)
            backward = copy.deepcopy(backward).to(dtype)
        self.encoder, self.backward = encoder, backward
        self.dtype = dtype
        self.prototype = prototype.to(dtype)
        self.z_dim = z_dim
        self.device = prototype.device

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        if obs.device != self.device:
            raise ValueError(f"observations on {obs.device}; the agent's "
                             f"networks are on {self.device}")
        with torch.inference_mode():
            z = self.encoder(obs.to(self.dtype))[:, :self.z_dim]
            proto = self.prototype.expand(z.shape[0], -1)
            mean = self.backward.action_mean(self.backward.trunk(z, proto))
            return mean.float()


class TrainedFBAgent:
    """The full FB agent as a guide.  ``model_path``: a native ``.npz``
    checkpoint, or None for seeded initial values (flax's initialisers,
    drawn by a ``torch.Generator`` seeded with ``seed``); ``scene`` and
    ``small_light_idx`` give the prototype's lights; ``device``: ``cuda``
    by default."""

    def __init__(self, model_path: Optional[str], scene: Scene,
                 small_light_idx, camera_position,
                 config: Optional[FBConfig] = None, seed: int = 0,
                 device=None):
        self.config = config or FBConfig()
        dev = resolve_device(device)
        self.camera_position = np.asarray(camera_position, np.float32)
        self._rng = np.random.default_rng(seed)
        if model_path is None:
            nets = networks_for(self.config)
            gen = torch.Generator().manual_seed(seed)
            for name in ("encoder", "forward", "backward"):
                initialise(nets[name], gen)
            self.loaded = False
        else:
            if str(model_path).endswith(".pth"):
                raise ValueError("the .pth import (utils/torch_import.py) is "
                                 "not ported; use a native .npz checkpoint")
            nets = load_fb(model_path, self.config)[0]
            self.loaded = True
        self.encoder, self.forward_model, self.backward = (
            nets[n].to(dev).eval() for n in ("encoder", "forward",
                                             "backward"))
        # The parameters' device: "cuda" resolves to "cuda:<current>".
        self.device = self.encoder.Dense_0.kernel.device
        self.light_prototype = self._compute_light_prototype(
            scene, small_light_idx)
        self.prototype = torch.from_numpy(self.light_prototype).to(
            self.device)

    def encode(self, obs) -> torch.Tensor:
        """The z mean of ``obs [R, 22]`` (numpy or tensor), on the agent's
        device."""
        obs = torch.as_tensor(obs, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            return self.encoder(obs)[..., :self.config.z_dim]

    @staticmethod
    def _observation_for_light(point, normal, incoming, colour, sphere_id):
        """22-D obs as the reference builds it for prototype samples
        (:184-202): material = the light's (emissive), bounce features 0,
        pad (0.5, 0.5, 0.5)."""
        return np.concatenate([
            point, incoming, normal,
            [0.0, 0.0, 1.0, 1.0],                    # refl, transp, emit, ior
            np.asarray(colour, np.float32) / 255.0,
            [0.0, 0.0, float(sphere_id) / 100.0, 0.5, 0.5, 0.5],
        ]).astype(np.float32)

    def _compute_light_prototype(self, scene: Scene, small_light_idx,
                                 num_samples_per_light: int = 5
                                 ) -> np.ndarray:
        """The JAX package's numpy arithmetic and draws, the port's
        encoder."""
        centres = scene.centre.detach().cpu().numpy()
        radii = scene.radius.detach().cpu().numpy()
        colours = scene.colour.detach().cpu().numpy()
        ids = scene.id.detach().cpu().numpy()
        obs_rows = []
        for i in np.asarray(small_light_idx):
            to_cam = self.camera_position - centres[i]
            n = np.linalg.norm(to_cam)
            to_cam = to_cam / n if n > 1e-8 else to_cam
            for _ in range(num_samples_per_light):
                theta = self._rng.uniform(0, 2 * np.pi)
                phi = self._rng.uniform(0, np.pi)
                offset = np.array([np.sin(phi) * np.cos(theta),
                                   np.sin(phi) * np.sin(theta),
                                   np.cos(phi)]) * radii[i]
                point = centres[i] + offset
                on = np.linalg.norm(offset)
                normal = offset / on if on > 1e-8 else offset
                obs_rows.append(self._observation_for_light(
                    point, normal, to_cam, colours[i], ids[i]))
        if not obs_rows:
            return np.zeros((self.config.z_dim,), np.float32)
        z = self.encode(np.stack(obs_rows)).cpu().numpy()
        proto = z.mean(axis=0)
        n = np.linalg.norm(proto)
        if n > 1e-8:
            proto = proto / n
        return proto.astype(np.float32)

    def choose_direction(self, obs, use_mean: bool = True,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> np.ndarray:
        """The action for ``obs`` (one row or ``[R, 22]``), clipped to [-1,
        1].  ``use_mean=False`` adds ``exp(log_var / 2) · noise``: the
        standard-normal ``noise [R, 2]`` as given, else drawn by
        ``generator`` on the agent's device (JAX's ``random.normal`` bits
        cannot be reproduced)."""
        obs = np.atleast_2d(np.asarray(obs, np.float32))
        z = self.encode(obs)
        with torch.inference_mode():
            mean, log_var = self.backward(
                z, self.prototype.expand(z.shape[0], -1))
            if not use_mean:
                if noise is None:
                    if generator is None:
                        raise ValueError("use_mean=False needs noise or a "
                                         "generator")
                    noise = torch.randn(mean.shape, generator=generator,
                                        device=self.device)
                mean = mean + torch.exp(0.5 * log_var) * noise.to(
                    self.device, torch.float32)
        a = np.clip(mean.cpu().numpy(), -1.0, 1.0)
        return a[0] if a.shape[0] == 1 else a

    def as_guide_fn(self, dtype=None):
        """The agent as a ``trace_path`` guide.  ``None``, ``"auto"`` (JAX
        picks f32 off the TPU) and ``torch.float32`` give f32;
        ``torch.bfloat16`` the bf16 guide; ``"int8"`` the dynamically
        quantized one (``fb/quantize.py::make_int8_guide``)."""
        if dtype == "int8":
            from .quantize import make_int8_guide
            return make_int8_guide(self)
        if dtype in (None, "auto"):
            dtype = torch.float32
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"guide dtype {dtype!r}: float32 (None or "
                             "'auto'), torch.bfloat16 or 'int8'")
        return AgentGuide(self.encoder, self.backward, self.prototype,
                          self.config.z_dim, dtype)


def small_light_indices(scene: Scene, radius_below: float = 0.5
                        ) -> np.ndarray:
    """Emissive spheres with radius < 0.5: the reference's "small lights"
    (FB/fb_vs_traditional_chandelier.py:802-804)."""
    em = scene.emitive.detach().cpu().numpy() > 0
    sm = scene.radius.detach().cpu().numpy() < radius_below
    return np.nonzero(em & sm)[0]
