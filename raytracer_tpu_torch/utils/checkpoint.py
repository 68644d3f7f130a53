"""FB checkpoints in the native npz format, both ways.

Counterpart of ``raytracer_tpu/utils/checkpoint.py`` (``save_fb``,
``load_fb``), with numpy alone.  The file holds each network's flattened
flax parameters under ``<part>::<flax path>``
(``encoder::ResidualBlock_0/LayerNorm_1/scale``, ``backward::Dense_0/
kernel``), ``__meta__`` (JSON: the config, the noise scale, the update
count) and ``__light_memory__ [M, z_dim]``.  Slim inference checkpoints
hold the encoder and the backward model only.  The port's parameter names
are flax's paths with ``.`` for ``/``, so ``save_fb`` writes exactly the
keys JAX's ``_flatten`` writes: a checkpoint of either package loads in
the other's ``load_fb``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..fb.config import FBConfig
from ..fb.networks import Encoder, initialise, make_networks

PARTS = ("encoder", "forward", "backward", "target_encoder")


def networks_for(config: FBConfig) -> Dict[str, nn.Module]:
    """The four networks of an FB agent (``FBParams``'s parts), zeroed."""
    enc, fwd, bwd = make_networks(config)
    target = Encoder(z_dim=config.z_dim, hidden_dim=config.e_hidden_dim,
                     obs_dim=config.obs_dim)
    return dict(zip(PARTS, (enc, fwd, bwd, target)))


@torch.no_grad()
def load_flat(module: nn.Module, flat: Mapping[str, np.ndarray],
              prefix: str = "") -> nn.Module:
    """Copy flattened flax parameters into ``module``: the parameter
    ``A.B.kernel`` reads ``flat[prefix + "A/B/kernel"]``, which must have
    its shape (flax's).  Raises ``KeyError`` for a missing key and
    ``ValueError`` on a shape mismatch, as JAX's ``_unflatten_like``
    does."""
    for name, param in module.named_parameters():
        key = prefix + name.replace(".", "/")
        if key not in flat:
            raise KeyError(f"checkpoint has no {key!r}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{arr.shape} vs model {tuple(param.shape)}")
        param.copy_(torch.from_numpy(arr.astype(np.float32)))
    return module


def params_from_flat(flat: Mapping[str, np.ndarray], config: FBConfig,
                     seed: int = 0) -> Dict[str, nn.Module]:
    """The four networks from flattened flax keys, exactly what JAX's
    ``_flatten`` writes (``encoder::Dense_0/kernel``, ...).  A part with no
    key keeps its initial values from ``seed`` (JAX ``load_fb`` keeps its
    fresh initialisation: slim checkpoints have no forward model)."""
    nets = networks_for(config)
    gen = torch.Generator().manual_seed(seed)
    for name, net in nets.items():
        prefix = name + "::"
        if any(k.startswith(prefix) for k in flat):
            load_flat(net, flat, prefix)
        else:
            initialise(net, gen)
    return nets


def load_fb(path, config: FBConfig
            ) -> Tuple[Dict[str, nn.Module], dict, dict]:
    """Read a native FB checkpoint into networks for ``config`` (on the
    CPU).  Returns ``(networks, the file's config dict, extra)``, ``extra``
    with ``light_memory`` (a list of ``[z_dim]`` rows), ``noise_scale`` and
    ``updates``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if "::" in k}
        light_memory = list(data["__light_memory__"])
    nets = params_from_flat(flat, config)
    extra = {"light_memory": light_memory,
             "noise_scale": meta.get("noise_scale"),
             "updates": meta.get("updates")}
    return nets, meta.get("config", {}), extra


def flat_params(module: nn.Module, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of ``load_flat``: ``{prefix + flax path: float32 numpy}``
    for every parameter of ``module``."""
    return {prefix + name.replace(".", "/"):
            param.detach().cpu().numpy().astype(np.float32)
            for name, param in module.named_parameters()}


def save_fb(path, nets: Mapping[str, nn.Module], config: FBConfig,
            **extra) -> None:
    """Write ``nets`` (the four parts of ``PARTS``) in JAX ``save_fb``'s
    layout (:44-57): flattened parameters, ``__meta__`` with the config,
    ``noise_scale`` and ``updates``, and ``__light_memory__`` (``[0,
    z_dim]`` when empty)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for name in PARTS:
        flat.update(flat_params(nets[name], prefix=f"{name}::"))
    meta = {"config": config.to_dict(),
            "noise_scale": float(extra.get("noise_scale", 0.0)),
            "updates": int(extra.get("updates", 0))}
    lm = extra.get("light_memory") or []
    np.savez(path, __meta__=json.dumps(meta),
             __light_memory__=(np.stack(lm) if lm
                               else np.zeros((0, config.z_dim), np.float32)),
             **flat)
