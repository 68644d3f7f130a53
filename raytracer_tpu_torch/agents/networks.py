"""Policy and value networks of the RL agents, and the weights' file layout.

Counterpart of ``raytracer_tpu/agents/networks.py`` (flax.linen; SB3's
"MlpPolicy" widths: 64x64 tanh for PPO, 256x256 ReLU for SAC).  Each
module's attributes carry the flax scope names (``MLP_0``, ``Dense_1``,
...), so a flax parameter path ``MLP_0/Dense_0/kernel`` is the state-dict
key ``MLP_0.Dense_0.weight``: ``flax_to_state`` and ``state_to_flax`` carry
weights across, each ``[in, out]`` kernel transposed to ``nn.Linear``'s
``[out, in]`` weight.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..fb.networks import _lecun_normal

OBS_DIM = 18
ACTION_DIM = 2


class MLP(nn.Module):
    """Dense layers ``Dense_0 .. Dense_{k-1}``, each followed by the
    activation."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 activation: str = "tanh"):
        super().__init__()
        self.act = {"tanh": torch.tanh, "relu": torch.relu}[activation]
        dims = [in_dim, *features]
        for i in range(len(features)):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.depth = len(features)

    def forward(self, x):
        for i in range(self.depth):
            x = self.act(getattr(self, f"Dense_{i}")(x))
        return x


class PPOActorCritic(nn.Module):
    """``(mean, log_std, value)``: a tanh policy trunk and head, the
    state-independent ``log_std`` parameter, a tanh value trunk and head."""

    def __init__(self, action_dim: int = ACTION_DIM,
                 hidden: Tuple[int, ...] = (64, 64), obs_dim: int = OBS_DIM):
        super().__init__()
        self.MLP_0 = MLP(obs_dim, hidden, "tanh")
        self.Dense_0 = nn.Linear(hidden[-1], action_dim)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.MLP_1 = MLP(obs_dim, hidden, "tanh")
        self.Dense_1 = nn.Linear(hidden[-1], 1)

    def forward(self, obs):
        mean = self.Dense_0(self.MLP_0(obs))
        value = self.Dense_1(self.MLP_1(obs))[..., 0]
        return mean, self.log_std, value


class SACActor(nn.Module):
    """``(mean, log_std)`` of the pre-squash Gaussian, log_std clipped to
    [-20, 2]."""

    def __init__(self, action_dim: int = ACTION_DIM,
                 hidden: Tuple[int, ...] = (256, 256),
                 obs_dim: int = OBS_DIM):
        super().__init__()
        self.MLP_0 = MLP(obs_dim, hidden, "relu")
        self.Dense_0 = nn.Linear(hidden[-1], action_dim)
        self.Dense_1 = nn.Linear(hidden[-1], action_dim)

    def forward(self, obs):
        x = self.MLP_0(obs)
        return self.Dense_0(x), torch.clamp(self.Dense_1(x), -20.0, 2.0)


class SACCritic(nn.Module):
    """Twin Q heads on ``concat(obs, action)``."""

    def __init__(self, hidden: Tuple[int, ...] = (256, 256),
                 obs_dim: int = OBS_DIM, action_dim: int = ACTION_DIM):
        super().__init__()
        for q in (0, 1):
            self.add_module(f"MLP_{q}",
                            MLP(obs_dim + action_dim, hidden, "relu"))
            self.add_module(f"Dense_{q}", nn.Linear(hidden[-1], 1))

    def forward(self, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (self.Dense_0(self.MLP_0(x))[..., 0],
                self.Dense_1(self.MLP_1(x))[..., 0])


@torch.no_grad()
def initialise(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initial values drawn by ``generator`` (its bits are not
    JAX's): lecun-normal kernels, zero biases, ``log_std`` zero."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            w = _lecun_normal((m.in_features, m.out_features),
                              m.in_features, generator)
            m.weight.copy_(w.T)
            m.bias.zero_()
    return module


def hidden_of(state: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    """The trunk widths of a state dict (from ``MLP_0``'s layers)."""
    widths, i = [], 0
    while f"MLP_0.Dense_{i}.weight" in state:
        widths.append(int(state[f"MLP_0.Dense_{i}.weight"].shape[0]))
        i += 1
    return tuple(widths)


def flax_to_state(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"MLP_0/Dense_0/kernel": [in, out], ...}`` (flax paths under one
    tree) to a state dict: ``/`` to ``.``, ``kernel`` to ``weight``
    transposed."""
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if parts[-1] == "kernel":
            parts[-1], t = "weight", t.T.contiguous()
        state[".".join(parts)] = t
    return state


def state_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of :func:`flax_to_state` on a module's state dict."""
    flat = {}
    for key, t in module.state_dict().items():
        parts = key.split(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        if parts[-1] == "weight":
            parts[-1], a = "kernel", np.ascontiguousarray(a.T)
        flat["/".join(parts)] = a
    return flat


def load_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``module`` in place (shapes must match)."""
    module.load_state_dict({k: v.to(torch.float32) for k, v in state.items()},
                           strict=True)


def nest_flat(flat: dict) -> dict:
    """``{"a/b/c": x}`` to ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten_tree(tree, prefix: str = "") -> dict:
    """Inverse of :func:`nest_flat` (leaves as numpy arrays)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out
