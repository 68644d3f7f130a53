"""Distilled FB students: the deployment guide ``obs[R, 22] -> action[R, 2]``.

Counterpart of the inference side of ``raytracer_tpu/fb/distill.py``:
``StudentPolicy`` (a ReLU MLP with a raw output), ``DistilledGuide`` with its
flat-npz ``load``, and ``as_guide_fn``.  Training stays with the JAX package.

``as_guide_fn(dtype="auto")`` runs the student in bfloat16 in the order
flax's ``Dense`` chain has under XLA: observations and parameters rounded to
bf16; per layer an f32-accumulated product of the bf16 values, rounded to
bf16, then ``+ bias`` in bf16 (a second rounding), then ReLU.  The output
layer's product is rounded to bf16 too, but its bias add stays in f32: XLA
folds that add's bf16 round trip into the cast to the f32 output (measured
on the CPU, every output equal).  ``dtype=None`` is exact f32 (``x @ W + b``
per layer).  The guide
carries its layers, so the path kernels can run the same student inside
themselves (``core/cuda_path.py``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

OBS_DIM = 22
ACTION_DIM = 2


class StudentPolicy(nn.Module):
    """Linear layers with ReLU between them and a raw output, f32."""

    def __init__(self, hidden: Sequence[int] = (64, 64),
                 obs_dim: int = OBS_DIM, action_dim: int = ACTION_DIM):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        dims = (obs_dim,) + self.hidden + (action_dim,)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _flat_params(params: Mapping) -> Dict[str, np.ndarray]:
    """``{"Dense_i/kernel": [in, out], "Dense_i/bias": [out]}`` from the JAX
    package's nested params (``params["Dense_i"]["kernel"]``) or from the
    flat npz keys; other keys (``__hidden__``, ``__obs_dim__``) dropped."""
    flat = {}
    for k, v in params.items():
        if k.startswith("__"):
            continue
        if isinstance(v, Mapping):
            for name in ("kernel", "bias"):
                flat[f"{k}/{name}"] = np.asarray(v[name], np.float32)
        else:
            flat[k] = np.asarray(v, np.float32)
    return flat


def _layer_arrays(params: Mapping) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                            ...]:
    flat = _flat_params(params)
    n = len({k.split("/")[0] for k in flat})
    return tuple((flat[f"Dense_{i}/kernel"], flat[f"Dense_{i}/bias"])
                 for i in range(n))


def state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's student params as a ``StudentPolicy`` state dict.
    flax keeps ``kernel [in, out]``; ``nn.Linear`` keeps ``weight [out,
    in]``, so each kernel is transposed."""
    sd = {}
    for i, (k, b) in enumerate(_layer_arrays(params)):
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.T))
        sd[f"layers.{i}.bias"] = torch.from_numpy(b.copy())
    return sd


class StudentGuide:
    """A student as a guide: ``guide(obs [R, 22]) -> action [R, 2]`` f32.

    ``layers``: ``((kernel [in, out], bias [out]), ...)`` float32 CPU
    tensors, already rounded to bf16 when ``dtype == "bfloat16"``;
    ``dtype``: ``"bfloat16"`` or None (exact f32)."""

    def __init__(self, layers, dtype: Optional[str]):
        if dtype not in ("bfloat16", None):
            raise ValueError(f"unsupported guide dtype {dtype!r}")
        self.dtype = dtype
        q = ((lambda t: t.bfloat16().float()) if dtype == "bfloat16"
             else (lambda t: t))
        self.layers = tuple((q(torch.as_tensor(k, dtype=torch.float32)),
                             q(torch.as_tensor(b, dtype=torch.float32)))
                            for k, b in layers)
        self.hidden = tuple(k.shape[1] for k, _ in self.layers[:-1])
        self._on: Dict[torch.device, tuple] = {}

    def layers_on(self, device) -> tuple:
        """The layers on ``device`` (copied once per device)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple((k.to(device), b.to(device))
                                     for k, b in self.layers)
        return self._on[device]

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.float()
        layers = self.layers_on(x.device)
        bf16 = self.dtype == "bfloat16"
        if bf16:
            x = x.bfloat16()
        last = len(layers) - 1
        for i, (k, b) in enumerate(layers):
            if not bf16:
                x = torch.matmul(x, k) + b
            elif i < last:
                # f32-accumulated product of bf16 values, rounded to bf16;
                # then + bias in bf16 (flax Dense under XLA, in that order).
                x = torch.matmul(x.float(), k).bfloat16() + b.bfloat16()
            else:
                # The output layer: XLA drops the bf16 round trip of the
                # bias add before the f32 cast, so the add stays in f32.
                x = torch.matmul(x.float(), k).bfloat16().float() + b
            if i < last:
                x = torch.relu(x)
        return x.float()


class DistilledGuide:
    """Deployment guide: ``obs[R, 22] -> action[R, 2]`` through the
    student."""

    def __init__(self, params: Mapping, hidden: Sequence[int] = (64, 64)):
        self.hidden = tuple(int(h) for h in hidden)
        self.layers = _layer_arrays(params)
        widths = tuple(k.shape[1] for k, _ in self.layers[:-1])
        if widths != self.hidden:
            raise ValueError(f"params have hidden widths {widths}, "
                             f"not {self.hidden}")

    def module(self) -> StudentPolicy:
        """The student as an f32 ``StudentPolicy``."""
        m = StudentPolicy(self.hidden, self.layers[0][0].shape[0],
                          self.layers[-1][0].shape[1])
        m.load_state_dict(state_dict_from_params(
            {f"Dense_{i}": {"kernel": k, "bias": b}
             for i, (k, b) in enumerate(self.layers)}))
        return m

    def as_guide_fn(self, dtype="auto") -> StudentGuide:
        """``"auto"``: bfloat16 in flax's order (the deployed mode; JAX
        ``as_guide_fn``'s default); None: exact f32."""
        if dtype == "auto" or dtype is torch.bfloat16:
            dtype = "bfloat16"
        return StudentGuide(self.layers, dtype)

    @staticmethod
    def load(path) -> "DistilledGuide":
        """Read the flat npz the JAX package saves (``__hidden__``,
        ``__obs_dim__``, ``Dense_i/kernel``, ``Dense_i/bias``)."""
        with np.load(path) as z:
            hidden = tuple(int(h) for h in z["__hidden__"])
            flat = {k: z[k] for k in z.files}
        return DistilledGuide(flat, hidden)
