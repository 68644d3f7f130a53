"""The inputs both sides get, made from ``--seed`` on the device.

A frame's planes come from ``(seed, frame index)`` through a
``torch.Generator`` of the harness's own, so the reference draws the same
planes again after the window.  The FB agent's parameters come from the
seed in a few large draws on the device, in flax's initial distribution.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from .manifest import ROOT
from .reference import guides

_TRUNC_STD = 0.87962566103423978   # sd of a normal truncated at +-2


def frame_seed(seed: int, index: int) -> int:
    """A 62-bit generator seed for frame ``index`` of the run ``seed``
    (warm-up frames take negative indices)."""
    digest = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def planes(seed: int, index: int, *, width: int, height: int, spp: int,
           max_bounces: int, diffuse: bool, guided: bool,
           device) -> Dict[str, torch.Tensor]:
    """``jitter [spp, H, W, 2]`` and, where a diffuse bounce is possible,
    ``uniforms [L, R, 2]`` and, guided, ``fb_uniforms [L, R]``, drawn in
    that order."""
    g = torch.Generator(device=device)
    g.manual_seed(frame_seed(seed, index))
    R = spp * height * width
    out = {"jitter": torch.rand((spp, height, width, 2), generator=g,
                                device=device)}
    if diffuse:
        out["uniforms"] = torch.rand((max_bounces, R, 2), generator=g,
                                     device=device)
        if guided:
            out["fb_uniforms"] = torch.rand((max_bounces, R), generator=g,
                                            device=device)
    return out


def agent_params(seed: int, guide: dict, device) -> Dict[str, Dict[str,
                                                               torch.Tensor]]:
    """The encoder's and backward model's parameters under flax's names:
    kernels lecun-normal (a normal truncated at two standard deviations,
    variance ``1 / fan_in``), biases zero, LayerNorm scales one.  All
    kernels come from one uniform draw on the device, mapped through the
    inverse normal CDF."""
    shapes = guides.agent_params_shapes(guide["z_dim"], guide["e_hidden_dim"],
                                        guide["b_hidden_dim"])
    kernels = [(part, name, shape) for part, s in shapes.items()
               for name, shape in s.items() if name.endswith("/kernel")]
    total = sum(math.prod(shape) for _, _, shape in kernels)
    g = torch.Generator(device=device)
    g.manual_seed(frame_seed(seed, -1000))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-2.0), cdf(2.0)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    x = torch.clamp(x, -2.0, 2.0)
    out = {part: {} for part in shapes}
    at = 0
    for part, name, shape in kernels:
        n = math.prod(shape)
        std = math.sqrt(1.0 / guides.fan_in(name, shape)) / _TRUNC_STD
        out[part][name] = (x[at:at + n] * std).float().reshape(shape)
        at += n
    for part, s in shapes.items():
        for name, shape in s.items():
            if name.endswith("/scale"):
                out[part][name] = torch.ones(shape, device=device)
            elif not name.endswith("/kernel"):
                out[part][name] = torch.zeros(shape, device=device)
    return out


def prototype_seed(seed: int) -> int:
    """The seed of the agent's light-prototype draws (both sides)."""
    return frame_seed(seed, -2000)


def student_file(guide: dict, root=ROOT):
    """The student's npz, checked against the configuration's sha256."""
    path = root / guide["file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != guide["sha256"]:
        raise RuntimeError(f"{path}: sha256 {digest}, the configuration "
                           f"names {guide['sha256']}")
    return path
