"""Forward-Backward representation networks as ``torch.nn`` modules.

Counterpart of ``raytracer_tpu/fb/networks.py`` (flax.linen), inference
side: ``ResidualBlock``, ``Encoder``, ``ForwardModel``, ``BackwardModel``
and ``make_networks``.  Every module keeps flax's parameter names and
shapes, so a flax parameter path such as
``ResidualBlock_0/LayerNorm_1/scale`` is the module's parameter
``ResidualBlock_0.LayerNorm_1.scale`` (``utils/checkpoint.py::
params_from_flat`` copies them across).  Kernels are ``[in, out]`` and a
layer is ``x @ kernel + bias``, two roundings, as flax's ``Dense``.

The arithmetic is flax's, in the parameters' dtype (f32, or bf16 for the
bf16 guide), with two exceptions stated where they happen: dropout is the
identity (the learner's loss runs flax's modules deterministic too), and
the single-token attention skips its query and key projections.  Products
are ``torch.matmul``; the JAX package leaves them to XLA, outside any
Pallas kernel.  Parameters carry no gradient until the learner
(``fb/agent.py``) asks for one.  The ``Simple*`` modules are the earlier
"simple" FB family of the reference's ``fb_model_simple.pth``, read by
``utils/torch_import.py``.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from .config import FBConfig

# flax's LayerNorm epsilon (torch's LayerNorm uses 1e-5).
LAYER_NORM_EPS = 1e-6
# jax.nn.initializers.lecun_normal: a normal truncated at two standard
# deviations, its scale divided by the truncated normal's own std.
_TRUNC_STD = 0.87962566103423978

Shape = Union[int, Sequence[int]]


def _param(t: torch.Tensor) -> nn.Parameter:
    # No gradient by default (the guide); the layers' in-place updates of
    # their own intermediates are ones autograd can differentiate.
    return nn.Parameter(t, requires_grad=False)


def _shape(s: Shape) -> Tuple[int, ...]:
    return (int(s),) if isinstance(s, int) else tuple(int(v) for v in s)


class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral``: ``kernel [*in, *out]``, ``bias
    [*out]``, kept in flax's shapes; the input's last axis holds the
    flattened ``in`` features and the output the flattened ``out`` ones
    (heads outer, as ``DenseGeneral`` flattens)."""

    def __init__(self, in_features: Shape, out_features: Shape):
        super().__init__()
        self.in_shape, self.out_shape = _shape(in_features), _shape(
            out_features)
        self.kernel = _param(torch.zeros(self.in_shape + self.out_shape))
        self.bias = _param(torch.zeros(self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.reshape(math.prod(self.in_shape), -1)
        return torch.matmul(x, k).add_(self.bias.reshape(-1))


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` over the last axis, in its order: statistics in
    f32 as ``mean = E[x]``, ``var = max(0, E[x²] − mean²)``
    (``use_fast_variance``), then ``(x − mean) · (rsqrt(var + 1e-6) ·
    scale) + bias``.  ``F.layer_norm`` takes ε = 1e-5 and a two-pass
    variance, so it is not used.  A bf16 input is normalised in f32 and
    rounded to bf16 once at the end, as flax 0.12's
    ``force_float32_reductions`` does (``_compute_stats``, ``_normalize``:
    at least f32, so f64 stays f64)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = _param(torch.ones(dim))
        self.bias = _param(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x if x.dtype.itemsize >= 4 else x.float()
        mean = xf.mean(-1, keepdim=True)
        mean2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * self.scale.to(xf.dtype)
        return (xf - mean).mul_(mul).add_(self.bias.to(xf.dtype)).to(x.dtype)


class SingleTokenAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` on one token (the encoder's
    ``x[..., None, :]``): the softmax over one key is exactly 1.0, so the
    output is exactly ``out(value(x))``.  The query and key projections are
    skipped, which differs from flax only where a score ``q·k/√d`` is NaN
    or infinite (flax then gives NaN).  Their weights are held, unused, so
    a checkpoint keeps them both ways; their gradient is exactly 0 in flax
    (the softmax of one score is constant), so the learner leaves them as
    flax's Adam does."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        head = (num_heads, dim // num_heads)
        self.query = Dense(dim, head)
        self.key = Dense(dim, head)
        self.value = Dense(dim, head)
        self.out = Dense(head, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.value(x))


class ResidualBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = Dense(dim, dim)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_1 = Dense(dim, dim)
        self.LayerNorm_1 = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu_(self.LayerNorm_0(self.Dense_0(x)))
        return self.LayerNorm_1(self.Dense_1(h)).add_(x)


class Encoder(nn.Module):
    """A 22-D observation to ``mean ‖ log_var`` of the z-distribution: input
    projection (Dense, LayerNorm, ReLU; flax's Dropout(0.1) is the
    identity at inference), residual blocks, the single-token attention
    with a residual add, then Dense, ReLU, Dense to ``2·z_dim``."""

    def __init__(self, z_dim: int = 64, hidden_dim: int = 512,
                 num_res_blocks: int = 3, num_attn_heads: int = 4,
                 obs_dim: int = 22):
        super().__init__()
        self.z_dim = z_dim
        self.Dense_0 = Dense(obs_dim, hidden_dim)
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        for i in range(num_res_blocks):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(hidden_dim))
        self.num_res_blocks = num_res_blocks
        self.MultiHeadDotProductAttention_0 = SingleTokenAttention(
            hidden_dim, num_attn_heads)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        self.Dense_2 = Dense(hidden_dim, 2 * z_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu_(self.LayerNorm_0(self.Dense_0(x)))
        for i in range(self.num_res_blocks):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        x = self.MultiHeadDotProductAttention_0(x).add_(x)
        x = torch.relu_(self.Dense_1(x))
        return self.Dense_2(x)

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)[..., :self.z_dim]


class ForwardModel(nn.Module):
    """``(z, action)`` to one ``(mean, log_var)`` next-z prediction a head:
    input projection, ``num_layers`` GLU blocks, ``num_heads`` heads."""

    def __init__(self, z_dim: int = 64, action_dim: int = 2,
                 hidden_dim: int = 512, num_heads: int = 3,
                 num_layers: int = 2):
        super().__init__()
        self.z_dim, self.num_heads, self.num_layers = (z_dim, num_heads,
                                                       num_layers)
        self.Dense_0 = Dense(z_dim + action_dim, hidden_dim)
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        n = 1
        for _ in range(num_layers):
            self.add_module(f"Dense_{n}", Dense(hidden_dim, 2 * hidden_dim))
            n += 1
        for _ in range(num_heads):
            self.add_module(f"Dense_{n}", Dense(hidden_dim, hidden_dim))
            self.add_module(f"Dense_{n + 1}", Dense(hidden_dim, 2 * z_dim))
            n += 2

    def forward(self, z: torch.Tensor, action: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        x = torch.cat([z, action], dim=-1)
        x = torch.relu_(self.LayerNorm_0(self.Dense_0(x)))
        n = 1
        for _ in range(self.num_layers):
            a, b = getattr(self, f"Dense_{n}")(x).chunk(2, dim=-1)
            x = a * torch.sigmoid(b)                          # GLU
            n += 1
        preds = []
        for _ in range(self.num_heads):
            h = torch.relu_(getattr(self, f"Dense_{n}")(x))
            p = getattr(self, f"Dense_{n + 1}")(h)
            preds.append((p[..., :self.z_dim], p[..., self.z_dim:]))
            n += 2
        return preds


class BackwardModel(nn.Module):
    """``(z_t, z_next)`` to ``(action mean in [-0.95, 0.95]², action
    log_var)``: input projection, residual blocks, two heads."""

    def __init__(self, z_dim: int = 64, action_dim: int = 2,
                 hidden_dim: int = 256, num_layers: int = 2):
        super().__init__()
        self.Dense_0 = Dense(2 * z_dim, hidden_dim)
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        for i in range(num_layers):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(hidden_dim))
        self.num_layers = num_layers
        self.Dense_1 = Dense(hidden_dim, action_dim)
        self.Dense_2 = Dense(hidden_dim, action_dim)

    def trunk(self, z_t: torch.Tensor, z_next: torch.Tensor) -> torch.Tensor:
        x = torch.cat([z_t, z_next], dim=-1)
        x = torch.relu_(self.LayerNorm_0(self.Dense_0(x)))
        for i in range(self.num_layers):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return x

    def action_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean head on the trunk's output ``x``.  The 0.95 is rounded
        to ``x``'s dtype first, as JAX rounds a weakly typed constant
        (bf16: 0.94921875)."""
        a = torch.tanh(self.Dense_1(x))
        return a * torch.full((), 0.95, dtype=a.dtype, device=a.device)

    def forward(self, z_t: torch.Tensor, z_next: torch.Tensor):
        x = self.trunk(z_t, z_next)
        return self.action_mean(x), self.Dense_2(x)


class SimpleEncoder(nn.Module):
    """The earlier "simple" family's encoder (``fb_model_simple.pth``,
    net.0/2/4: 22 -> 128 -> 128 -> 2·z_dim): a ReLU MLP emitting
    ``mean ‖ log_var``."""

    def __init__(self, z_dim: int = 32, hidden_dim: int = 128,
                 obs_dim: int = 22):
        super().__init__()
        self.Dense_0 = Dense(obs_dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        self.Dense_2 = Dense(hidden_dim, 2 * z_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu_(self.Dense_0(x))
        x = torch.relu_(self.Dense_1(x))
        return self.Dense_2(x)


class SimpleForwardModel(nn.Module):
    """``(z ‖ action)`` -> hidden -> hidden, then one mean-only next-z
    prediction a head."""

    def __init__(self, z_dim: int = 32, hidden_dim: int = 128,
                 num_heads: int = 2, action_dim: int = 2):
        super().__init__()
        self.num_heads = num_heads
        self.Dense_0 = Dense(z_dim + action_dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        for h in range(num_heads):
            self.add_module(f"Dense_{2 + h}", Dense(hidden_dim, z_dim))

    def forward(self, z: torch.Tensor, action: torch.Tensor
                ) -> List[torch.Tensor]:
        x = torch.cat([z, action], dim=-1)
        x = torch.relu_(self.Dense_0(x))
        x = torch.relu_(self.Dense_1(x))
        return [getattr(self, f"Dense_{2 + h}")(x)
                for h in range(self.num_heads)]


class SimpleBackwardModel(nn.Module):
    """``(z_t ‖ z_next)`` -> hidden -> hidden -> ``tanh`` action."""

    def __init__(self, hidden_dim: int = 64, action_dim: int = 2,
                 z_dim: int = 32):
        super().__init__()
        self.Dense_0 = Dense(2 * z_dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, hidden_dim)
        self.Dense_2 = Dense(hidden_dim, action_dim)

    def forward(self, z_t: torch.Tensor, z_next: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([z_t, z_next], dim=-1)
        x = torch.relu_(self.Dense_0(x))
        x = torch.relu_(self.Dense_1(x))
        return torch.tanh(self.Dense_2(x))


def make_networks(cfg: FBConfig):
    """``(encoder, forward, backward)`` for ``cfg``, parameters zero until
    ``initialise`` or a checkpoint fills them (JAX ``make_networks``)."""
    enc = Encoder(z_dim=cfg.z_dim, hidden_dim=cfg.e_hidden_dim,
                  obs_dim=cfg.obs_dim)
    fwd = ForwardModel(z_dim=cfg.z_dim, action_dim=cfg.action_dim,
                       hidden_dim=cfg.f_hidden_dim,
                       num_heads=cfg.num_forward_heads,
                       num_layers=cfg.num_layers)
    bwd = BackwardModel(z_dim=cfg.z_dim, action_dim=cfg.action_dim,
                        hidden_dim=cfg.b_hidden_dim, num_layers=2)
    return enc, fwd, bwd


def _lecun_normal(shape, fan_in: int, generator: torch.Generator
                  ) -> torch.Tensor:
    """flax's ``lecun_normal`` by the inverse normal CDF on the generator's
    uniforms (its bits are not JAX's): a normal truncated to [-2, 2],
    scaled to variance ``1 / fan_in``."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-2.0), cdf(2.0)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return (torch.clamp(x, -2.0, 2.0) * std).float()


@torch.no_grad()
def initialise(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initial values, drawn by ``generator`` on the CPU in module
    order: lecun-normal kernels (fan-in over the ``in`` axes), zero biases,
    unit LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.kernel.copy_(_lecun_normal(m.kernel.shape,
                                         math.prod(m.in_shape), generator))
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    return module
