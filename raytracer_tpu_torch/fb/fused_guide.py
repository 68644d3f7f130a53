"""The f32 guide's forward on the card: the products, then one row kernel a
layer.

``fb/inference.py::AgentGuide`` takes this route (its ``fused`` flag, set
when it is built) where the networks' widths are ones the kernel takes
(``fits``: ``FBConfig()``'s among them), the networks lie on a CUDA device
and the guide runs in float32.  It reads the ``Encoder`` and
``BackwardModel`` modules' own parameters and calls ``torch.matmul`` on
their kernels as ``networks.Dense`` does; what follows each product (bias,
LayerNorm, ReLU, residual add) is one call of
``core/cuda_norm.py::guide_norm``: the kernel on the card, the module
path's own ops on the CPU, where this forward equals the modules bit for
bit.  Sixteen calls a guide call: the encoder's
input projection, two in each of its three residual blocks, the
attention's value and out projections, ``Dense_1`` and ``Dense_2``; the
backward trunk's input projection and two in each of its two blocks.  The
2-wide mean head, its ``tanh`` and ``· 0.95`` stay the module's.

The learner's updates (autograd through the modules), the bf16 and int8
guides, every CPU caller and agents at other widths (``FBConfig.
output6_legacy``'s ``2 · z_dim`` of 64, the recipes' cut-down widths) keep
the module path; an ``AgentGuide`` call on a card that runs the modules
counts ``guide_module_calls`` (``utils/profiling.py::counters``).  The two
paths share the parameters only.
"""
from __future__ import annotations

import math

import torch

from ..core.cuda_norm import WIDTHS, guide_norm


def fits(encoder, backward) -> bool:
    """Whether every site's width is one the kernel takes: the encoder's
    hidden width (its input projection, blocks, attention and ``Dense_1``),
    its output ``2 · z_dim`` and the backward trunk's width."""
    return all(math.prod(d.out_shape) in WIDTHS for d in (
        encoder.Dense_0, encoder.Dense_2, backward.Dense_0))


def _product(x: torch.Tensor, dense) -> torch.Tensor:
    return torch.matmul(x, dense.kernel.reshape(math.prod(dense.in_shape),
                                                -1))


def _layer(x, dense, ln=None, post=None) -> torch.Tensor:
    return guide_norm(_product(x, dense), dense.bias.reshape(-1), ln, post)


def _block(block, x) -> torch.Tensor:
    h = _layer(x, block.Dense_0, block.LayerNorm_0, "relu")
    return _layer(h, block.Dense_1, block.LayerNorm_1, x)


def encode(encoder, obs: torch.Tensor) -> torch.Tensor:
    """``Encoder.forward``: ``mean ‖ log_var`` of ``obs [R, 22]``."""
    x = _layer(obs, encoder.Dense_0, encoder.LayerNorm_0, "relu")
    for i in range(encoder.num_res_blocks):
        x = _block(getattr(encoder, f"ResidualBlock_{i}"), x)
    attn = encoder.MultiHeadDotProductAttention_0
    v = _layer(x, attn.value)
    x = _layer(v, attn.out, post=x)
    x = _layer(x, encoder.Dense_1, post="relu")
    return _layer(x, encoder.Dense_2)


def action_mean(encoder, backward, obs: torch.Tensor,
                prototype: torch.Tensor, z_dim: int) -> torch.Tensor:
    """``AgentGuide``'s action mean ``[R, 2]``: the backward model's mean
    head on ``(encode(obs)[:, :z_dim], prototype)``."""
    z = encode(encoder, obs)[:, :z_dim]
    x = torch.cat([z, prototype.expand(z.shape[0], -1)], dim=-1)
    x = _layer(x, backward.Dense_0, backward.LayerNorm_0, "relu")
    for i in range(backward.num_layers):
        x = _block(getattr(backward, f"ResidualBlock_{i}"), x)
    return backward.action_mean(x)
