"""Import the reference's PyTorch FB checkpoints (``.pth``) into the port's
networks.

Counterpart of ``raytracer_tpu/utils/torch_import.py``, for both network
families:

* the "Enhanced" family (FB/fb_vs_traditional_complex.py:37-142;
  checkpoint schema: top-level ``fb_learner_state`` ->
  ``{encoder, forward_model, backward_model}`` state dicts) into
  ``fb/networks.py``'s ``Encoder``, ``ForwardModel``, ``BackwardModel``;
* the earlier "simple" family of ``fb_model_simple.pth`` (flat
  ``{encoder, forward_model, backward_model, config, train_steps}``) into
  the ``Simple*`` modules.

The port's parameters carry flax's names and shapes, so each import maps
the reference's keys onto flax paths, as JAX's does: a ``Linear.weight``
``[out, in]`` is transposed into a kernel ``[in, out]``; ``LayerNorm``'s
``weight`` is the ``scale``; ``MultiheadAttention.in_proj_weight [3H, H]``
splits into the query, key and value kernels ``[H, heads, head_dim]``.

``load_torch_checkpoint`` reads the file with an unpickler of its own: the
classes the reference pickled from its ``fb_ray_tracing`` module (absent
here) become empty placeholder classes, and nothing enters
``sys.modules``.
"""
from __future__ import annotations

import pickle
import types
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..fb.config import FBConfig
from ..fb.networks import (SimpleBackwardModel, SimpleEncoder,
                           SimpleForwardModel, make_networks)
from .checkpoint import load_flat

MISSING_MODULE = "fb_ray_tracing"


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float32)


def _dense(sd, name, path):
    return {f"{path}/kernel": _np(sd[f"{name}.weight"]).T,
            f"{path}/bias": _np(sd[f"{name}.bias"])}


def _layernorm(sd, name, path):
    return {f"{path}/scale": _np(sd[f"{name}.weight"]),
            f"{path}/bias": _np(sd[f"{name}.bias"])}


def _attention(sd, name, path, num_heads):
    w_in = _np(sd[f"{name}.in_proj_weight"])              # [3H, H]
    b_in = _np(sd[f"{name}.in_proj_bias"])                # [3H]
    H = w_in.shape[1]
    hd = H // num_heads
    out = {}
    for i, part in enumerate(("query", "key", "value")):
        w = w_in[i * H:(i + 1) * H]                       # [H, H] (out, in)
        out[f"{path}/{part}/kernel"] = w.T.reshape(H, num_heads, hd)
        out[f"{path}/{part}/bias"] = b_in[i * H:(i + 1) * H].reshape(
            num_heads, hd)
    wo = _np(sd[f"{name}.out_proj.weight"])               # [H, H] (out, in)
    out[f"{path}/out/kernel"] = wo.T.reshape(num_heads, hd, H)
    out[f"{path}/out/bias"] = _np(sd[f"{name}.out_proj.bias"])
    return out


def _res_block(sd, prefix, path):
    """The reference's ResidualBlock ``net = [Linear, LayerNorm, ReLU,
    Linear, LayerNorm]``."""
    return {**_dense(sd, f"{prefix}.net.0", f"{path}/Dense_0"),
            **_layernorm(sd, f"{prefix}.net.1", f"{path}/LayerNorm_0"),
            **_dense(sd, f"{prefix}.net.3", f"{path}/Dense_1"),
            **_layernorm(sd, f"{prefix}.net.4", f"{path}/LayerNorm_1")}


def import_enhanced_encoder(sd, num_attn_heads: int = 4) -> Dict:
    """EnhancedEncoder state dict -> ``Encoder``'s flat flax parameters."""
    p = {**_dense(sd, "input_proj.0", "Dense_0"),
         **_layernorm(sd, "input_proj.1", "LayerNorm_0"),
         **_attention(sd, "attention", "MultiHeadDotProductAttention_0",
                      num_attn_heads),
         **_dense(sd, "output.0", "Dense_1"),
         **_dense(sd, "output.2", "Dense_2")}
    for i in range(3):
        p.update(_res_block(sd, f"res_blocks.{i}", f"ResidualBlock_{i}"))
    return p


def import_enhanced_forward(sd, num_heads: int, num_layers: int) -> Dict:
    """EnhancedForwardModel -> ``ForwardModel``: the input layer, a GLU
    layer a block, then each head's hidden and output layers."""
    p = {**_dense(sd, "input_net.0", "Dense_0"),
         **_layernorm(sd, "input_net.1", "LayerNorm_0")}
    d = 1
    for i in range(num_layers):
        p.update(_dense(sd, f"gated_blocks.{i}.0", f"Dense_{d}"))
        d += 1
    for h in range(num_heads):
        p.update(_dense(sd, f"heads.{h}.0", f"Dense_{d}"))
        p.update(_dense(sd, f"heads.{h}.2", f"Dense_{d + 1}"))
        d += 2
    return p


def import_enhanced_backward(sd, num_layers: int = 2) -> Dict:
    p = {**_dense(sd, "input_net.0", "Dense_0"),
         **_layernorm(sd, "input_net.1", "LayerNorm_0"),
         **_dense(sd, "mean_head", "Dense_1"),
         **_dense(sd, "log_var_head", "Dense_2")}
    for i in range(num_layers):
        p.update(_res_block(sd, f"res_blocks.{i}", f"ResidualBlock_{i}"))
    return p


def import_simple_encoder(sd) -> Dict:
    return {**_dense(sd, "net.0", "Dense_0"), **_dense(sd, "net.2", "Dense_1"),
            **_dense(sd, "net.4", "Dense_2")}


def import_simple_forward(sd, num_heads: int = 2) -> Dict:
    p = {**_dense(sd, "input_layer", "Dense_0"),
         **_dense(sd, "hidden_layers.0", "Dense_1")}
    for h in range(num_heads):
        p.update(_dense(sd, f"heads.{h}", f"Dense_{2 + h}"))
    return p


def import_simple_backward(sd) -> Dict:
    return {**_dense(sd, "input_layer", "Dense_0"),
            **_dense(sd, "hidden_layers.0", "Dense_1"),
            **_dense(sd, "output_layer", "Dense_2")}


class _Unpickler(pickle.Unpickler):
    """Classes of the reference's ``fb_ray_tracing`` module become empty
    placeholders (its objects unpickle as plain attribute bags)."""

    def find_class(self, module, name):
        if module == MISSING_MODULE or module.startswith(MISSING_MODULE + "."):
            return type(name, (), {"__module__": module})
        return super().find_class(module, name)


def _pickle_module() -> types.ModuleType:
    """A pickle module for ``torch.load`` with ``_Unpickler``; it is not
    registered in ``sys.modules``."""
    mod = types.ModuleType("pth_unpickle")
    mod.Unpickler = _Unpickler
    mod.load = lambda f, **kw: _Unpickler(f, **kw).load()
    return mod


def load_torch_checkpoint(path) -> Dict:
    """Read a reference ``.pth`` on the CPU; the ``fb_learner_state`` schema
    is unwrapped to its ``{encoder, forward_model, backward_model}``.  It
    unpickles arbitrary objects: read only checkpoints you trust."""
    ck = torch.load(path, map_location="cpu", weights_only=False,
                    pickle_module=_pickle_module())
    if "fb_learner_state" in ck:
        ck = ck["fb_learner_state"]
    return ck


def import_fb_learner_state(ck: Dict, config: FBConfig
                            ) -> Dict[str, nn.Module]:
    """``fb_learner_state`` -> the Enhanced family's ``encoder``,
    ``forward`` and ``backward`` networks for ``config`` (on the CPU)."""
    enc, fwd, bwd = make_networks(config)
    load_flat(enc, import_enhanced_encoder(ck["encoder"]))
    load_flat(fwd, import_enhanced_forward(ck["forward_model"],
                                           config.num_forward_heads,
                                           config.num_layers))
    load_flat(bwd, import_enhanced_backward(ck["backward_model"]))
    return {"encoder": enc, "forward": fwd, "backward": bwd}


def import_simple(ck: Dict, num_heads: int = 2) -> Dict[str, nn.Module]:
    """A ``fb_model_simple.pth`` checkpoint -> the ``Simple*`` networks,
    their widths read from the state dicts."""
    e, f, b = ck["encoder"], ck["forward_model"], ck["backward_model"]
    z_dim = e["net.4.weight"].shape[0] // 2
    enc = SimpleEncoder(z_dim=z_dim, hidden_dim=e["net.0.weight"].shape[0],
                        obs_dim=e["net.0.weight"].shape[1])
    fwd = SimpleForwardModel(
        z_dim=z_dim, hidden_dim=f["input_layer.weight"].shape[0],
        num_heads=num_heads,
        action_dim=f["input_layer.weight"].shape[1] - z_dim)
    bwd = SimpleBackwardModel(
        hidden_dim=b["input_layer.weight"].shape[0],
        action_dim=b["output_layer.weight"].shape[0], z_dim=z_dim)
    load_flat(enc, import_simple_encoder(e))
    load_flat(fwd, import_simple_forward(f, num_heads))
    load_flat(bwd, import_simple_backward(b))
    return {"encoder": enc, "forward": fwd, "backward": bwd}
