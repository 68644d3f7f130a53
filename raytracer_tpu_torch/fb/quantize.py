"""Int8 quantized inference for the full FB agent's guide.

Counterpart of ``raytracer_tpu/fb/quantize.py`` (standard dynamic
post-training quantization):

* weights: symmetric per-output-channel int8, ``scale = max|w| / 127``,
  quantized once on the host with numpy's ``rint`` (``quantize_kernel``,
  bit for bit JAX's);
* activations: symmetric per-row dynamic int8, from the live batch;
* products: int8 × int8 accumulated in int32, rescaled by the outer product
  of the two scales, then the bias; LayerNorm (the *two-pass* variance with
  ``rsqrt``, not flax's one-pass form), residual adds and ``tanh`` stay f32.

The single-token attention is ``x + out(value(x))`` (fb/networks.py), so
the encoder runs two int8 products there.

The integer product is exact on both devices: ``torch._int_mm`` (cuBLASLt)
on the card, which wants the reduction and output widths in multiples of 8
and more than 16 rows, so the 22-wide observation, the 2-wide head and a
short batch are padded with zeros (which leaves every integer sum as it
is); the int32 ``torch.matmul`` on the CPU.  JAX computes it as an XLA
product outside any Pallas kernel, so only the rescale, ``rsqrt`` and
``tanh`` can differ from it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.vec import div_scalar

LN_EPS = 1e-6
# torch._int_mm (cuBLASLt int8): K and N multiples of 8, M above 16.
_MM_ALIGN = 8
_MM_MIN_ROWS = 17


def quantize_kernel(kernel: np.ndarray):
    """Symmetric per-output-channel int8: ``(int8 [in, out], f32 [out])``."""
    k = np.asarray(kernel, np.float32)
    scale = np.max(np.abs(k), axis=0) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(k / scale), -127, 127).astype(np.int8)
    return q, scale


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _qdense_params(kernel, bias) -> Dict[str, np.ndarray]:
    q, s = quantize_kernel(_np(kernel))
    return {"qkernel": q, "wscale": s,
            "bias": _np(bias).astype(np.float32)}


def _dense(layer):
    return _qdense_params(layer.kernel, layer.bias)


def _ln_params(ln):
    return {"scale": _np(ln.scale).astype(np.float32),
            "bias": _np(ln.bias).astype(np.float32)}


def _resblock_params(block):
    return {"Dense_0": _dense(block.Dense_0),
            "LayerNorm_0": _ln_params(block.LayerNorm_0),
            "Dense_1": _dense(block.Dense_1),
            "LayerNorm_1": _ln_params(block.LayerNorm_1)}


def quantize_agent_params(encoder, backward, proto) -> dict:
    """The guide's path quantized (JAX ``quantize_agent_params`` :86): the
    encoder without the attention's query and key or the log-variance half,
    and the backward model's trunk and mean head.  ``encoder``/``backward``
    are the port's modules (``fb/networks.py``); returns numpy arrays under
    JAX's keys (``encoder/attn_v/qkernel``, ...) and ``proto``."""
    attn = encoder.MultiHeadDotProductAttention_0
    vk, ok = _np(attn.value.kernel), _np(attn.out.kernel)
    d_in, n_h, d_h = vk.shape
    qe = {"Dense_0": _dense(encoder.Dense_0),
          "LayerNorm_0": _ln_params(encoder.LayerNorm_0),
          "attn_v": _qdense_params(vk.reshape(d_in, n_h * d_h),
                                   _np(attn.value.bias).reshape(n_h * d_h)),
          "attn_out": _qdense_params(ok.reshape(n_h * d_h, -1),
                                     attn.out.bias),
          "Dense_1": _dense(encoder.Dense_1),
          "Dense_2": _dense(encoder.Dense_2)}
    for i in range(encoder.num_res_blocks):
        qe[f"ResidualBlock_{i}"] = _resblock_params(
            getattr(encoder, f"ResidualBlock_{i}"))
    qb = {"Dense_0": _dense(backward.Dense_0),
          "LayerNorm_0": _ln_params(backward.LayerNorm_0),
          "ResidualBlock_0": _resblock_params(backward.ResidualBlock_0),
          "ResidualBlock_1": _resblock_params(backward.ResidualBlock_1),
          "Dense_1": _dense(backward.Dense_1)}
    return {"encoder": qe, "backward": qb,
            "proto": _np(proto).astype(np.float32)}


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


class QDense:
    """One quantized layer on a device: the int8 kernel (on the card padded
    with zero rows and columns to multiples of 8 and stored column-major, as
    cuBLASLt's int8 product takes it), the weight scales and the bias."""

    def __init__(self, p: dict, device: torch.device):
        q = torch.from_numpy(p["qkernel"])
        self.k_in, self.n_out = q.shape
        if device.type == "cuda":
            q = torch.nn.functional.pad(
                q, (0, _pad_to(self.n_out, _MM_ALIGN) - self.n_out,
                    0, _pad_to(self.k_in, _MM_ALIGN) - self.k_in))
            q = q.t().contiguous().t()
        else:
            q = q.to(torch.int32)
        self.qkernel = q.to(device)
        self.wscale = torch.from_numpy(p["wscale"]).to(device)
        self.bias = torch.from_numpy(p["bias"]).to(device)

    def int_product(self, qx: torch.Tensor) -> torch.Tensor:
        """``qx [M, in]`` int8 times the kernel, exact, int32 ``[M, out]``."""
        if qx.device.type != "cuda":
            return torch.matmul(qx.to(torch.int32), self.qkernel)
        m = qx.shape[0]
        k_pad = self.qkernel.shape[0]
        qx = torch.nn.functional.pad(
            qx, (0, k_pad - self.k_in, 0, max(_MM_MIN_ROWS - m, 0)))
        return torch._int_mm(qx, self.qkernel)[:m, :self.n_out]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """JAX ``_qdense`` :129: dynamic per-row int8 activations, the int8
        product in int32, the rescale and the bias."""
        sx = div_scalar(x.abs().amax(-1, keepdim=True), 127.0)
        sx = torch.where(sx > 0, sx, torch.ones_like(sx))
        qx = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
        y = self.int_product(qx)
        return y.to(torch.float32) * (sx * self.wscale) + self.bias


class QLayerNorm:
    """JAX ``_ln`` :139: ``jnp.mean``, the two-pass ``jnp.var``,
    ``(x − mu) · rsqrt(var + 1e-6) · scale + bias``."""

    def __init__(self, p: dict, device: torch.device):
        self.scale = torch.from_numpy(p["scale"]).to(device)
        self.bias = torch.from_numpy(p["bias"]).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = torch.square(x - mu).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + LN_EPS) * self.scale + self.bias


class QResBlock:
    """JAX ``_resblock`` :145."""

    def __init__(self, p: dict, device: torch.device):
        self.d0, self.d1 = (QDense(p[k], device) for k in ("Dense_0",
                                                           "Dense_1"))
        self.ln0, self.ln1 = (QLayerNorm(p[k], device)
                              for k in ("LayerNorm_0", "LayerNorm_1"))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.ln0(self.d0(x)))
        return x + self.ln1(self.d1(h))


class Int8AgentApply:
    """``obs [R, 22] -> action mean [R, 2]`` on quantized parameters: the
    int8 twin of ``fb/inference.py::AgentGuide`` (JAX ``Int8AgentApply``
    :153)."""

    def __init__(self, qparams: dict, z_dim: int, device,
                 num_res_blocks: int = 3):
        device = torch.device(device)
        e, b = qparams["encoder"], qparams["backward"]
        self.qparams = qparams          # numpy, for a twin on another device
        self.z_dim = z_dim
        self.e_in = QDense(e["Dense_0"], device)
        self.e_ln = QLayerNorm(e["LayerNorm_0"], device)
        self.e_blocks = [QResBlock(e[f"ResidualBlock_{i}"], device)
                         for i in range(num_res_blocks)]
        self.attn_v = QDense(e["attn_v"], device)
        self.attn_out = QDense(e["attn_out"], device)
        self.e_d1 = QDense(e["Dense_1"], device)
        self.e_d2 = QDense(e["Dense_2"], device)
        self.b_in = QDense(b["Dense_0"], device)
        self.b_ln = QLayerNorm(b["LayerNorm_0"], device)
        self.b_blocks = [QResBlock(b[f"ResidualBlock_{i}"], device)
                         for i in range(2)]
        self.b_head = QDense(b["Dense_1"], device)
        self.proto = torch.from_numpy(qparams["proto"]).to(device)
        self.device = self.proto.device       # "cuda" as "cuda:<current>"

    def layers(self):
        """Every quantized layer, in the order the forward runs them."""
        blocks = [d for blk in self.e_blocks + self.b_blocks
                  for d in (blk.d0, blk.d1)]
        return [self.e_in, *blocks[:2 * len(self.e_blocks)], self.attn_v,
                self.attn_out, self.e_d1, self.e_d2, self.b_in,
                *blocks[2 * len(self.e_blocks):], self.b_head]

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        if obs.device != self.device:
            raise ValueError(f"observations on {obs.device}; the int8 "
                             f"guide is on {self.device}")
        with torch.inference_mode():
            x = torch.relu(self.e_ln(self.e_in(obs.to(torch.float32))))
            for blk in self.e_blocks:
                x = blk(x)
            x = x + self.attn_out(self.attn_v(x))
            x = torch.relu(self.e_d1(x))
            z = self.e_d2(x)[:, :self.z_dim]
            h = torch.cat([z, self.proto.expand(z.shape[0], -1)], dim=-1)
            h = torch.relu(self.b_ln(self.b_in(h)))
            for blk in self.b_blocks:
                h = blk(h)
            return torch.tanh(self.b_head(h)) * 0.95


def make_int8_guide(agent) -> Int8AgentApply:
    """The int8 guide of a ``TrainedFBAgent`` (JAX ``make_int8_guide``
    :182): its weights quantized once, on the agent's device."""
    qparams = quantize_agent_params(agent.encoder, agent.backward,
                                    agent.light_prototype)
    return Int8AgentApply(qparams, agent.config.z_dim, agent.device)
