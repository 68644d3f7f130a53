"""The plain guides: the distilled student and the full FB agent.

Frozen copies, in plain PyTorch, of the student as flax runs it in
bfloat16 (``fb/distill.py::StudentGuide``) and of the FB agent's guide
(``fb/networks.py``'s encoder and backward model, ``fb/inference.py``'s
light prototype and ``AgentGuide``).  They read the student's npz file
and the agent's parameters as the harness made them, never the program's
copies, and work out the prototype themselves.

Each guide takes a ``precision``: the configuration's own, or the
control's, the nearest precision below it (``"fp8"`` for the bf16
student, ``"tf32"`` for the f32 agent: products of operands rounded to
TF32's 10-bit mantissa, as the card's TF32 path takes them).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

LAYER_NORM_EPS = 1e-6
ACTION_SCALE = 0.95


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest, ties away, on a 10-bit mantissa (the
    card's TF32 operand rounding)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8 e4m3 and back."""
    return x.to(torch.float8_e4m3fn).float()


def load_student(path) -> list:
    """``[(kernel [in, out], bias [out]), ...]`` float32 from the student's
    flat npz (``Dense_i/kernel``, ``Dense_i/bias``)."""
    with np.load(path) as z:
        n = len(z["__hidden__"]) + 1
        return [(torch.from_numpy(np.asarray(z[f"Dense_{i}/kernel"],
                                             np.float32)),
                 torch.from_numpy(np.asarray(z[f"Dense_{i}/bias"],
                                             np.float32))) for i in range(n)]


class Student:
    """``obs [R, 22] -> action [R, 2]`` float32.  ``"bf16"``: flax's
    order under XLA, observation and parameters rounded to bf16, each
    layer an f32-accumulated product rounded to bf16, then the bias added
    in bf16 (the output layer's add in f32), ReLU between.  ``"fp8"``: the
    same chain with each product's operands (the layer's input and its
    kernel) rounded to e4m3, as an fp8 tensor-core product takes them."""

    def __init__(self, layers, device, precision: str = "bf16"):
        if precision not in ("bf16", "fp8"):
            raise ValueError(f"student precision {precision!r}")
        self.q_in = bf16 if precision == "bf16" else round_fp8
        self.layers = [(self.q_in(k).to(device), bf16(b).to(device))
                       for k, b in layers]

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.float()
        last = len(self.layers) - 1
        for i, (k, b) in enumerate(self.layers):
            y = bf16(torch.matmul(self.q_in(x), k))
            x = bf16(y + b) if i < last else y + b
            if i < last:
                x = torch.relu(x)
        return x


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


# -- the FB agent ------------------------------------------------------------

def encoder_shapes(z: int, e: int, obs: int = 22, heads: int = 4) -> dict:
    """The encoder's parameters in flax's names and shapes."""
    hd = e // heads
    s = {"Dense_0/kernel": (obs, e), "Dense_0/bias": (e,),
         "LayerNorm_0/scale": (e,), "LayerNorm_0/bias": (e,)}
    for i in range(3):
        p = f"ResidualBlock_{i}/"
        for j in range(2):
            s[f"{p}Dense_{j}/kernel"] = (e, e)
            s[f"{p}Dense_{j}/bias"] = (e,)
            s[f"{p}LayerNorm_{j}/scale"] = (e,)
            s[f"{p}LayerNorm_{j}/bias"] = (e,)
    a = "MultiHeadDotProductAttention_0/"
    for name in ("query", "key", "value"):
        s[f"{a}{name}/kernel"] = (e, heads, hd)
        s[f"{a}{name}/bias"] = (heads, hd)
    s[f"{a}out/kernel"] = (heads, hd, e)
    s[f"{a}out/bias"] = (e,)
    s["Dense_1/kernel"] = (e, e)
    s["Dense_1/bias"] = (e,)
    s["Dense_2/kernel"] = (e, 2 * z)
    s["Dense_2/bias"] = (2 * z,)
    return s


def backward_shapes(z: int, b: int, action: int = 2) -> dict:
    s = {"Dense_0/kernel": (2 * z, b), "Dense_0/bias": (b,),
         "LayerNorm_0/scale": (b,), "LayerNorm_0/bias": (b,)}
    for i in range(2):
        p = f"ResidualBlock_{i}/"
        for j in range(2):
            s[f"{p}Dense_{j}/kernel"] = (b, b)
            s[f"{p}Dense_{j}/bias"] = (b,)
            s[f"{p}LayerNorm_{j}/scale"] = (b,)
            s[f"{p}LayerNorm_{j}/bias"] = (b,)
    for n in (1, 2):
        s[f"Dense_{n}/kernel"] = (b, action)
        s[f"Dense_{n}/bias"] = (action,)
    return s


def fan_in(name: str, shape) -> int:
    """flax's lecun fan-in: the ``in`` axes of a kernel (the attention's
    out projection takes two)."""
    if name.endswith("out/kernel"):
        return int(shape[0] * shape[1])
    return int(shape[0])


class Agent:
    """The FB agent's guide: ``obs -> tanh(Dense_1(trunk(encode(obs)[:z],
    prototype))) * 0.95`` in float32 (flax's LayerNorm: statistics
    ``E[x]``, ``max(0, E[x^2] - E[x]^2)``, then ``(x - mean) * (rsqrt(var +
    1e-6) * scale) + bias``; the single-token attention is ``out(value(x))``,
    its softmax over one key being exactly 1).  ``params``: ``{"encoder":
    {flax name: tensor}, "backward": {...}}`` on the device."""

    def __init__(self, params: Mapping[str, Mapping[str, torch.Tensor]],
                 z_dim: int, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"agent precision {precision!r}")
        self.enc, self.bwd = params["encoder"], params["backward"]
        self.z_dim = z_dim
        self.q = round_tf32 if precision == "tf32" else (lambda t: t)
        self.prototype = None

    def _dense(self, p, name, x):
        k = p[name + "/kernel"]
        k = k.reshape(-1, k.shape[-1]) if name.endswith("out") else \
            k.reshape(k.shape[0], -1)
        return torch.matmul(self.q(x), self.q(k)) + p[name + "/bias"
                                                      ].reshape(-1)

    @staticmethod
    def _norm(p, name, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * p[name + "/scale"]
        return (x - mean) * mul + p[name + "/bias"]

    def _block(self, p, pre, x):
        h = torch.relu(self._norm(p, pre + "LayerNorm_0",
                                  self._dense(p, pre + "Dense_0", x)))
        return self._norm(p, pre + "LayerNorm_1",
                          self._dense(p, pre + "Dense_1", h)) + x

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        p = self.enc
        x = torch.relu(self._norm(p, "LayerNorm_0",
                                  self._dense(p, "Dense_0", obs)))
        for i in range(3):
            x = self._block(p, f"ResidualBlock_{i}/", x)
        a = "MultiHeadDotProductAttention_0/"
        x = self._dense(p, a + "out", self._dense(p, a + "value", x)) + x
        x = torch.relu(self._dense(p, "Dense_1", x))
        return self._dense(p, "Dense_2", x)[:, :self.z_dim]

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            z = self.encode(obs.float())
            proto = self.prototype.expand(z.shape[0], -1)
            p = self.bwd
            x = torch.relu(self._norm(p, "LayerNorm_0", self._dense(
                p, "Dense_0", torch.cat([z, proto], dim=-1))))
            for i in range(2):
                x = self._block(p, f"ResidualBlock_{i}/", x)
            a = torch.tanh(self._dense(p, "Dense_1", x))
            return a * ACTION_SCALE

    def set_prototype(self, rows, camera, seed: int,
                      samples_per_light: int = 5) -> np.ndarray:
        """The light prototype (the reference's :147-256): 5 surface points
        a small light (radius < 0.5), drawn by ``np.random.default_rng(
        seed)``, each seen along the to-camera direction, encoded; the mean
        latent, L2-normalised, float32."""
        rng = np.random.default_rng(seed)
        cam = np.asarray(camera, np.float32)
        obs = []
        for s in rows:
            if not (s.emit > 0 and s.r < 0.5):
                continue
            c = np.array([s.cx, s.cy, s.cz], np.float32)
            to_cam = cam - c
            n = np.linalg.norm(to_cam)
            to_cam = to_cam / n if n > 1e-8 else to_cam
            for _ in range(samples_per_light):
                theta = rng.uniform(0, 2 * np.pi)
                phi = rng.uniform(0, np.pi)
                off = np.array([np.sin(phi) * np.cos(theta),
                                np.sin(phi) * np.sin(theta),
                                np.cos(phi)]) * np.float32(s.r)
                on = np.linalg.norm(off)
                normal = off / on if on > 1e-8 else off
                obs.append(np.concatenate([
                    c + off, to_cam, normal, [0.0, 0.0, 1.0, 1.0],
                    np.array([s.colr, s.colg, s.colb], np.float32) / 255.0,
                    [0.0, 0.0, float(s.id) / 100.0, 0.5, 0.5, 0.5],
                ]).astype(np.float32))
        dev = self.enc["Dense_0/kernel"].device
        if obs:
            with torch.no_grad():
                z = self.encode(torch.from_numpy(np.stack(obs)).to(dev))
            proto = z.cpu().numpy().mean(axis=0)
            n = np.linalg.norm(proto)
            if n > 1e-8:
                proto = proto / n
        else:
            proto = np.zeros((self.z_dim,), np.float32)
        proto = proto.astype(np.float32)
        self.prototype = torch.from_numpy(proto).to(dev)
        return proto


def agent_params_shapes(z: int, e: int, b: int) -> Dict[str, dict]:
    return {"encoder": encoder_shapes(z, e), "backward": backward_shapes(z, b)}
