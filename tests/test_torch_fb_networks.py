"""The port's FB networks (raytracer_tpu_torch/fb/networks.py) and
checkpoint reader (utils/checkpoint.py) held against the flax modules of
raytracer_tpu/fb/networks.py on the same parameters and inputs.

* A narrow config (z 8, encoder 32, backward 16, forward 32): flax's
  initial parameters, perturbed by seeded noise (so no LayerNorm is the
  identity and no bias zero), flattened by JAX's ``_flatten`` and carried
  across by ``params_from_flat``.  Encoder output, every forward head and
  the backward mean and log-variance agree within 1e-5 of the largest
  flax output (f32 products summed in another order; measured at most
  4.4e-7 of it, encoder 1.05e-5 on outputs up to 24).
* The shipped ``models/fb_chandelier_trained_v2.npz`` read by the port's
  ``load_fb`` and by JAX's: the encoder mean and the backward action on 512
  seeded observations within 1e-5 (measured 1.6e-6 and 2.4e-6).  Skips
  when the file is absent.
* The port's LayerNorm (flax's ε and one-pass variance) is closer to flax
  than ``F.layer_norm`` (ε = 1e-5, two-pass) on small-variance rows.
"""
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.fb.networks import make_networks as jax_networks
from raytracer_tpu.utils.checkpoint import _flatten, _unflatten_like
from raytracer_tpu.utils.checkpoint import load_fb as jax_load_fb
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.networks import LayerNorm
from raytracer_tpu_torch.utils.checkpoint import (load_fb, load_flat,
                                                  params_from_flat)

ROOT = Path(__file__).parents[1]
TRAINED = ROOT / "models" / "fb_chandelier_trained_v2.npz"
NARROW = dict(z_dim=8, e_hidden_dim=32, f_hidden_dim=32, b_hidden_dim=16)
REL_TOL = 1e-5


def narrow_params(seed=0):
    """Flax's initial parameters for the narrow config, perturbed by seeded
    noise: ``(jax params by part, the flattened keys of all parts)``."""
    enc, fwd, bwd = jax_networks(JaxConfig(**NARROW))
    k = jax.random.split(jax.random.key(seed), 3)
    f32 = jnp.float32
    z = NARROW["z_dim"]
    params = {
        "encoder": enc.init(k[0], jnp.zeros((1, 22), f32))["params"],
        "forward": fwd.init(k[1], jnp.zeros((1, z), f32),
                            jnp.zeros((1, 2), f32))["params"],
        "backward": bwd.init(k[2], jnp.zeros((1, z), f32),
                             jnp.zeros((1, z), f32))["params"]}
    rng = np.random.RandomState(seed)
    flat = {}
    for name, p in params.items():
        part = {key: (v + 0.2 * rng.randn(*v.shape)).astype(np.float32)
                for key, v in _flatten(p).items()}
        params[name] = _unflatten_like(p, part)
        flat.update({f"{name}::{key}": v for key, v in part.items()})
    return params, flat


def close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL_TOL * max(np.abs(want).max(), 1.0), err


def test_narrow_networks_match_flax():
    params, flat = narrow_params()
    nets = params_from_flat(flat, FBConfig(**NARROW))
    enc, fwd, bwd = jax_networks(JaxConfig(**NARROW))
    rng = np.random.RandomState(1)
    obs = rng.randn(256, 22).astype(np.float32)
    z, z2 = (rng.randn(256, 8).astype(np.float32) for _ in range(2))
    act = rng.uniform(-1, 1, (256, 2)).astype(np.float32)
    t = torch.from_numpy
    with torch.inference_mode():
        close(nets["encoder"](t(obs)),
              enc.apply({"params": params["encoder"]}, jnp.asarray(obs)))
        heads = nets["forward"](t(z), t(act))
        want = fwd.apply({"params": params["forward"]}, jnp.asarray(z),
                         jnp.asarray(act))
        assert len(heads) == len(want) == 3
        for (m, lv), (wm, wlv) in zip(heads, want):
            close(m, wm)
            close(lv, wlv)
        m, lv = nets["backward"](t(z), t(z2))
        wm, wlv = bwd.apply({"params": params["backward"]}, jnp.asarray(z),
                            jnp.asarray(z2))
        close(m, wm)
        close(lv, wlv)
        assert float(m.abs().max()) <= 0.95


def test_params_from_flat_raises_as_jax_does():
    _, flat = narrow_params()
    wide = FBConfig(**dict(NARROW, e_hidden_dim=64))
    with pytest.raises(ValueError, match="shape mismatch at encoder::"):
        params_from_flat(flat, wide)
    nets = params_from_flat(flat, FBConfig(**NARROW))
    missing = {k: v for k, v in flat.items()
               if not k.endswith("LayerNorm_0/scale")}
    with pytest.raises(KeyError):
        load_flat(nets["encoder"], missing, "encoder::")
    # A part with no key keeps its seeded initial values.
    slim = {k: v for k, v in flat.items()
            if k.startswith(("encoder::", "backward::"))}
    a = params_from_flat(slim, FBConfig(**NARROW))["forward"]
    b = params_from_flat(slim, FBConfig(**NARROW))["forward"]
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert float(a.Dense_0.kernel.abs().max()) > 0


def test_trained_checkpoint_matches_jax():
    if not TRAINED.exists():
        pytest.skip(f"{TRAINED.name} is not in models/")
    jp, jcfg, jextra = jax_load_fb(TRAINED, JaxConfig())
    nets, cfg, extra = load_fb(TRAINED, FBConfig())
    assert cfg == jcfg and cfg["e_hidden_dim"] == 512
    assert extra["updates"] == jextra["updates"]
    np.testing.assert_array_equal(np.stack(extra["light_memory"]),
                                  np.stack(jextra["light_memory"]))
    enc, _, bwd = jax_networks(JaxConfig())
    rng = np.random.RandomState(2)
    obs = rng.randn(512, 22).astype(np.float32)
    proto = rng.randn(64).astype(np.float32)
    proto /= np.linalg.norm(proto)
    jz = enc.apply({"params": jp.encoder}, jnp.asarray(obs))[:, :64]
    jm, _ = bwd.apply({"params": jp.backward}, jz,
                      jnp.broadcast_to(jnp.asarray(proto), jz.shape))
    with torch.inference_mode():
        z = nets["encoder"].encode_mean(torch.from_numpy(obs))
        m = nets["backward"].action_mean(nets["backward"].trunk(
            z, torch.from_numpy(proto).expand(512, -1)))
    close(z, jz)
    close(m, jm)


def test_layer_norm_closer_to_flax_than_torch_layer_norm():
    rng = np.random.RandomState(3)
    x = (rng.randn(64, 512) * 0.01).astype(np.float32)
    scale = rng.randn(512).astype(np.float32)
    bias = rng.randn(512).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    ln = LayerNorm(512)
    t = torch.from_numpy
    with torch.no_grad():
        ln.scale.copy_(t(scale))
        ln.bias.copy_(t(bias))
        mine = ln(t(x)).numpy()
        theirs = torch.nn.functional.layer_norm(t(x), (512,), t(scale),
                                                t(bias)).numpy()
    err_mine = np.abs(mine - want).max()
    err_torch = np.abs(theirs - want).max()
    assert err_mine < 1e-5 * np.abs(want).max()
    assert err_mine < err_torch / 100, (err_mine, err_torch)
