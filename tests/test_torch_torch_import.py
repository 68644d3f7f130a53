"""The port's import of the reference's ``.pth`` FB checkpoints
(raytracer_tpu_torch/utils/torch_import.py, ``fb/networks.py``'s
``Simple*``) held against the JAX package's.

The test writes reference-schema state dicts of both families (random
weights from a seed) into ``.pth`` files that also pickle an object of a
class from the reference's ``fb_ray_tracing`` module, which exists only
while the file is written.  Then:

* ``TrainedFBAgent`` on the Enhanced ``.pth``, in each package, guides
  within 1e-5 on the same observations;
* the Simple family's networks, imported by each package, agree within
  1e-5;
* the port's load leaves no ``fb_ray_tracing`` in ``sys.modules`` (the JAX
  loader leaves its stub there: it runs hidden, as
  tests/test_torch_fb_learner.py::hidden_loader_stub hides it).
"""
import contextlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.fb.inference import TrainedFBAgent as JaxAgent
from raytracer_tpu.fb.networks import (SimpleBackwardModel,
                                       SimpleEncoder, SimpleForwardModel)
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.utils import torch_import as jax_ti
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.utils import torch_import

from test_torch_scene import one_torch_thread, port_scene  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WIDTHS = dict(z_dim=16, e_hidden_dim=64, f_hidden_dim=64, b_hidden_dim=32)
MODULE = "fb_ray_tracing"


@contextlib.contextmanager
def no_loader_module():
    """``fb_ray_tracing`` out of ``sys.modules`` inside the block and after
    it as before it (the JAX loader adds its stub)."""
    before = sys.modules.pop(MODULE, None)
    try:
        yield
    finally:
        sys.modules.pop(MODULE, None)
        if before is not None:
            sys.modules[MODULE] = before


def _save_with_reference_class(obj, path):
    """``torch.save`` with ``obj["config"]`` an object of a class of the
    reference's ``fb_ray_tracing`` module, present only while saving."""
    mod = types.ModuleType(MODULE)
    cls = type("FBConfig", (), {"__module__": MODULE})
    mod.FBConfig = cls
    cfg = cls()
    cfg.z_dim, cfg.hidden = 16, 64
    with no_loader_module():
        sys.modules[MODULE] = mod
        torch.save({**obj, "config": cfg}, path)


def _linear(g, out, inp, name):
    """A ``Linear``'s state at the scale of torch's initialisation."""
    return {f"{name}.weight": torch.randn((out, inp), generator=g)
            / inp ** 0.5,
            f"{name}.bias": torch.randn((out,), generator=g) * 0.1}


def _layernorm(g, dim, name):
    return {f"{name}.weight": 1 + 0.1 * torch.randn((dim,), generator=g),
            f"{name}.bias": 0.1 * torch.randn((dim,), generator=g)}


def _res(g, dim, name):
    return {**_linear(g, dim, dim, f"{name}.net.0"),
            **_layernorm(g, dim, f"{name}.net.1"),
            **_linear(g, dim, dim, f"{name}.net.3"),
            **_layernorm(g, dim, f"{name}.net.4")}


def enhanced_state(seed, cfg):
    """The Enhanced family's state dicts (FB/fb_vs_traditional_complex.py:
    37-142 key names) at ``cfg``'s widths."""
    g = torch.Generator().manual_seed(seed)
    e, f, b, z, a = (cfg.e_hidden_dim, cfg.f_hidden_dim, cfg.b_hidden_dim,
                     cfg.z_dim, cfg.action_dim)
    enc = {**_linear(g, e, cfg.obs_dim, "input_proj.0"),
           **_layernorm(g, e, "input_proj.1"),
           "attention.in_proj_weight": torch.randn((3 * e, e), generator=g)
           / e ** 0.5,
           "attention.in_proj_bias": torch.randn((3 * e,), generator=g) * 0.1,
           **_linear(g, e, e, "attention.out_proj"),
           **_linear(g, e, e, "output.0"), **_linear(g, 2 * z, e, "output.2")}
    for i in range(3):
        enc.update(_res(g, e, f"res_blocks.{i}"))
    fwd = {**_linear(g, f, z + a, "input_net.0"),
           **_layernorm(g, f, "input_net.1")}
    for i in range(cfg.num_layers):
        fwd.update(_linear(g, 2 * f, f, f"gated_blocks.{i}.0"))
    for h in range(cfg.num_forward_heads):
        fwd.update({**_linear(g, f, f, f"heads.{h}.0"),
                    **_linear(g, 2 * z, f, f"heads.{h}.2")})
    bwd = {**_linear(g, b, 2 * z, "input_net.0"),
           **_layernorm(g, b, "input_net.1"),
           **_linear(g, a, b, "mean_head"), **_linear(g, a, b, "log_var_head")}
    for i in range(2):
        bwd.update(_res(g, b, f"res_blocks.{i}"))
    return {"encoder": enc, "forward_model": fwd, "backward_model": bwd}


def simple_state(seed, z=32, hidden=128, b_hidden=64, heads=2):
    """``fb_model_simple.pth``'s schema (encoder net.0/2/4, forward
    input/hidden/heads, backward input/hidden/output)."""
    g = torch.Generator().manual_seed(seed)
    enc = {**_linear(g, hidden, 22, "net.0"), **_linear(g, hidden, hidden,
                                                        "net.2"),
           **_linear(g, 2 * z, hidden, "net.4")}
    fwd = {**_linear(g, hidden, z + 2, "input_layer"),
           **_linear(g, hidden, hidden, "hidden_layers.0")}
    for h in range(heads):
        fwd.update(_linear(g, z, hidden, f"heads.{h}"))
    bwd = {**_linear(g, b_hidden, 2 * z, "input_layer"),
           **_linear(g, b_hidden, b_hidden, "hidden_layers.0"),
           **_linear(g, 2, b_hidden, "output_layer")}
    return {"encoder": enc, "forward_model": fwd, "backward_model": bwd,
            "train_steps": 7}


def test_enhanced_pth_guides_as_jax(tmp_path):
    cfg = FBConfig(**WIDTHS)
    path = tmp_path / "fb_learner.pth"
    _save_with_reference_class(
        {"fb_learner_state": enhanced_state(3, cfg)}, path)
    js, _, _, p = jax_library.chandelier_scene()
    scene = port_scene(js)
    idx = small_light_indices(scene)
    with no_loader_module():
        agent = TrainedFBAgent(str(path), scene, idx, p["camera_position"],
                               config=cfg, device="cpu")
        assert MODULE not in sys.modules
        ck = torch_import.load_torch_checkpoint(path)
        assert MODULE not in sys.modules
        jagent = JaxAgent(str(path), js, np.asarray(idx),
                          p["camera_position"], config=JaxConfig(**WIDTHS))
    assert agent.loaded and jagent.loaded
    assert set(ck) == {"encoder", "forward_model", "backward_model"}
    raw = torch.load(path, weights_only=False,
                     pickle_module=torch_import._pickle_module())
    assert type(raw["config"]).__name__ == "FBConfig"
    assert raw["config"].z_dim == 16
    np.testing.assert_allclose(agent.light_prototype,
                               np.asarray(jagent.light_prototype),
                               rtol=1e-5, atol=1e-6)
    obs = np.random.default_rng(0).normal(size=(512, 22)).astype(np.float32)
    got = agent.as_guide_fn()(torch.from_numpy(obs)).numpy()
    want = np.asarray(jagent.as_guide_fn()(jnp.asarray(obs)))
    assert got.shape == (512, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pred = agent.forward_model(torch.from_numpy(obs[:, :16]),
                               torch.from_numpy(obs[:, 16:18]))
    jpred = jagent.fwd.apply({"params": jagent.params["forward"]},
                             jnp.asarray(obs[:, :16]), jnp.asarray(obs[:, 16:18]))
    for (m, lv), (jm, jlv) in zip(pred, jpred):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), rtol=1e-5,
                                   atol=1e-5)


def test_simple_pth_networks_as_jax(tmp_path):
    path = tmp_path / "fb_model_simple.pth"
    _save_with_reference_class(simple_state(5), path)
    with no_loader_module():
        nets = torch_import.import_simple(
            torch_import.load_torch_checkpoint(path))
        assert MODULE not in sys.modules
        ck = jax_ti.load_torch_checkpoint(str(path))
    enc_p = jax_ti.import_simple_encoder(ck["encoder"])
    fwd_p = jax_ti.import_simple_forward(ck["forward_model"], num_heads=2)
    bwd_p = jax_ti.import_simple_backward(ck["backward_model"])
    obs = np.random.default_rng(1).normal(size=(64, 22)).astype(np.float32)
    with torch.inference_mode():
        out = nets["encoder"](torch.from_numpy(obs))
        z = out[:, :32]
        preds = nets["forward"](z, torch.zeros((64, 2)))
        act = nets["backward"](z, z)
    jout = SimpleEncoder(z_dim=32, hidden_dim=128).apply(
        {"params": enc_p}, jnp.asarray(obs))
    jz = jout[:, :32]
    jpreds = SimpleForwardModel(z_dim=32, hidden_dim=128, num_heads=2).apply(
        {"params": fwd_p}, jz, jnp.zeros((64, 2), jnp.float32))
    jact = SimpleBackwardModel(hidden_dim=64).apply({"params": bwd_p}, jz, jz)
    assert out.shape == (64, 64) and len(preds) == 2
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    for a, b in zip(preds, jpreds):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), **tol)
    assert (act.abs() <= 1).all()
