"""The port's trained-FB agent (raytracer_tpu_torch/fb/inference.py) held
against raytracer_tpu/fb/inference.py on the same checkpoint.

A narrow checkpoint (z 8, encoder 32, backward 16, forward 32; flax's
initial parameters perturbed by seeded noise) is written with JAX's
``save_fb`` and read by both packages.  Tolerances are the networks' (1e-5
of the largest JAX value; tests/test_torch_fb_networks.py):

* ``small_light_indices`` equal on the chandelier and a five-sphere scene;
* the light prototype, from the same ``default_rng(seed)`` draws, within
  the tolerance (measured 6.0e-8 on the shipped chandelier agent);
* ``choose_direction(use_mean=True)`` and ``as_guide_fn(None)`` within it;
* the port's seeded agent, its noise and its refusals on its own.
"""
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.fb.inference import TrainedFBAgent as JaxAgent
from raytracer_tpu.fb.inference import small_light_indices as jax_small
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.utils.checkpoint import save_fb
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)

from test_path import _lean_scene
from test_torch_fb_networks import NARROW, close, narrow_params
from test_torch_scene import port_scene


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    """The same narrow checkpoint as a JAX and as a port agent on the
    chandelier, seed 3."""
    params, _ = narrow_params(seed=4)
    path = tmp_path_factory.mktemp("fb") / "narrow.npz"
    save_fb(path, types.SimpleNamespace(target_encoder=params["encoder"],
                                        **params), JaxConfig(**NARROW))
    js, _, _, p = jax_library.chandelier_scene()
    ts = port_scene(js)
    ja = JaxAgent(str(path), js, jax_small(js), p["camera_position"],
                  config=JaxConfig(**NARROW), seed=3)
    ta = TrainedFBAgent(str(path), ts, small_light_indices(ts),
                        p["camera_position"], config=FBConfig(**NARROW),
                        seed=3, device="cpu")
    return ja, ta


def _obs(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 22).astype(np.float32)


def test_small_light_indices_equal():
    for js in (jax_library.chandelier_scene()[0], _lean_scene()):
        want = jax_small(js)
        got = small_light_indices(port_scene(js))
        np.testing.assert_array_equal(got, want)
    assert len(small_light_indices(port_scene(
        jax_library.chandelier_scene()[0]))) == 20


def test_light_prototype_matches_jax(agents):
    ja, ta = agents
    assert ta.loaded and ta.light_prototype.dtype == np.float32
    assert ta.light_prototype.shape == (NARROW["z_dim"],)
    close(ta.light_prototype, ja.light_prototype)
    assert abs(np.linalg.norm(ta.light_prototype) - 1.0) < 1e-6


def test_choose_direction_matches_jax(agents):
    ja, ta = agents
    obs = _obs(300, seed=5)
    got = ta.choose_direction(obs)
    close(got, ja.choose_direction(obs))
    assert got.shape == (300, 2) and np.abs(got).max() <= 1.0
    one = ta.choose_direction(obs[0])
    assert one.shape == (2,)
    close(one, ja.choose_direction(obs[0]))


def test_guide_matches_jax(agents):
    ja, ta = agents
    obs = _obs(257, seed=6)
    want = np.asarray(ja.as_guide_fn(dtype=None)(jnp.asarray(obs)))
    guide = ta.as_guide_fn()
    got = guide(torch.from_numpy(obs))
    assert got.dtype == torch.float32 and got.shape == (257, 2)
    close(got, want)
    # "auto" is f32 here, bit for bit.  Compared with torch.equal, not
    # torch.testing: its first call imports torch.distributed.tensor, which
    # walks sys.modules and fails on a stub module left there by an earlier
    # test in the same process (see test_guide_matches_jax_after_stub_leak).
    auto = ta.as_guide_fn("auto")(torch.from_numpy(obs))
    assert auto.dtype == got.dtype and auto.shape == got.shape
    assert torch.equal(auto, got)


def test_guide_matches_jax_after_stub_leak(agents, monkeypatch):
    """The stub that raytracer_tpu/utils/torch_import.py's
    ``load_torch_checkpoint`` leaves in ``sys.modules`` (``fb_ray_tracing``,
    whose ``__getattr__`` makes a class of any name, ``__file__`` too) must
    not break the guide comparison.  With the stub in place, the first
    ``torch.testing.assert_close`` of a process fails inside
    ``inspect.getmodule``; the comparison above does not use it."""
    stub = types.ModuleType("fb_ray_tracing")
    stub.__getattr__ = lambda name: type(name, (), {})
    monkeypatch.setitem(sys.modules, "fb_ray_tracing", stub)
    test_guide_matches_jax(agents)


def test_seeded_agent_noise_and_refusals():
    scene = port_scene(jax_library.chandelier_scene()[0])
    kw = dict(config=FBConfig(**NARROW), device="cpu")
    a = TrainedFBAgent(None, scene, small_light_indices(scene),
                       (0.0, 2.0, 0.0), seed=7, **kw)
    b = TrainedFBAgent(None, scene, small_light_indices(scene),
                       (0.0, 2.0, 0.0), seed=7, **kw)
    assert not a.loaded
    np.testing.assert_array_equal(a.light_prototype, b.light_prototype)
    obs = _obs(64, seed=8)
    mean = a.choose_direction(obs)
    noise = torch.from_numpy(np.random.RandomState(9).randn(64, 2)
                             .astype(np.float32))
    with torch.inference_mode():
        z = a.encode(obs)
        m, log_var = a.backward(z, a.prototype.expand(64, -1))
        want = np.clip((m + torch.exp(0.5 * log_var) * noise).numpy(), -1, 1)
    np.testing.assert_array_equal(
        a.choose_direction(obs, use_mean=False, noise=noise), want)
    np.testing.assert_array_equal(mean, np.clip(m.numpy(), -1, 1))
    g1 = a.choose_direction(obs, use_mean=False,
                            generator=torch.Generator().manual_seed(1))
    g2 = a.choose_direction(obs, use_mean=False,
                            generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(g1, g2)
    assert not np.array_equal(g1, mean)
    with pytest.raises(ValueError, match="noise or a generator"):
        a.choose_direction(obs, use_mean=False)
    for bad in (torch.float16, "int4", "bfloat16"):
        with pytest.raises(ValueError, match="guide dtype"):
            a.as_guide_fn(bad)
    with pytest.raises(ValueError, match=".pth"):
        TrainedFBAgent("fb_model.pth", scene, small_light_indices(scene),
                       (0.0, 2.0, 0.0), **kw)
