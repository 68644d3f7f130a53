"""The port's stepwise tracer (trace_path(impl="stepwise"): one
``cuda_intersect.nearest_hit`` sweep a level, the rest of the level as
tensor ops, the guide between levels, ``guide_max_level``) held against
JAX ``trace_path(impl="stepwise")`` on the same rays and the same
per-level draws (``k_diff, k_fb = split(keys[l])``).

* With a guide whose arithmetic is exact in both packages (an elementwise
  function of the observation), at chandelier 40x20@2spp/8,
  ``mirror_threshold=0.9``, fb_prob 0.7 and 1.0, ``guide_max_level``
  None and 3, and unguided: bit for bit, image and all six counts, against
  JAX run op by op (``jax.disable_jit``).  Jitted, XLA divides the fold's
  ``/ 255`` as a multiply by the reciprocal and can flip a ``trunc`` by
  one unit (ROADMAP queue 3's known gaps): measured unguided, one sample
  of 1,600 one unit off, every count equal.
* Unguided and guided, the port's stepwise equals its plain and hybrid
  impls bit for bit, and with ``guide_max_level=3`` the hybrid whose fb
  plane is above ``fb_prob`` past level 3.
* The shipped chandelier agent (``models/fb_chandelier_trained_v2.npz``)
  at 40x30@2spp/8, fb_prob 1.0, against jitted JAX: at least 99% of
  samples equal and small-light hits within 0.9-1.12x (measured 99.83%
  with every guide level and 99.96% with ``guide_max_level=3``, every
  count equal; the f32 networks sum in another order, ~1e-6).
* ``guide_max_level`` with any other impl raises, as in JAX.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.inference import TrainedFBAgent as JaxAgent
from raytracer_tpu.fb.inference import small_light_indices as jax_small
from raytracer_tpu.render.camera import perspective_rays as jax_perspective
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace.path import trace_path as jax_trace_path
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.trace.path import trace_path

from test_torch_fb_networks import NARROW
from test_torch_guided import STATS, jax_planes
from test_torch_scene import port_scene

TRAINED = Path(__file__).parents[1] / "models" / "fb_chandelier_trained_v2.npz"


def chandelier_rays(W, H, spp, seed):
    """The JAX camera's jittered chandelier rays (64-bit mode off, as on
    the TPU), float32 numpy ``[spp*H*W, 3]``."""
    js, _, _, p = jax_library.chandelier_scene()
    jit = np.random.RandomState(seed).rand(spp, H, W, 2).astype(np.float32)
    with jax.enable_x64(False):
        o, d = jax_perspective(W, H, fov=p["fov"],
                               origin=p["camera_position"], variant="fb",
                               sample_xy=jnp.asarray(jit))
    return (js, np.array(o, np.float32).reshape(-1, 3),
            np.array(d, np.float32).reshape(-1, 3))


def exact_guide_jax(obs):
    return jnp.stack([obs[:, 0] - obs[:, 4], -obs[:, 6]], axis=-1)


def exact_guide_port(obs):
    return torch.stack([obs[:, 0] - obs[:, 4], -obs[:, 6]], dim=-1)


def run_both(js, o, d, key, jguide, tguide, jit=True, **kw):
    """JAX stepwise (jitted, or op by op) and the port's stepwise on the
    same rays and draws: ``(rgb_jax, stats_jax, rgb_port, stats_port)``."""
    def jax_run():
        return jax_trace_path(js, jnp.asarray(o), jnp.asarray(d), key,
                              impl="stepwise", guide_fn=jguide, **kw)

    if jit:
        rgb_j, st_j = jax_run()
    else:
        with jax.disable_jit():
            rgb_j, st_j = jax_run()
    u, f = jax_planes(key, kw["max_bounces"], o.shape[0])
    rgb_t, st_t = trace_path(port_scene(js), torch.from_numpy(o),
                             torch.from_numpy(d), impl="stepwise",
                             guide_fn=tguide, uniforms=torch.from_numpy(u),
                             fb_uniforms=torch.from_numpy(f), **kw)
    return (np.asarray(rgb_j), {s: int(getattr(st_j, s)) for s in STATS},
            rgb_t.numpy(), st_t.as_dict())


@pytest.mark.parametrize("guide_max_level", [None, 3])
@pytest.mark.parametrize("fb_prob", [0.7, 1.0])
def test_exact_guide_equals_jax_stepwise(fb_prob, guide_max_level):
    js, o, d = chandelier_rays(40, 20, 2, seed=0)
    rj, sj, rt, st = run_both(js, o, d, jax.random.key(3), exact_guide_jax,
                              exact_guide_port, jit=False, max_bounces=8,
                              mirror_threshold=0.9, fb_prob=fb_prob,
                              guide_max_level=guide_max_level)
    np.testing.assert_array_equal(rt, rj)
    assert st == sj
    assert st["fb_used"] > 0


def test_unguided_equals_jax_stepwise_and_plain():
    js, o, d = chandelier_rays(40, 20, 2, seed=0)
    key = jax.random.key(4)
    rj, sj, rt, st = run_both(js, o, d, key, None, None, jit=False,
                              max_bounces=8, mirror_threshold=0.9)
    np.testing.assert_array_equal(rt, rj)
    assert st == sj and st["light_hits"] > 0
    u, _ = jax_planes(key, 8, o.shape[0])
    rp, sp = trace_path(port_scene(js), torch.from_numpy(o),
                        torch.from_numpy(d), impl="plain", max_bounces=8,
                        mirror_threshold=0.9, uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(rp.numpy(), rt)
    assert sp.as_dict() == st


def test_stepwise_equals_hybrid_and_plain_with_an_agent():
    """The narrow seeded agent: stepwise, hybrid and plain bit for bit; with
    guide_max_level=3, the hybrid whose fb plane is 2.0 (never below
    fb_prob) from level 3 on."""
    js = jax_library.chandelier_scene()[0]
    ts = port_scene(js)
    agent = TrainedFBAgent(None, ts, small_light_indices(ts),
                           (0.0, 2.0, 0.0), config=FBConfig(**NARROW),
                           seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    R = 2500
    o = torch.zeros((R, 3)) + torch.tensor([0.0, 2.0, 0.0])
    d = torch.randn((R, 3), generator=g)
    u = torch.rand((8, R, 2), generator=g)
    f = torch.rand((8, R), generator=g)
    kw = dict(max_bounces=8, mirror_threshold=0.9, uniforms=u,
              fb_uniforms=f, fb_prob=0.8, guide_fn=agent.as_guide_fn())
    out = {impl: trace_path(ts, o, d, impl=impl, **kw)
           for impl in ("stepwise", "stepwise-pallas", "hybrid", "plain")}
    rgb, st = out["stepwise"]
    for impl in ("stepwise-pallas", "hybrid", "plain"):
        assert torch.equal(out[impl][0], rgb), impl
        assert out[impl][1].as_dict() == st.as_dict(), impl
    r3, s3 = trace_path(ts, o, d, impl="stepwise", guide_max_level=3, **kw)
    f3 = f.clone()
    f3[3:] = 2.0
    h3, sh3 = trace_path(ts, o, d, impl="hybrid", **dict(kw, fb_uniforms=f3))
    assert torch.equal(r3, h3) and s3.as_dict() == sh3.as_dict()
    assert 0 < int(s3.fb_used) < int(st.fb_used)
    r0, s0 = trace_path(ts, o, d, impl="stepwise", guide_max_level=0, **kw)
    u0, su0 = trace_path(ts, o, d, impl="stepwise",
                         **dict(kw, guide_fn=None, fb_uniforms=None))
    assert torch.equal(r0, u0) and int(s0.fb_used) == 0
    assert s0.as_dict() == su0.as_dict()


@pytest.fixture(scope="module")
def trained_agents():
    """The shipped chandelier agent in both packages (None when absent)."""
    if not TRAINED.exists():
        return None
    js, _, _, p = jax_library.chandelier_scene()
    ts = port_scene(js)
    cam = p["camera_position"]
    return (JaxAgent(str(TRAINED), js, jax_small(js), cam),
            TrainedFBAgent(str(TRAINED), ts, small_light_indices(ts), cam,
                           device="cpu"))


@pytest.mark.parametrize("guide_max_level", [None, 3])
def test_trained_agent_within_bounds_of_jax_stepwise(trained_agents,
                                                     guide_max_level):
    if trained_agents is None:
        pytest.skip(f"{TRAINED.name} is not in models/")
    ja, ta = trained_agents
    js, o, d = chandelier_rays(40, 30, 2, seed=1)
    rj, sj, rt, st = run_both(js, o, d, jax.random.key(5),
                              ja.as_guide_fn(dtype=None), ta.as_guide_fn(),
                              max_bounces=8, mirror_threshold=0.9,
                              fb_prob=1.0, guide_max_level=guide_max_level)
    assert np.isfinite(rt).all() and st["fb_used"] > 0
    frac = (rt == rj).all(-1).mean()
    assert frac >= 0.99, frac
    assert sj["small_light_hits"] > 0
    assert 0.9 <= st["small_light_hits"] / sj["small_light_hits"] <= 1.12


@pytest.mark.parametrize("impl", ["kernel", "plain", "hybrid"])
def test_guide_max_level_needs_stepwise(impl):
    ts = port_scene(jax_library.chandelier_scene()[0])
    o = torch.zeros((8, 3))
    d = torch.ones((8, 3))
    with pytest.raises(ValueError, match="guide_max_level requires"):
        trace_path(ts, o, d, max_bounces=2, mirror_threshold=0.0, impl=impl,
                   guide_max_level=1)
    with pytest.raises(ValueError, match="guide_max_level requires"):
        render_path(ts, width=4, height=2, spp=1, impl=impl,
                    guide_max_level=1, device="cpu",
                    generator=torch.Generator().manual_seed(0))
