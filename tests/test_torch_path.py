"""Port path tracer (raytracer_tpu_torch.trace.path / core.cuda_path) held
against the JAX tracers on the same rays and the same uniforms.

* plain version vs the 40x20 executed-reference golden: bit for bit;
* (tests/test_torch_path_mirror.py) vs JAX ``impl="lean"`` and
  ``impl="pallas"`` on the no-diffuse mirror scene at 4 and 8 bounces;
* diffuse bounces at ``mirror_threshold=0.9`` on JAX-drawn uniforms: exact
  vs lean, and within test_pallas_path.py's bounds vs pallas (its kernel
  samples cosθ = √u₀ without acos);
* a guide that is not a distilled student is refused by the kernel impls,
  and a diffuse scene without uniforms is refused.

The wrapper's own checks and the kernel-vs-plain test on a card are in
tests/test_torch_kernel.py, which imports no JAX.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render.camera import perspective_rays as jax_perspective
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace.path import trace_path as jax_trace_path
from raytracer_tpu_torch.trace.path import trace_path

from test_path import _lean_scene
from test_torch_scene import port_scene

GOLDEN = Path(__file__).parent / "golden"
STATS = ("total_rays", "total_intersections", "light_hits",
         "small_light_hits")


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32) + np.asarray([0.0, 1.0, 2.0],
                                                  np.float32)
    return o, rng.randn(n, 3).astype(np.float32)


def _jax_uniforms(key, max_bounces, n):
    """The JAX tracers' per-level draws: uniform(split(keys[l])[0], (R, 2))."""
    keys = jax.random.split(key, max_bounces)
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.split(keys[lvl])[0], (n, 2), jnp.float32))
        for lvl in range(max_bounces)])


def _jax(scene, o, d, key, impl, **kw):
    rgb, st = jax_trace_path(scene, jnp.asarray(o), jnp.asarray(d), key,
                             impl=impl, **kw)
    return np.asarray(rgb), {f: int(getattr(st, f)) for f in STATS}


def _port(scene, o, d, impl="plain", **kw):
    rgb, st = trace_path(port_scene(scene), torch.from_numpy(o),
                         torch.from_numpy(d), impl=impl, **kw)
    return rgb.numpy(), {f: int(getattr(st, f)) for f in STATS}


def test_plain_reproduces_40x20_golden():
    """The JAX golden test's rays (made with 64-bit mode on, as the golden
    was), cast to float32 as the JAX tracer casts them."""
    js, _, _, p = jax_library.chandelier_scene()
    o, d = jax_perspective(40, 20, fov=60, origin=p["camera_position"],
                           variant="fb")
    rgb, _ = _port(js, np.array(o, np.float32), np.array(d, np.float32),
                   max_bounces=3, mirror_threshold=0.0)
    ref = np.load(GOLDEN / "chandelier_traditional_40x20_nojitter.npy")
    np.testing.assert_array_equal(rgb.reshape(20, 40, 3), ref)


def test_diffuse_exact_vs_lean():
    o, d = _rays(3601, seed=1)
    key = jax.random.key(7)
    kw = dict(max_bounces=4, mirror_threshold=0.9)
    want_rgb, want_st = _jax(_lean_scene(), o, d, key, "lean", **kw)
    got_rgb, got_st = _port(_lean_scene(), o, d,
                            uniforms=torch.from_numpy(
                                _jax_uniforms(key, 4, 3601)), **kw)
    np.testing.assert_array_equal(got_rgb, want_rgb)
    assert got_st == want_st


def test_diffuse_within_pallas_bounds():
    """test_pallas_path.py's bounds: >= 95% of subpixels equal, hit
    statistics within 2% (measured: all equal)."""
    o, d = _rays(3601, seed=1)
    key = jax.random.key(7)
    kw = dict(max_bounces=4, mirror_threshold=0.9)
    want_rgb, want_st = _jax(_lean_scene(), o, d, key, "pallas", **kw)
    got_rgb, got_st = _port(_lean_scene(), o, d,
                            uniforms=torch.from_numpy(
                                _jax_uniforms(key, 4, 3601)), **kw)
    assert np.isfinite(got_rgb).all()
    assert (got_rgb == want_rgb).mean() >= 0.95
    for f in ("total_rays", "total_intersections", "light_hits"):
        assert abs(got_st[f] - want_st[f]) <= max(0.02 * want_st[f], 2), f


def test_fast_precision_exact_vs_lean():
    o, d = _rays(777, seed=2)
    key = jax.random.key(11)
    kw = dict(max_bounces=3, mirror_threshold=0.9, precision="fast")
    want_rgb, want_st = _jax(_lean_scene(), o, d, key, "lean", **kw)
    got_rgb, got_st = _port(_lean_scene(), o, d,
                            uniforms=torch.from_numpy(
                                _jax_uniforms(key, 3, 777)), **kw)
    np.testing.assert_array_equal(got_rgb, want_rgb)
    assert got_st == want_st


def test_guide_not_ported_yet():
    """Guided tracing is ported (tests/test_torch_guided.py); the kernel
    and hybrid impls take distilled students only, as the JAX Pallas impl
    does (trace/path.py:273-280)."""
    js = jax_library.chandelier_scene()[0]
    o, d = _rays(4, seed=0)
    for impl in ("kernel", "hybrid"):
        with pytest.raises(ValueError, match="student"):
            _port(js, o, d, max_bounces=2, impl=impl,
                  guide_fn=lambda obs: obs)


def test_diffuse_needs_uniforms_or_generator():
    o, d = _rays(8, seed=0)
    with pytest.raises(ValueError, match="uniforms"):
        _port(_lean_scene(), o, d, max_bounces=2, mirror_threshold=0.9)
    g = torch.Generator().manual_seed(0)
    a, _ = _port(_lean_scene(), o, d, max_bounces=2, mirror_threshold=0.9,
                 generator=g)
    assert np.isfinite(a).all()
