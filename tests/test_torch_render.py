"""Port frame renderer (raytracer_tpu_torch.render.path_renderer) held
against the JAX renderer on the same jitter plane.

The port rounds once per written operation, as the JAX functions do when
run op by op (tests/test_torch_scene.py pins the camera that way).  JAX's
jitted renderer lets XLA rewrite some constant arithmetic: ``x / 255``
becomes ``x * f32(1/255)`` in the image assembly, and the camera's
constant factors are folded together.  So against the jitted renderer the
port's image may differ by one float32 ulp, and the stated bounds say so.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render import path_renderer as jax_renderer
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu_torch.render import path_renderer
from raytracer_tpu_torch.render.camera import perspective_rays
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.trace.path import trace_path

from test_torch_scene import port_scene

PARITY = Path(__file__).parents[1] / "showcase" / "parity_fullres"
STATS = ("total_rays", "total_intersections", "light_hits",
         "small_light_hits")


def test_render_path_matches_jax_jitted_renderer():
    """40x20, 2 spp, 8 bounces, chandelier traditional.  JAX runs
    ``impl="fused"``, bit-identical to ``impl="lean"``
    (tests/test_path.py) and minutes faster to compile on the CPU.
    Bounds: stats equal; every subpixel within one 8-bit step (1/255), and
    at least 99% within one float32 ulp of 1.0 (6e-8).  Measured: stats
    equal, every subpixel within 3e-8."""
    js, _, _, p = jax_library.chandelier_scene()
    w, h, spp = 40, 20, 2
    kw = dict(width=w, height=h, spp=spp, max_bounces=8,
              camera_position=p["camera_position"], mirror_threshold=0.0)
    with jax.enable_x64(False):
        key = jax.random.key(0)
        want, want_st = jax_renderer.render_path(js, key, impl="fused", **kw)
        want = np.asarray(want)
        jitter = np.array(jax.random.uniform(
            jax.random.split(key)[0], (spp, h, w, 2), jnp.float32))
    got, got_st = render_path(port_scene(js), jitter=torch.from_numpy(jitter),
                              impl="plain", device="cpu", **kw)
    got = got.numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    assert {f: int(getattr(got_st, f)) for f in STATS} == \
        {f: int(getattr(want_st, f)) for f in STATS}
    diff = np.abs(got - want)
    assert diff.max() <= 1 / 255
    assert (diff <= 6e-8).mean() >= 0.99


def test_assemble_equals_jax_op_by_op():
    """Integer ``floor(sum/spp)`` then ``min(1, c/255)``: exact against the
    same operations run op by op in JAX (with 64-bit mode off)."""
    rgb = np.random.default_rng(0).integers(0, 300, (3 * 4 * 5, 3)
                                            ).astype(np.float32)
    with jax.enable_x64(False):
        s = jnp.sum(jnp.asarray(rgb).reshape(3, 4, 5, 3), axis=0)
        want = np.asarray(jnp.minimum(1.0, jnp.floor(s / 3) / 255.0))
    got = path_renderer._assemble(torch.from_numpy(rgb), spp=3, height=4,
                                  width=5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generator_draws_are_seeded():
    scene, _, _, p = library.chandelier_scene(device="cpu")
    kw = dict(width=6, height=4, spp=2, max_bounces=3,
              camera_position=p["camera_position"], mirror_threshold=0.9,
              device="cpu")
    a, sa = render_path(scene, generator=torch.Generator().manual_seed(5),
                        **kw)
    b, sb = render_path(scene, generator=torch.Generator().manual_seed(5),
                        **kw)
    assert torch.equal(a, b) and sa.as_dict() == sb.as_dict()
    assert sa.total_rays.dtype == torch.int64
    with pytest.raises(ValueError, match="jitter"):
        render_path(scene, jitter=torch.zeros((1, 4, 6, 2)), **kw)
    with pytest.raises(ValueError, match="generator"):
        render_path(scene, **kw)


@pytest.mark.slow
def test_chandelier_800x600_fullres_golden():
    """Pixel centres, spp 1, 8 bounces vs the executed reference, with the
    bounds of tests/test_parity_fullres.py that hold for float32: fewer
    than 1000 divergent pixels (off by more than 1/255) and MSE over the
    agreeing pixels below 1e-8 (JAX float32 measured 311 and 5.8e-9,
    showcase/parity_fullres/parity.json)."""
    scene, _, _, p = library.chandelier_scene(device="cpu")
    o, d = perspective_rays(800, 600, fov=60, origin=p["camera_position"],
                            device="cpu")
    rgb, _ = trace_path(scene, o, d, max_bounces=8, mirror_threshold=0.0,
                        impl="plain")
    img = rgb.numpy().reshape(600, 800, 3).astype(np.float64)
    ref = np.load(PARITY / "chandelier_800x600_ref.npy").astype(np.float64)
    dd = np.abs(np.minimum(1.0, img / 255.0) - np.minimum(1.0, ref / 255.0))
    agree = dd.max(axis=-1) <= 1 / 255
    assert int((~agree).sum()) < 1000
    assert float(np.mean(dd[agree] ** 2)) < 1e-8
