"""Port Whitted kernels' semantics with ``precision="fast"`` (the
``d2 <= r*r`` hit test both TPU kernels use) held against the TPU kernels
themselves, run as the JAX package's own tests run them on the CPU:
``trace_whitted_pallas(interpret=True)`` and ``nearest_hit_pallas`` under
``pltpu.force_tpu_interpret_mode()``.

Bounds: tests/test_pallas_intersect.py's for the sweep (found exact, idx
exact where found, t within rtol/atol 2e-4).  For the whole trace, the
discrete fields exact (hit everywhere; idx, bounces and through on hit
lanes, as tests/test_pallas_whitted.py holds them); t, point and normal
within tests/test_pallas_whitted.py's rtol/atol 2e-4 on at least 98% of
the hit lanes and within 2e-3 on all.  The TPU kernel runs as one jitted
program whose arithmetic XLA fuses (its ``jnp.sum`` normalisation of the
camera directions does not add left to right): it equals the jitted JAX
tracer, and both differ from the same operations run one by one (which
the port equals exactly, tests/test_torch_whitted.py) by an ulp that
t = tca - sqrt(r*r - d2) amplifies on hits near a sphere's silhouette.
Measured at 45x45: 4 of marbles4's 480 hit lanes beyond 2e-4 (mirror
hits, up to 8.6e-4), none in the three other scenes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core.pallas_whitted import trace_whitted_pallas
from raytracer_tpu.render.renderer import material_flags as jax_flags
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu_torch.core import cuda_intersect
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS

from test_torch_whitted import SCENES, _hit_rays, jax_case, port_trace, \
    to_port

pallas_intersect = pytest.importorskip("raytracer_tpu.core.pallas_intersect")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402


@pytest.mark.parametrize("name", SCENES)
def test_trace_whitted_fast_matches_pallas_kernel(name):
    # 45x45 rays fill one 2048-ray tile of the TPU kernel, the unit of its
    # interpret-mode cost.
    js, _, _, p, o, d = jax_case(name, jnp.float32, grid=22)
    eg, em = jax_flags(js)
    kw = dict(max_bounces=p.get("max_bounces", 5), enable_glass=eg,
              enable_mirror=em)
    want = trace_whitted_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                interpret=True, **kw)
    got = port_trace(to_port(js), o, d, impl="kernel", precision="fast",
                     **kw)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit, err_msg=name)
    for f in ("idx", "bounces", "through"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[hit],
                                      np.asarray(getattr(want, f))[hit],
                                      err_msg=f"{name}.{f}")
    far = np.zeros(int(hit.sum()), bool)
    for f in ("t", "point", "normal"):
        g = getattr(got, f).numpy()[hit]
        w = np.asarray(getattr(want, f))[hit]
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3,
                                   err_msg=f"{name}.{f}")
        close = np.isclose(g, w, rtol=2e-4, atol=2e-4)
        far |= ~close.reshape(len(close), -1).all(-1)
    assert far.mean() <= 0.02, f"{name}: {far.sum()} of {far.size} lanes"


@pytest.mark.parametrize("by_abs", [False, True])
def test_nearest_hit_fast_matches_pallas_kernel(by_abs):
    js = jax_library.chandelier_scene()[0]
    o, d = _hit_rays(4096, seed=5)
    sup = np.where(np.arange(4096) % 3 == 0, np.asarray(js.id)[0],
                   NO_SUPPRESS).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_intersect.nearest_hit_pallas(
            jnp.asarray(o), jnp.asarray(d), js, jnp.asarray(sup),
            by_abs=by_abs)
    t, idx, found = cuda_intersect.nearest_hit(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(sup),
        cuda_intersect.sphere_table(to_port(js)), by_abs=by_abs, fast=True)
    f = np.asarray(want.found)
    np.testing.assert_array_equal(found.numpy(), f)
    np.testing.assert_array_equal(idx.numpy()[f], np.asarray(want.idx)[f])
    np.testing.assert_allclose(t.numpy()[f], np.asarray(want.t)[f],
                               rtol=2e-4, atol=2e-4)
