"""Port path tracer vs the JAX tracers on the no-diffuse mirror scene
(every real sphere emissive or mirror at ``mirror_threshold=0.0``, the
chandelier traditional configuration's shape): 3,601 rays, a ragged count,
at 4 and 8 bounces, against ``impl="lean"`` and ``impl="pallas"`` (interpret
mode, as tests/test_pallas_path.py runs it).  Images and stats exact.
"""
import jax
import numpy as np
import pytest

from test_pallas_path import _mirror_scene
from test_torch_path import _jax, _port, _rays


@pytest.mark.parametrize("impl", ["lean", "pallas"])
@pytest.mark.parametrize("max_bounces", [4, 8])
def test_mirror_scene_exact_vs_jax(max_bounces, impl):
    # 3601 rays: a ragged count (2 Pallas tiles with 495 padded lanes).
    o, d = _rays(3601, seed=0)
    scene = _mirror_scene()
    kw = dict(max_bounces=max_bounces, mirror_threshold=0.0)
    want_rgb, want_st = _jax(scene, o, d, jax.random.key(3), impl, **kw)
    got_rgb, got_st = _port(scene, o, d, **kw)
    np.testing.assert_array_equal(got_rgb, want_rgb)
    assert got_st == want_st
