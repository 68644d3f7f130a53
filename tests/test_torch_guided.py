"""Port guided path tracing (raytracer_tpu_torch/trace/path.py with a
student guide) held against the JAX tracers on the same rays, the same
uniforms and the same fb-gate draws (``k_diff, k_fb = split(keys[l])``).

* ``make_observation`` equal to JAX's, and the tracers' component form
  equal to it;
* a one-hot student (exact in any summation order), f32 and bf16: the
  plain version equal to JAX ``impl="fused"`` and ``"lean"`` bit for bit,
  image and all six counts, at fb_prob 1.0 and 0.5;
* the shipped bf16 student on the chandelier frame against JAX fused
  within tests/test_pallas_path.py:149-181's bounds: at least 90% of samples
  equal, light and small-light hits within 0.9-1.12x (measured at 40x30,
  2 spp, 8 bounces: 99.04% of samples equal, every count equal);
* the impls and the renderer on the CPU, and the draws they need.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.distill import DistilledGuide as JaxGuide
from raytracer_tpu.render.camera import perspective_rays as jax_perspective
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace.path import make_observation as jax_observation
from raytracer_tpu.trace.path import trace_path as jax_trace_path
from raytracer_tpu_torch.fb.distill import DistilledGuide
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.trace.path import (make_observation, observation_c,
                                            trace_path)

from test_path import _lean_scene
from test_torch_path import _rays
from test_torch_scene import port_scene

STATS = ("total_rays", "total_intersections", "light_hits",
         "small_light_hits", "fb_used", "fb_success")


def jax_planes(key, max_bounces, n):
    """The JAX tracers' per-level draws: ``uniforms [L, R, 2]`` from
    ``k_diff`` and ``fb_uniforms [L, R]`` from ``k_fb``, ``k_diff, k_fb =
    split(split(key, L)[l])``."""
    u, f = [], []
    for k in jax.random.split(key, max_bounces):
        k_diff, k_fb = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_diff, (n, 2), jnp.float32)))
        f.append(np.asarray(jax.random.uniform(k_fb, (n,), jnp.float32)))
    return np.stack(u), np.stack(f)


def one_hot_params(hidden=4):
    """tests/test_pallas_path.py:111's student: a0 = px, a1 = -nx."""
    k1 = np.zeros((22, hidden), np.float32)
    for j, c in enumerate((0, 1, 2, 6)):
        k1[c, j] = 1.0
    k2 = np.zeros((hidden, 2), np.float32)
    k2[0, 0], k2[3, 1] = 1.0, -1.0
    return {"Dense_0": {"kernel": k1, "bias": np.zeros(hidden, np.float32)},
            "Dense_1": {"kernel": k2, "bias": np.zeros(2, np.float32)}}


def guides(params, hidden, dtype):
    """The same student as a JAX and as a port guide."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return (JaxGuide(jp, hidden).as_guide_fn(dtype=dtype),
            DistilledGuide(params, hidden).as_guide_fn(dtype=dtype))


def run_both(js, o, d, key, jax_impl, jguide, tguide, port_impl="plain",
             **kw):
    rgb_j, st_j = jax_trace_path(js, jnp.asarray(o), jnp.asarray(d), key,
                                 impl=jax_impl, guide_fn=jguide, **kw)
    u, f = jax_planes(key, kw["max_bounces"], o.shape[0])
    rgb_t, st_t = trace_path(port_scene(js), torch.from_numpy(o),
                             torch.from_numpy(d), impl=port_impl,
                             guide_fn=tguide, uniforms=torch.from_numpy(u),
                             fb_uniforms=torch.from_numpy(f), **kw)
    return (np.asarray(rgb_j), {s: int(getattr(st_j, s)) for s in STATS},
            rgb_t.numpy(), st_t.as_dict())


def test_make_observation_equals_jax():
    js = _lean_scene()
    rng = np.random.RandomState(0)
    n = 997
    p, nrm, dd = (rng.randn(n, 3).astype(np.float32) for _ in range(3))
    bounce = rng.randint(0, 8, n).astype(np.float32)
    colour = rng.randint(0, 256, (n, 3)).astype(np.float32)
    idx = rng.randint(0, js.centre.shape[0], n).astype(np.int32)
    want = np.asarray(jax_observation(
        jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(dd),
        jnp.asarray(bounce), jnp.asarray(colour), js, jnp.asarray(idx), 8))
    t = torch.from_numpy
    got = make_observation(t(p), t(nrm), t(dd), t(bounce), t(colour),
                           port_scene(js), t(idx), 8).numpy()
    assert got.shape == (n, 22) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # The tracers' component form: colour 0, one bounce level.
    ts = port_scene(js)
    ti = t(idx).long()
    comp = observation_c(*(t(a[:, c]) for a in (p, dd, nrm)
                           for c in range(3)),
                         ts.reflective[ti], ts.transparent[ti],
                         ts.emitive[ti], ts.ior[ti], ts.id[ti].float(), 3, 8)
    full = make_observation(t(p), t(nrm), t(dd), torch.full((n,), 3.0),
                            torch.zeros((n, 3)), ts, t(idx), 8)
    np.testing.assert_array_equal(comp.numpy(), full.numpy())


@pytest.mark.parametrize("dtype", [None, "auto"])
@pytest.mark.parametrize("jax_impl", ["fused", "lean"])
def test_one_hot_student_exact_vs_jax(jax_impl, dtype):
    o, d = _rays(2600, seed=4)
    jg, tg = guides(one_hot_params(), (4,), dtype)
    rj, sj, rt, st = run_both(_lean_scene(), o, d, jax.random.key(5),
                              jax_impl, jg, tg, max_bounces=4,
                              mirror_threshold=0.9, fb_prob=1.0)
    np.testing.assert_array_equal(rt, rj)
    assert st == sj
    assert st["fb_used"] > 0


@pytest.mark.parametrize("port_impl", ["plain", "kernel", "hybrid"])
def test_fb_gate_exact_vs_fused(port_impl):
    """fb_prob 0.5: diffuse lanes above the gate take the cosine bounce
    from the same uniforms; every port impl equals fused."""
    o, d = _rays(1500, seed=8)
    jg, tg = guides(one_hot_params(), (4,), "auto")
    rj, sj, rt, st = run_both(_lean_scene(), o, d, jax.random.key(9),
                              "fused", jg, tg, port_impl=port_impl,
                              max_bounces=4, mirror_threshold=0.9,
                              fb_prob=0.5)
    np.testing.assert_array_equal(rt, rj)
    assert st == sj
    assert 0 < st["fb_used"] < st["total_intersections"]


def test_shipped_student_within_pallas_bounds_vs_fused():
    js, _, _, p = jax_library.chandelier_scene()
    W, H, spp = 40, 30, 2
    jit = np.random.RandomState(0).rand(spp, H, W, 2).astype(np.float32)
    with jax.enable_x64(False):
        o, d = jax_perspective(W, H, fov=p["fov"],
                               origin=p["camera_position"], variant="fb",
                               sample_xy=jnp.asarray(jit))
    o = np.array(o, np.float32).reshape(-1, 3)
    d = np.array(d, np.float32).reshape(-1, 3)
    name = "fb_chandelier_distilled.npz"
    jg = JaxGuide.load(STUDENTS_DIR / name).as_guide_fn()
    tg = DistilledGuide.load(STUDENTS_DIR / name).as_guide_fn()
    rj, sj, rt, st = run_both(js, o, d, jax.random.key(3), "fused", jg, tg,
                              max_bounces=8, mirror_threshold=0.9,
                              fb_prob=1.0)
    assert np.isfinite(rt).all()
    assert st["fb_used"] > 0 and st["fb_success"] > 0
    assert (rt == rj).all(-1).mean() >= 0.9, (rt == rj).all(-1).mean()
    for f in ("light_hits", "small_light_hits"):
        assert sj[f] > 0 and 0.9 <= st[f] / sj[f] <= 1.12, (f, st, sj)


def test_render_path_guided_impls_agree_on_cpu():
    scene, _, _, p = library.chandelier_scene(device="cpu")
    guide = DistilledGuide.load(
        STUDENTS_DIR / "fb_chandelier_distilled.npz").as_guide_fn()
    kw = dict(width=24, height=18, spp=2, max_bounces=5,
              camera_position=p["camera_position"], mirror_threshold=0.9,
              guide_fn=guide, fb_prob=1.0, device="cpu")
    out = [render_path(scene, impl=impl,
                       generator=torch.Generator().manual_seed(4), **kw)
           for impl in ("kernel", "plain", "hybrid")]
    for img, st in out[1:]:
        assert torch.equal(img, out[0][0])
        assert st.as_dict() == out[0][1].as_dict()
    img, st = out[0]
    assert img.shape == (18, 24, 3) and st.as_dict()["fb_used"] > 0
    # The generator draws jitter, then the uniforms, then the fb plane.
    g = torch.Generator().manual_seed(4)
    jitter = torch.rand((2, 18, 24, 2), generator=g)
    u = torch.rand((5, 2 * 18 * 24, 2), generator=g)
    f = torch.rand((5, 2 * 18 * 24), generator=g)
    img2, st2 = render_path(scene, impl="plain", jitter=jitter, uniforms=u,
                            fb_uniforms=f, **kw)
    assert torch.equal(img2, img) and st2.as_dict() == st.as_dict()


def test_guided_draws_and_no_diffuse_scene():
    scene, _, _, _ = library.chandelier_scene(device="cpu")
    o, d = (torch.from_numpy(a) for a in _rays(64, seed=2))
    guide = DistilledGuide(one_hot_params(), (4,)).as_guide_fn()
    u = torch.rand((3, 64, 2), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="fb_uniforms"):
        trace_path(scene, o, d, max_bounces=3, mirror_threshold=0.9,
                   uniforms=u, guide_fn=guide, impl="plain")
    # At mirror_threshold=0.0 no chandelier lane is diffuse: no draw is
    # needed and the guide never fires.
    a, sa = trace_path(scene, o, d, max_bounces=3, mirror_threshold=0.0,
                       guide_fn=guide, impl="kernel")
    b, sb = trace_path(scene, o, d, max_bounces=3, mirror_threshold=0.0,
                       impl="kernel")
    assert torch.equal(a, b) and sa.as_dict() == sb.as_dict()
    assert sa.as_dict()["fb_used"] == 0
