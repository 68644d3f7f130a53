"""The FB learner's walk in the port (raytracer_tpu_torch/fb/trajectory.py,
scene/templates.py, scene/complex.py, trace/sampling.py) held against
raytracer_tpu's on the same inputs.

* Every template at two variations, padded to 64: equal to JAX's table,
  field for field and dtype for dtype.
* The sampling functions (trainer and renderer frames, cosine draw,
  ``direction_to_action``, ``uniform_on_sphere``) on JAX-drawn uniforms:
  within 4e-6 absolute on unit vectors and actions (XLA's CPU ``sin``,
  ``cos``, ``acos`` and ``atan2`` round differently from PyTorch's by an
  ulp or two).
* ``generate_trajectories`` on JAX's draws, reproduced from its key
  schedule (``WalkDraws``), for the three start biases, with and without a
  guide in the loop: ``valid``, ``hit_light``, ``hit_small``,
  ``episode_hit`` and the sphere-id feature equal; on the valid steps each
  float within ``WALK_TOL`` (2e-3) of ``max(|JAX value|, 1)`` and at least
  98% of them within 1e-5.  JAX runs the walk jitted: XLA's reciprocal
  multiplies and its CPU ``sin``/``cos``/``acos``/``log1p`` differ from
  PyTorch's by an ulp, and a walk amplifies that: a normal on a radius-0.08
  light is ``(p − c)/r``, so an ulp of ``p`` at |p| ≈ 10 moves it by
  ~1e-5, and the next hit 100 units away by ~1e-3 (measured at most
  1.3e-3, 0–1.6% of values above 1e-5).
* A ray toward a pad dummy: JAX's ``found``, ``idx`` and ``t`` (1e9)
  reproduced by the port's sweep; and a walk guided toward +z, whose
  steps land on the dummies in both packages (there only ``z`` ≈ 1e9 and
  the id are compared: x, y and the normal 1e9 away are rounding noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core.intersect import nearest_hit as jax_nearest_hit
from raytracer_tpu.fb.trajectory import generate_trajectories as jax_walk
from raytracer_tpu.scene import templates as jax_templates
from raytracer_tpu.scene.complex import create_complex_scene as jax_complex
from raytracer_tpu.trace import sampling as jax_sampling
from raytracer_tpu_torch.core import cuda_intersect
from raytracer_tpu_torch.fb.trajectory import (WalkDraws, draw_walk,
                                               generate_trajectories)
from raytracer_tpu_torch.scene import templates
from raytracer_tpu_torch.scene.complex import create_complex_scene
from raytracer_tpu_torch.trace import sampling

from test_torch_scene import jax_scene_numpy, port_scene

FIELDS = ("centre", "radius", "colour", "reflective", "transparent",
          "emitive", "ior", "id")
SAMPLE_TOL = 4e-6
WALK_TOL = 2e-3
WALK_CLOSE = 1e-5
WALK_CLOSE_SHARE = 0.98


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(jax_templates.TEMPLATES))
def test_templates_equal_jax(name):
    for v in (0, 7):
        js, jname = jax_templates.generate_scene(name, v, pad_to=64)
        ts, tname = templates.generate_scene(name, v, pad_to=64,
                                             device="cpu")
        assert tname == jname and ts.num_spheres == 64
        want = jax_scene_numpy(js)
        for f in FIELDS:
            got = getattr(ts, f).numpy()
            assert got.dtype == want[f].dtype, (name, v, f)
            np.testing.assert_array_equal(got, want[f], err_msg=f)


def test_complex_scene_and_lights_equal_jax():
    js, jgl, jpl = jax_complex()
    ts, tgl, tpl = create_complex_scene(device="cpu")
    assert ts.num_spheres == 54
    want = jax_scene_numpy(js)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), want[f])
    for jl, tl in ((jgl, tgl), (jpl, tpl)):
        for f in ("colour", "strength", "max_angle"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)))


def _normals(n, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(np.float32)
    v[:8] = [[0, 0, 1], [0, 0, -1], [0, 1e-3, 1], [1e-4, 0, -1],
             [0.3, 0, 0.95], [1, 0, 0], [0, 1, 0], [0.04, 0.02, 0.999]]
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_sampling_matches_jax():
    n = _normals(512, seed=1)
    key = jax.random.key(2)
    k1, k2, k3 = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k1, (512, 2), jnp.float32))
    act = np.asarray(jax.random.uniform(k2, (512, 2), jnp.float32,
                                        -1.0, 1.0))
    for conv in ("trainer", "renderer", "env"):
        want = np.asarray(jax_sampling.cosine_weighted(k1, jnp.asarray(n),
                                                       conv))
        got = sampling.cosine_weighted(_t(u), _t(n), conv).numpy()
        assert np.abs(got - want).max() <= SAMPLE_TOL, conv
        want = np.asarray(jax_sampling.fb_action_to_direction(
            jnp.asarray(act), jnp.asarray(n), conv))
        got = sampling.fb_action_to_direction(_t(act), _t(n), conv).numpy()
        assert np.abs(got - want).max() <= SAMPLE_TOL, conv
        # The component forms take the same frame.
        want = np.asarray(jnp.stack(jax_sampling.tangent_frame_c(
            *jnp.asarray(n).T, conv)))
        got = torch.stack(sampling.tangent_frame_c(*_t(n).T, conv)).numpy()
        assert np.abs(got - want).max() <= SAMPLE_TOL, conv
    d = np.array(jax_sampling.cosine_weighted(k3, jnp.asarray(n),
                                                "trainer"))
    d[:64] = -d[:64]                  # below the hemisphere: the clamp
    want = np.asarray(jax_sampling.direction_to_action(
        jnp.asarray(d), jnp.asarray(n), "trainer"))
    got = sampling.direction_to_action(_t(d), _t(n), "trainer").numpy()
    assert np.abs(got - want).max() <= SAMPLE_TOL
    assert (got[:64, 0] == 1.0).all() and (want[:64, 0] == 1.0).all()
    centre = np.random.RandomState(3).randn(512, 3).astype(np.float32) * 10
    radius = np.random.RandomState(4).rand(512).astype(np.float32) * 5
    jp, jo = jax_sampling.uniform_on_sphere(k1, jnp.asarray(centre),
                                            jnp.asarray(radius))
    tp, to = sampling.uniform_on_sphere(_t(u), _t(centre), _t(radius))
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= SAMPLE_TOL
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 10 * SAMPLE_TOL
    with pytest.raises(ValueError, match="convention"):
        sampling.tangent_frame_c(*_t(n).T, "screen")


def jax_walk_draws(key, W, N, T, start_bias, guided):
    """``generate_trajectories``' draws from ``key`` in its key schedule
    (raytracer_tpu/fb/trajectory.py:101-160), each in the dtype JAX draws
    it in (under the tests' x64: weakly typed scalars make the uniform
    start logits, the wall logits, ``k_mix`` and ``kg_u`` float64)."""
    f32, dflt = jnp.float32, jnp.result_type(float)
    k_start, k_point, k_dir, k_walk = jax.random.split(key, 4)
    g_dtype = f32 if start_bias in ("small", "mixed") else dflt
    kw = {}
    if start_bias == "mixed":
        _, k_wall, k_mix, k_tgt = jax.random.split(k_point, 4)
        kw = dict(wall_gumbel=_t(jax.random.gumbel(k_wall, (W, N), dflt)),
                  mix_u=_t(jax.random.uniform(k_mix, (W,))),
                  target_u=_t(jax.random.uniform(k_tgt, (W, 3), f32)))
    step_u, g_n, g_u = [], [], []
    for k in jax.random.split(k_walk, T):
        k1, k2 = jax.random.split(k)
        step_u.append(jax.random.uniform(k1, (W, 2), f32))
        if guided:
            _, kg_n, kg_u = jax.random.split(k2, 3)
            g_n.append(jax.random.normal(kg_n, (W, 2), f32))
            g_u.append(jax.random.uniform(kg_u, (W,)))
    if guided:
        kw.update(guide_normal=_t(jnp.stack(g_n)), guide_u=_t(jnp.stack(g_u)))
    return WalkDraws(
        start_gumbel=_t(jax.random.gumbel(k_start, (W, N), g_dtype)),
        point_u=_t(jax.random.uniform(k_point, (W, 2), f32)),
        dir_u=_t(jax.random.uniform(k_dir, (W, 2), f32)),
        step_u=_t(jnp.stack(step_u)), **kw)


def _linear_guide(seed):
    """A fixed linear policy, the same function in both packages:
    ``tanh(obs @ w) * 0.95`` (the guide's role in the walk, not its
    networks)."""
    w = (np.random.RandomState(seed).randn(22, 2) * 0.3).astype(np.float32)
    wj, wt = jnp.asarray(w), _t(w)

    def jax_apply(params, obs, proto):
        return jnp.tanh(obs @ wj) * 0.95

    def port(obs):
        return torch.tanh(obs @ wt) * 0.95

    return jax_apply, port


def _toward_plus_z():
    """A guide aiming every walker at +z (``direction_to_action`` of
    (0, 0, 1) about the observation's normal): on an upper surface the step
    then leaves within float rounding of +z, toward the pad dummies."""
    def jax_apply(params, obs, proto):
        up = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], obs.dtype),
                              obs[:, 6:9].shape)
        return jax_sampling.direction_to_action(up, obs[:, 6:9], "trainer")

    def port(obs):
        up = torch.tensor([0.0, 0.0, 1.0]).expand(obs.shape[0], 3)
        return sampling.direction_to_action(up, obs[:, 6:9], "trainer")

    return jax_apply, port


def compare_walk(js, ts, key, W, T, start_bias, guide=None, prob=0.5,
                 noise=0.1):
    draws = jax_walk_draws(key, W, js.num_spheres, T, start_bias,
                           guide is not None)
    jkw, tkw = {}, {}
    if guide is not None:
        jax_apply, port = guide
        jkw = dict(guide_apply=jax_apply, guide_params=0.0,
                   guide_proto=jnp.zeros((2,)), guide_prob=prob,
                   guide_noise=noise)
        tkw = dict(guide=port, guide_prob=prob, guide_noise=noise)
    want = jax_walk(js, key, num_walkers=W, max_steps=T,
                    start_bias=start_bias, **jkw)
    got = generate_trajectories(ts, draws, max_steps=T,
                                start_bias=start_bias, **tkw)
    for f in ("valid", "hit_light", "hit_small", "episode_hit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    v = got.valid.numpy()
    assert v.any()
    # A step onto a pad dummy ends 1e9 away: its point's x and y and its
    # normal are rounding noise in both packages (checked apart: z and id).
    dummy = np.rint(np.asarray(want.next_obs)[..., 18] * 100) == \
        templates.DUMMY_ID
    for f in ("obs", "action", "next_obs", "reward"):
        m = v & ~dummy if f == "next_obs" else v
        a, b = getattr(got, f).numpy()[m], np.asarray(getattr(want, f))[m]
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        assert rel.max() <= WALK_TOL, (f, rel.max())
        assert (rel <= WALK_CLOSE).mean() >= WALK_CLOSE_SHARE, f
    z_got = got.next_obs.numpy()[..., 2][v & dummy]
    z_want = np.asarray(want.next_obs)[..., 2][v & dummy]
    assert (np.abs(z_got - z_want) <= 1e-6 * np.abs(z_want)).all()
    # The sphere-id feature (id / 100) names the same spheres.
    np.testing.assert_array_equal(
        np.rint(got.next_obs.numpy()[v][:, 18] * 100),
        np.rint(np.asarray(want.next_obs)[v][:, 18] * 100))
    return got


# (template, variation, padded size, start bias): the chandelier trainer's
# own case at its 64 spheres; the other biases on the cornell box padded to
# 16 (JAX's jitted walk compiles its sphere loop unrolled: ~17 s at 64).
WALKS = [("chandelier_scene", 3, 64, "mixed"),
         ("cornell_box", 2, 16, "uniform"),
         ("cornell_box", 2, 16, "small")]


@pytest.mark.parametrize("name,variation,pad,start_bias", WALKS)
def test_walk_matches_jax(name, variation, pad, start_bias):
    js, _ = jax_templates.generate_scene(name, variation, pad_to=pad)
    got = compare_walk(js, port_scene(js), jax.random.key(11), 256, 8,
                       start_bias)
    assert got.hit_light.any()


def test_guided_walk_matches_jax():
    js, _ = jax_templates.generate_scene("cornell_box", 2, pad_to=16)
    got = compare_walk(js, port_scene(js), jax.random.key(12), 256, 6,
                       "mixed", guide=_linear_guide(5))
    assert got.hit_light.any()


def test_walk_on_a_small_scene_hits_lights():
    """JAX's shapes-and-hits test (tests/test_fb_trainer.py), on both
    packages' same draws."""
    from raytracer_tpu.scene.types import SceneBuilder
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, (200, 120, 80), id=1)
    b.add_sphere((3, 0, 0), 0.8, (120, 200, 80), id=2)
    b.add_sphere((0, 25, 0), 20.0, (255, 255, 240), emitive=1.0, id=9)
    js, _, _ = b.build()
    got = compare_walk(js, port_scene(js), jax.random.key(0), 128, 6,
                       "uniform")
    assert got.obs.shape == (6, 128, 22)
    assert got.episode_hit.float().mean() > 0.1
    hl, v = got.hit_light.numpy(), got.valid.numpy()
    assert (got.reward.numpy()[hl] == 1.0).all()
    assert (got.reward.numpy()[~hl & v] == 0.0).all()


@pytest.mark.parametrize("name", ["cornell_box", "occluded_lights",
                                  "simple_challenging"])
def test_rays_toward_pad_dummy(name):
    """From (1e4, 1e4, 0) along +z and within 1e-4 rad of it, float32
    rounds ``d2`` against the radius-0 dummy at z = 1e9 to 0: JAX finds the
    first dummy at t = 1e9, and so does the port; at 1e-3 rad both miss."""
    js, _ = jax_templates.generate_scene(name, 0, pad_to=64)
    ts = port_scene(js)
    d = np.array([[0, 0, 1], [0, 1e-5, 1], [0, 1e-4, 1], [0, 1e-3, 1]],
                 np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.float32([1e4, 1e4, 0]), (4, 1))
    sup = np.full(4, 5, np.int32)
    want = jax_nearest_hit(jnp.asarray(o), jnp.asarray(d), js,
                           jnp.asarray(sup), by_abs=True)
    t, idx, found = cuda_intersect.nearest_hit(
        _t(o), _t(d), _t(sup), cuda_intersect.sphere_table(ts), by_abs=True)
    np.testing.assert_array_equal(found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(found.numpy(), [True, True, True, False])
    first_dummy = int(np.nonzero(np.asarray(js.radius) == 0)[0][0])
    np.testing.assert_array_equal(idx.numpy()[:3], first_dummy)
    np.testing.assert_array_equal(idx.numpy()[:3],
                                  np.asarray(want.idx)[:3])
    np.testing.assert_array_equal(t.numpy()[:3], np.asarray(want.t)[:3])
    assert (t.numpy()[:3] == np.float32(1e9)).all()


def test_walk_into_pad_dummies_matches_jax():
    """Walkers on an open template, every step guided toward +z without
    noise: those on an upper surface leave within rounding of +z and
    record a valid step on the first dummy (id -999999, t ≈ 1e9) in both
    packages."""
    js, _ = jax_templates.generate_scene("simple_challenging", 1, pad_to=8)
    got = compare_walk(js, port_scene(js), jax.random.key(13), 256, 4,
                       "small", guide=_toward_plus_z(), prob=1.0, noise=0.0)
    on_dummy = got.valid & (torch.round(got.next_obs[..., 18] * 100)
                            == templates.DUMMY_ID)
    assert on_dummy.sum() >= 10
    assert (got.next_obs[..., 2][on_dummy] > 1e8).all()


def test_draw_walk_planes():
    g = torch.Generator().manual_seed(0)
    d = draw_walk(32, 64, 5, start_bias="mixed", guided=True, generator=g,
                  device="cpu")
    assert d.start_gumbel.shape == (32, 64) and d.step_u.shape == (5, 32, 2)
    assert d.guide_u.shape == (5, 32) and d.target_u.shape == (32, 3)
    assert torch.isfinite(d.start_gumbel).all()
    d2 = draw_walk(32, 64, 5, start_bias="uniform", generator=g,
                   device="cpu")
    assert d2.wall_gumbel is None and d2.guide_u is None
    js, _ = jax_templates.generate_scene("chandelier_scene", 0, pad_to=64)
    with pytest.raises(ValueError, match="guided walk"):
        generate_trajectories(port_scene(js), d2, max_steps=5,
                              guide=lambda o: o[:, :2])
    with pytest.raises(ValueError, match="start_bias"):
        generate_trajectories(port_scene(js), d2, max_steps=5,
                              start_bias="walls")
