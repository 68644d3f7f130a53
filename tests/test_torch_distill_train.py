"""The training side of the port's distillation (raytracer_tpu_torch/fb/
distill.py) held against the JAX package's on the same observations,
actions and draws.

* ``collect_observations`` at 24x12@2spp/8 (chandelier, mirror_threshold
  0.9), one frame, its planes from JAX's key schedule (``key,
  kf, kt = split(key, 3)``), against JAX run op by op: with a guide that
  bounces along the normal, equal; with a varied one, within the bounds
  its test states.  (JAX's jitted walk is not its op-by-op walk: XLA
  rounds it otherwise.)
* On those observations, random actions and exact aims at the small
  lights, against JAX op by op: ``light_hit_weights`` equal,
  ``hindsight_aim_targets`` masks and weights equal and targets within
  1e-6 (jitted JAX is further away: its ``acos`` of a cosine near 1
  magnifies the dot product's last bit),
  ``best_of_teachers_targets`` equal weights and targets within 1e-6.
* One ``distill`` Adam step from JAX's initial parameters (the same
  jitter copies and permutation from ``np.random.default_rng``) within
  1e-6 of optax's; the cosine decay equal to optax's schedule to float32
  rounding (2e-7 of the rate); the fidelity checks of ``tests/test_distill.py`` on the
  port's own training.
* A student saved by the port loads in JAX's ``DistilledGuide.load`` with
  equal actions, and JAX's in the port's.
* ``distill_agent`` end to end on a narrow seeded agent, its student
  through the kernel impl's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracer_tpu.fb import distill as jax_distill
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace.sampling import \
    direction_to_action as jax_direction_to_action
from raytracer_tpu_torch.fb import distill
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.render.path_renderer import render_path

from test_torch_fb_networks import NARROW
from test_torch_guided import jax_planes
from test_torch_scene import one_torch_thread, port_scene  # noqa: F401
from test_torch_stepwise import exact_guide_jax, exact_guide_port

pytestmark = pytest.mark.usefixtures("one_torch_thread")


W, H, SPP, BOUNCES, FRAMES = 24, 12, 2, 8, 1


def frame_planes(key, frames=FRAMES, w=W, h=H, spp=SPP, bounces=BOUNCES):
    """JAX ``collect_observations``'s draws: each frame's ``key, kf, kt =
    split(key, 3)``, the jitter from kf, the levels' uniforms from kt."""
    out = []
    for _ in range(frames):
        key, kf, kt = jax.random.split(key, 3)
        jit = np.array(jax.random.uniform(kf, (spp, h, w, 2), jnp.float32))
        out.append((jit, jax_planes(kt, bounces, spp * h * w)[0]))
    return out


def steady_guide_jax(obs):
    """Action (-1, 0): θ = φ = 0, the bounce along the normal, so no sine
    or cosine rounds (PyTorch's CPU sin and cos differ from XLA's by an ulp
    on some float32 arguments)."""
    return jnp.stack([jnp.full(obs.shape[:1], -1.0, obs.dtype),
                      jnp.zeros(obs.shape[:1], obs.dtype)], axis=-1)


def steady_guide_port(obs):
    return torch.stack([torch.full(obs.shape[:1], -1.0),
                        torch.zeros(obs.shape[:1])], dim=-1)


def collect_both(jax_guide, port_guide):
    """``(jax scene, port scene, JAX's observations op by op, the
    port's)`` at the module's config, on JAX's draws."""
    js, _, _, p = jax_library.chandelier_scene()
    ts = port_scene(js)
    key = jax.random.key(2)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
              frames=FRAMES, camera_position=p["camera_position"])
    with jax.enable_x64(False):
        with jax.disable_jit():
            want = jax_distill.collect_observations(js, jax_guide, key, **kw)
        planes = frame_planes(key)
    got = distill.collect_observations(ts, port_guide, frame_planes=planes,
                                       device="cpu", **kw)
    return js, ts, want, got


@pytest.fixture(scope="module")
def chandelier_obs():
    return collect_both(steady_guide_jax, steady_guide_port)


def test_collect_observations_matches_jax(chandelier_obs):
    _, _, want, got = chandelier_obs
    assert got.dtype == np.float32 and got.shape[1] == 22
    assert got.shape == want.shape and got.shape[0] > 2000
    np.testing.assert_array_equal(got, want)


def test_collect_observations_with_a_varied_guide():
    """The exact elementwise guide of tests/test_torch_stepwise.py: its
    actions go through sin and cos, which PyTorch's CPU and XLA round apart
    on some arguments, so paths part by an ulp after a guided bounce.
    Bounds: the same number of rows, the first level's rows equal, at least
    85% of all rows equal, every value within 1e-3 (measured: 90.9%,
    4.5e-4)."""
    _, _, want, got = collect_both(exact_guide_jax, exact_guide_port)
    assert got.shape == want.shape
    first = got[:, 16] == 0.0
    np.testing.assert_array_equal(got[first], want[first])
    assert (got == want).all(axis=1).mean() >= 0.85
    assert np.abs(got - want).max() <= 1e-3


def aimed_actions(js, obs, rng):
    """Random actions, with every third row aimed exactly at a small
    light's centre (JAX's ``direction_to_action``, renderer frame)."""
    acts = rng.uniform(-1, 1, (obs.shape[0], 2)).astype(np.float32)
    small = np.nonzero((np.asarray(js.emitive) > 0)
                       & (np.asarray(js.radius) < 0.5))[0]
    rows = np.arange(0, obs.shape[0], 3)
    centres = np.asarray(js.centre)[small[rows % len(small)]]
    with jax.enable_x64(False):
        aim = centres - obs[rows, 0:3]
        aim = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
        acts[rows] = np.asarray(jax_direction_to_action(
            jnp.asarray(aim, jnp.float32), jnp.asarray(obs[rows, 6:9]),
            convention="renderer"))
    return acts


def test_shooting_targets_match_jax(chandelier_obs):
    js, ts, _, obs = chandelier_obs
    acts = aimed_actions(js, obs, np.random.default_rng(0))
    with jax.enable_x64(False), jax.disable_jit():
        w_j = jax_distill.light_hit_weights(js, obs, acts)
        t_j, hw_j = jax_distill.hindsight_aim_targets(js, obs, acts)
    w_t = distill.light_hit_weights(ts, obs, acts, device="cpu")
    t_t, hw_t = distill.hindsight_aim_targets(ts, obs, acts, device="cpu")
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(hw_t, hw_j)
    np.testing.assert_array_equal(hw_t, w_t)
    assert (w_t == 19.0).sum() > 10 and (w_t == 1.0).sum() > 10
    assert t_t.dtype == np.float32
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-6)


def test_best_of_teachers_matches_jax(chandelier_obs, capsys):
    js, ts, _, obs = chandelier_obs
    acts = aimed_actions(js, obs, np.random.default_rng(1))
    other = np.random.default_rng(2).uniform(
        -1, 1, acts.shape).astype(np.float32)
    with jax.enable_x64(False), jax.disable_jit():
        t_j, w_j = jax_distill.best_of_teachers_targets(
            js, obs, [lambda o: jnp.asarray(other), lambda o: jnp.asarray(
                acts)])
    t_t, w_t = distill.best_of_teachers_targets(
        ts, obs, [lambda o: torch.from_numpy(other),
                  lambda o: torch.from_numpy(acts)], device="cpu")
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-6)
    assert (w_t == 19.0).sum() > 10
    with pytest.raises(ValueError, match="teacher"):
        distill.best_of_teachers_targets(ts, obs, [], device="cpu")


def teacher_port(obs):
    return torch.clamp(obs[:, 0:2] * 0.5 - obs[:, 6:8], -1.0, 1.0)


def teacher_jax(obs):
    return jnp.clip(obs[:, 0:2] * 0.5 - obs[:, 6:8], -1.0, 1.0)


def test_one_adam_step_matches_optax():
    """One step (n below the batch size: one step an epoch) from JAX's
    initial parameters, jitter 0.02 on both sides."""
    obs = np.random.default_rng(3).normal(size=(300, 22)).astype(np.float32)
    weights = np.random.default_rng(4).uniform(1, 3, 600).astype(np.float32)
    kw = dict(seed=7, hidden=(16, 8), epochs=1, batch_size=1024,
              learning_rate=3e-3, jitter=0.02)
    with jax.enable_x64(False):
        want = jax_distill.distill(teacher_jax, obs, weights=weights, **kw)
        init = jax_distill.StudentPolicy(hidden=(16, 8)).init(
            jax.random.key(7), jnp.zeros((1, 22)))["params"]
        init = jax.tree_util.tree_map(np.array, init)
    got = distill.distill(teacher_port, obs, weights=weights,
                          init_params=init, device="cpu", **kw)
    assert got.n_obs == want.n_obs == 600
    assert abs(got.final_loss - want.final_loss) <= 1e-6 * want.final_loss
    for layer, p in want.params.items():
        for name in ("kernel", "bias"):
            a, b = got.params[layer][name], np.asarray(p[name])
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-6, (layer, name)
            assert np.abs(a - init[layer][name]).max() > 1e-4


def test_cosine_decay_equals_optax():
    with jax.enable_x64(False):
        sched = optax.cosine_decay_schedule(3e-3, 40, alpha=1e-3)
        want = [float(sched(jnp.asarray(k, jnp.int32))) for k in range(45)]
    got = [distill.cosine_decay_lr(3e-3, k, 40) for k in range(45)]
    # optax rounds ``1 + cos`` (terms up to 2) in float32: 2e-7 of lr.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7 * 3e-3)


def test_distill_fidelity_and_roundtrip(tmp_path):
    """tests/test_distill.py::test_distill_roundtrip_and_fidelity on the
    port, from the same teacher (a random 22->32->2 student, key 1) and
    JAX's initial student (key 0): 120 epochs at batch 2048 with no jitter
    drive the loss below 0.05 and within 1e-4 of JAX's own fit of the same
    data (measured 0.043287 against 0.043291), the mean action error below
    0.25; save and load bit for bit.  The final loss depends on the
    initial student, so the pin starts from JAX's, as the JAX test does."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(4096, 22)).astype(np.float32)
    with jax.enable_x64(False):
        teacher = jax_distill.StudentPolicy(hidden=(32,)).init(
            jax.random.key(1), jnp.zeros((1, 22)))["params"]
        init = jax_distill.StudentPolicy(hidden=(64, 64)).init(
            jax.random.key(0), jnp.zeros((1, 22)))["params"]
        want = jax_distill.distill(
            lambda o: jax_distill.StudentPolicy(hidden=(32,)).apply(
                {"params": teacher}, o),
            obs, epochs=120, batch_size=2048, hidden=(64, 64),
            jitter=0.0).final_loss
    teacher = distill.DistilledGuide(
        jax.tree_util.tree_map(np.array, teacher), (32,)).as_guide_fn(None)
    res = distill.distill(teacher, obs, epochs=120, batch_size=2048,
                          hidden=(64, 64), jitter=0.0, device="cpu",
                          init_params=jax.tree_util.tree_map(np.array, init))
    assert res.final_loss < 0.05
    assert abs(res.final_loss - want) < 1e-4
    g = distill.DistilledGuide(res.params, (64, 64))
    probe = torch.from_numpy(rng.normal(size=(128, 22)).astype(np.float32))
    err = (g.as_guide_fn(None)(probe) - teacher(probe)).abs()
    assert float(err.mean()) < 0.25
    g.save(tmp_path / "rt.npz")
    g2 = distill.DistilledGuide.load(tmp_path / "rt.npz")
    assert torch.equal(g.as_guide_fn(None)(probe), g2.as_guide_fn(None)(probe))


def test_students_load_across_packages(tmp_path):
    """The port's ``save`` read by JAX's ``load``, JAX's ``save`` by the
    port's: the loading package's actions equal to its own from the same
    parameters, and across packages within tests/test_torch_distill.py's
    f32 bound (rtol 1e-5, atol 1e-6)."""
    params = distill.init_student_params((24, 16),
                                         torch.Generator().manual_seed(5))
    probe = np.random.default_rng(6).normal(size=(256, 22)).astype(
        np.float32)
    ours = distill.DistilledGuide(params, (24, 16))
    ours.save(tmp_path / "port.npz")
    with jax.enable_x64(False):
        loaded = jax_distill.DistilledGuide.load(str(tmp_path / "port.npz"))
        direct = jax_distill.DistilledGuide(
            jax.tree_util.tree_map(jnp.asarray, params), (24, 16))
        a_loaded = np.asarray(loaded.as_guide_fn(None)(jnp.asarray(probe)))
        a_direct = np.asarray(direct.as_guide_fn(None)(jnp.asarray(probe)))
        loaded.save(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(a_loaded, a_direct)
    assert loaded.hidden == (24, 16)
    back = distill.DistilledGuide.load(tmp_path / "jax.npz")
    t_probe = torch.from_numpy(probe)
    assert torch.equal(back.as_guide_fn(None)(t_probe),
                       ours.as_guide_fn(None)(t_probe))
    assert torch.equal(back.as_guide_fn()(t_probe),
                       ours.as_guide_fn()(t_probe))
    np.testing.assert_allclose(ours.as_guide_fn(None)(t_probe).numpy(),
                               a_direct, rtol=1e-5, atol=1e-6)
    with np.load(tmp_path / "port.npz") as z, \
            np.load(tmp_path / "jax.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
        for k in z.files:
            assert z[k].dtype == zj[k].dtype
            np.testing.assert_array_equal(z[k], zj[k])


@pytest.mark.parametrize("sharpen", [False, True])
def test_distill_agent_end_to_end(sharpen):
    """A narrow seeded agent distilled on the chandelier (one frame an
    aspect, two epochs): a student of the asked widths that the kernel
    impl (its plain version here) takes as a guide."""
    ts = port_scene(jax_library.chandelier_scene()[0])
    cam = (0.0, 2.0, 0.0)
    agent = TrainedFBAgent(None, ts, small_light_indices(ts), cam,
                           config=FBConfig(**NARROW), seed=2, device="cpu")
    student, res = distill.distill_agent(agent, ts, frames=1, epochs=2,
                                         hidden=(16, 16), camera_position=cam,
                                         hindsight_sharpen=sharpen)
    assert res.n_obs > 1000 and np.isfinite(res.final_loss)
    assert student.hidden == (16, 16)
    img, st = render_path(ts, width=16, height=8, spp=1, max_bounces=3,
                          camera_position=cam, mirror_threshold=0.9,
                          guide_fn=student.as_guide_fn(), impl="kernel",
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert int(st.fb_used) > 0 and torch.isfinite(img).all()
