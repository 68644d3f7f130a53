"""The port's RL env (raytracer_tpu_torch/env/) held against the JAX
package's, on the CPU, on JAX's draws.

The JAX env runs op by op (``jax.disable_jit()``, 64-bit mode off, as on
its TPU).  PyTorch's CPU ``sin``/``cos`` differ from XLA's by an ulp on
some float32 arguments (the action's direction goes through them), so the
bit-for-bit comparison takes both packages' sines and cosines from XLA
(``xla_trig``); with PyTorch's own, the directions are held within 2
float32 ulps and the episodes within the bounds ``tests/test_env.py``
holds the JAX env to against the executed reference (2e-4, 2e-3)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.env import scenes as jax_scenes
from raytracer_tpu.env.raytracer_env import RayTracerEnv as JaxEnv
from raytracer_tpu.render.camera import perspective_rays as jax_perspective
from raytracer_tpu.core import vec as jax_vec
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace import sampling as jax_sampling
from raytracer_tpu_torch.core import vec
from raytracer_tpu_torch.env import scenes
from raytracer_tpu_torch.env.raytracer_env import OBS_DIM, RayTracerEnv
from raytracer_tpu_torch.render.camera import perspective_rays
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.trace import sampling

from test_torch_scene import jax_scene_numpy, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = Path(__file__).parent / "golden"
B = 64


@pytest.fixture
def xla_trig(monkeypatch):
    """``torch.sin``/``torch.cos`` as XLA's float32 ones (CPU tensors)."""
    def xla(name):
        f = getattr(jnp, name)

        def g(x):
            with jax.enable_x64(False):
                return torch.from_numpy(np.array(f(x.numpy())))
        return g
    monkeypatch.setattr(torch, "sin", xla("sin"))
    monkeypatch.setattr(torch, "cos", xla("cos"))


def make_envs(variant, max_bounces=5, **over):
    """The same env in both packages: the RL variant on training_scene_v1,
    the FB variant on the custom scene (sun id 7)."""
    if variant == "rl":
        js, jgl, jpl = jax_scenes.training_scene_v1()
        ts, tgl, tpl = scenes.training_scene_v1(device="cpu")
        kw = dict(image_width=64, image_height=48, fov=90,
                  max_bounces=max_bounces, variant="rl")
    else:
        js, jgl, jpl, _ = jax_library.custom_scene()
        ts, tgl, tpl, _ = library.custom_scene(device="cpu")
        kw = dict(image_width=64, image_height=48, fov=75,
                  max_bounces=max_bounces, variant="fb",
                  camera_position=(0, 0, 1), background=(2, 2, 5), sun_id=7)
    kw.update(over)
    return (JaxEnv(js, global_lights=jgl, point_lights=jpl, **kw),
            RayTracerEnv(ts, global_lights=tgl, point_lights=tpl, **kw))


def jax_actions(variant, key, n):
    if variant == "rl":
        return jax.random.uniform(key, (n, 2), jnp.float32,
                                  minval=jnp.array([0.0, 0.0]),
                                  maxval=jnp.array([jnp.pi / 2,
                                                    2 * jnp.pi]))
    return jax.random.uniform(key, (n, 2), jnp.float32, minval=-1, maxval=1)


MAX_BOUNCES = 3
STEPS = MAX_BOUNCES + 2


@pytest.fixture(scope="module")
def jax_runs():
    """Each variant's JAX episodes, op by op: its reset pixels, actions
    and outputs (reset obs, then a step's obs, reward, terminated,
    truncated, total_reward, bounce), numpy; the slow half of every
    comparison, so run once."""
    runs = {}
    for variant in ("rl", "fb"):
        je, _ = make_envs(variant, max_bounces=MAX_BOUNCES)
        with jax.enable_x64(False), jax.disable_jit():
            js, jo = je.reset(jax.random.key(1), batch=B)
            pixel, outs, acts = np.array(js.pixel), [(np.asarray(jo),)], []
            key = jax.random.key(2)
            for _ in range(STEPS):
                key, ka = jax.random.split(key)
                a = jax_actions(variant, ka, B)
                js, jo, jr, jt, ji = je.step(js, a)
                acts.append(np.array(a))
                outs.append(tuple(np.asarray(x) for x in (
                    jo, jr, jt, ji["truncated"], js.total_reward,
                    js.bounce)))
        runs[variant] = pixel, acts, outs
    return runs


def port_run(variant, pixel, acts):
    """The port's episodes on the same pixels and actions, in the layout
    of ``jax_runs``."""
    _, te = make_envs(variant, max_bounces=MAX_BOUNCES)
    ts, to = te.reset(B, pixel=pixel)
    outs = [(to.numpy(),)]
    for a in acts:
        ts, to, tr, tt, ti = te.step(ts, a)
        outs.append(tuple(x.numpy() for x in (
            to, tr, tt, ti["truncated"], ts.total_reward, ts.bounce)))
    return outs


@pytest.mark.parametrize("variant", ["rl", "fb"])
def test_env_matches_jax_op_by_op(variant, jax_runs, xla_trig):
    """Reset and ``max_bounces + 2`` steps over 64 lanes: obs, reward,
    terminated, truncated, total_reward and bounce bit for bit."""
    pixel, acts, want = jax_runs[variant]
    for i, (w, g) in enumerate(zip(want, port_run(variant, pixel, acts))):
        for wi, gi in zip(w, g):
            np.testing.assert_array_equal(gi, wi, err_msg=f"call {i}")


def test_env_with_torch_trig_within_bounds(jax_runs):
    """PyTorch's own sin/cos: each step's direction within 2 float32 ulps
    of JAX's.  An ulp can move a shading sum across a rounding (one colour
    step: 1/765 of reward, 1/255 of an observed colour), so at most 2 of
    the 64 lanes leave tests/test_env.py's bounds (2e-4 on rewards, 2e-3
    on observations), and termination is equal on every lane."""
    je, te = make_envs("rl", max_bounces=MAX_BOUNCES)
    with jax.enable_x64(False), jax.disable_jit():
        js, _ = je.reset(jax.random.key(1), batch=B)
        a = jax_actions("rl", jax.random.key(5), B)
        want = np.asarray(jax_sampling.env_action_to_direction(
            a, js.normal, "env"))
    ts, _ = te.reset(B, pixel=np.array(js.pixel))
    got = sampling.env_action_to_direction(torch.from_numpy(np.array(a)),
                                           ts.normal, "env").numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()
    pixel, acts, runs = jax_runs["rl"]
    off = np.zeros(B, bool)
    for want, got in zip(runs[1:], port_run("rl", pixel, acts)[1:]):
        off |= np.abs(got[0] - want[0]).max(-1) > 2e-3          # obs
        off |= np.abs(got[1] - want[1]) > 2e-4                  # reward
        off |= np.abs(got[4] - want[4]) > 2e-4                  # total
        np.testing.assert_array_equal(got[2], want[2])          # term
    assert off.sum() <= 2, off.sum()


def test_kernel_route_equals_plain_route_on_cpu():
    """On CPU tensors the kernel route runs the kernels' plain versions:
    the same episodes as ``impl="plain"``."""
    ts, gl, pl = scenes.training_scene_complete(device="cpu")
    envs = [RayTracerEnv(ts, image_width=40, image_height=30, fov=75,
                         max_bounces=4, global_lights=gl, point_lights=pl,
                         impl=impl) for impl in ("kernel", "plain")]
    gen = torch.Generator().manual_seed(3)
    pixel = envs[0].draw_pixels(B, gen)
    acts = torch.rand((6, B, 2), generator=gen) * torch.tensor(
        [np.pi / 2, 2 * np.pi])
    runs = []
    for env in envs:
        s, o = env.reset(B, pixel=pixel)
        outs = [o]
        for a in acts:
            s, o, r, t, _ = env.step(s, a)
            outs += [o, r, t, s.total_reward]
        runs.append(outs)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_reset_shapes_and_fixed_pixel():
    _, env = make_envs("rl")
    s, o = env.reset(32, generator=torch.Generator().manual_seed(0))
    assert o.shape == (32, OBS_DIM) and torch.isfinite(o).all()
    n = s.normal[s.hit]
    assert torch.allclose(n.norm(dim=-1), torch.ones(len(n)), atol=1e-5)
    _, o1 = env.reset(4, pixel=(50, 30))
    _, o2 = env.reset(4, pixel=torch.tensor([50, 30]))
    assert torch.equal(o1, o2) and torch.equal(o1[0], o1[3])
    with pytest.raises(ValueError, match="variant"):
        RayTracerEnv(s and env.scene, variant="x")


@pytest.mark.parametrize("variant", ["rl", "fb"])
def test_golden_trajectory(variant):
    """The executed reference env's scripted trajectory
    (tests/golden/env_trajectory_{rl,fb}.json) at tests/test_env.py's
    bounds."""
    fix = json.loads((GOLDEN / f"env_trajectory_{variant}.json").read_text())
    if variant == "rl":
        scene, gl, pl = scenes.training_scene_v1(device="cpu")
        env = RayTracerEnv(scene, image_width=fix["width"],
                           image_height=fix["height"], fov=fix["fov"],
                           max_bounces=fix["max_bounces"], global_lights=gl,
                           point_lights=pl, variant="rl")
    else:
        scene, _, _, _ = library.custom_scene(device="cpu")
        env = RayTracerEnv(scene, image_width=fix["width"],
                           image_height=fix["height"],
                           camera_position=(0, 0, 1), fov=fix["fov"],
                           max_bounces=fix["max_bounces"],
                           background=(2, 2, 5), variant="fb", sun_id=7)
    state, obs = env.reset(1, pixel=fix["pixel"])
    np.testing.assert_allclose(obs[0].numpy(), fix["obs"][0], atol=2e-4)
    for i, action in enumerate(fix["actions"]):
        state, obs, r, term, _ = env.step(state, [action])
        np.testing.assert_allclose(float(r[0]), fix["rewards"][i],
                                   atol=2e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(obs[0].numpy(), fix["obs"][i + 1],
                                   atol=2e-3, err_msg=f"step {i}")
        assert bool(term[0]) == fix["terminated"][i], f"step {i}"
        if fix["terminated"][i]:
            break


def test_fb_sun_hit_pays_ten():
    """An action aimed at the sun pays +10 and ends the episode."""
    scene, _, _, _ = library.custom_scene(device="cpu")
    env = RayTracerEnv(scene, image_width=100, image_height=100,
                       camera_position=(0, 0, 1), fov=60, max_bounces=8,
                       background=(2, 2, 5), variant="fb", sun_id=7)
    state, _ = env.reset(1, pixel=(50, 40))
    assert bool(state.hit[0])
    to_sun = torch.tensor([-0.6, 0.2, 6.0]) - state.point
    action = sampling.direction_to_action(
        to_sun / to_sun.norm(dim=-1, keepdim=True), state.normal, "env")
    state, _, r, term, _ = env.step(state, action)
    assert float(r[0]) == 10.0 and bool(term[0])


@pytest.mark.parametrize("name, args", [
    ("training_scene_v1", ()), ("training_scene_optimized", ()),
    ("training_scene_complete", ()), ("dynamic_scene", (1,)),
    ("dynamic_scene", (2,)), ("dynamic_scene", (3,))])
def test_scenes_match_jax(name, args):
    js, jgl, jpl = getattr(jax_scenes, name)(*args)
    ts, tgl, tpl = getattr(scenes, name)(*args, device="cpu")
    for j, t in ((js, ts), (jgl, tgl), (jpl, tpl)):
        for k, v in jax_scene_numpy(j).items():
            np.testing.assert_array_equal(getattr(t, k).numpy(), v,
                                          err_msg=k)


def test_env_camera_matches_jax():
    """``perspective_rays(variant="env")`` equals JAX's with 64-bit mode
    off; with a camera angle, within float32 rounding (the rotation's
    sines are float64 rounded once in the port, XLA's float32 in JAX)."""
    with jax.enable_x64(False):
        jo, jd = jax_perspective(40, 30, fov=75, origin=(0, 1, 2),
                                 variant="env")
        _, jr = jax_perspective(40, 30, fov=75, variant="env",
                                camera_angle=(0.1, -0.2, 0.3))
    o, d = perspective_rays(40, 30, fov=75, origin=(0, 1, 2), variant="env",
                            device="cpu")
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _, r = perspective_rays(40, 30, fov=75, variant="env",
                            camera_angle=(0.1, -0.2, 0.3), device="cpu")
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=3e-7)
    m = vec.euler_rotation_matrix(0.1, -0.2, 0.3)
    np.testing.assert_allclose(m, np.asarray(jax_vec.euler_rotation_matrix(
        0.1, -0.2, 0.3)), atol=1e-15)
    with pytest.raises(ValueError, match="variant"):
        perspective_rays(4, 3, variant="x", device="cpu")


def test_gym_adapter_api():
    pytest.importorskip("gymnasium")
    from raytracer_tpu_torch.env.gym_adapter import GymRayTracerEnv
    _, env = make_envs("rl")
    g = GymRayTracerEnv(env)
    obs, info = g.reset(seed=0)
    assert obs.shape == (OBS_DIM,) and len(info["pixel"]) == 2
    obs2, _ = g.reset(seed=0)
    np.testing.assert_array_equal(obs, obs2)
    obs, _ = g.reset(options={"pixel": (32, 20)})
    total = 0.0
    for _ in range(10):
        obs, r, term, trunc, info = g.step(g.action_space.sample())
        total += r
        if term or trunc:
            break
    assert isinstance(total, float) and "bounce_count" in info
