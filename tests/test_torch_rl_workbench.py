"""The port's workbench and RL renderer (raytracer_tpu_torch/compare/
workbench.py, rl_renderer.py) held against the JAX package's on the CPU,
on JAX's draws.  JAX's env runs jitted here, where XLA multiplies by the
reciprocal of 765 in the reward: rewards within 1e-6, every count equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.compare import rl_renderer as jax_rl
from raytracer_tpu.compare import workbench as jax_wb
from raytracer_tpu_torch.compare import rl_renderer, workbench

from test_torch_rl_env import jax_actions, make_envs, xla_trig  # noqa: F401
from test_torch_scene import jax_scene_numpy, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

E = 128


def jax_eval_draws(variant, seed, w, h, steps):
    """JAX ``evaluate_policy``'s reset pixels and random actions."""
    key = jax.random.key(seed)
    key, kr = jax.random.split(key)
    kx, ky = jax.random.split(kr)
    pix = np.stack([jax.random.randint(kx, (E,), 0, w),
                    jax.random.randint(ky, (E,), 0, h)], -1)
    acts = []
    for _ in range(steps):
        key, ka = jax.random.split(key)
        acts.append(np.asarray(jax_actions(variant, ka, E)))
    return pix, torch.from_numpy(np.stack(acts)) if acts else None


def assert_eval_close(got, want):
    for k in ("episodes", "avg_bounces", "light_hit_rate", "worst_episode"):
        assert got[k] == want[k], k
    for k in ("avg_reward", "std_reward"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["best_episode"]["index"] == want["best_episode"]["index"]
    assert abs(got["best_episode"]["reward"]
               - want["best_episode"]["reward"]) <= 1e-5


@pytest.mark.parametrize("variant", ["rl", "fb"])
def test_evaluate_policy_matches_jax(variant):
    """Random actions and a constant policy on JAX's draws: light hits by
    sphere identity, bounces and best/worst episodes equal, rewards within
    1e-6."""
    with jax.enable_x64(False):
        je, te = make_envs(variant, max_bounces=4)
        want = jax_wb.evaluate_policy(je, None, episodes=E, seed=3)
        pix, acts = jax_eval_draws(variant, 3, 64, 48, 6)
        const = lambda o: np.full((o.shape[0], 2), 0.4, np.float32)  # noqa
        want_c = jax_wb.evaluate_policy(je, const, episodes=E, seed=4)
        pix_c, _ = jax_eval_draws(variant, 4, 64, 48, 0)
    got = workbench.evaluate_policy(te, None, episodes=E, pixel=pix,
                                    actions=acts)
    assert_eval_close(got, want)
    got = workbench.evaluate_policy(
        te, lambda o: torch.full((o.shape[0], 2), 0.4), episodes=E,
        pixel=pix_c)
    assert_eval_close(got, want_c)


def test_compare_rl_vs_random(tmp_path):
    _, te = make_envs("rl", max_bounces=3)
    out = tmp_path / "cmp" / "bench.json"
    res = workbench.compare_rl_vs_random(
        te, lambda o: torch.zeros((o.shape[0], 2)), episodes=32,
        out_path=out)
    assert out.exists() and set(res) == {"rl", "random",
                                         "reward_improvement",
                                         "rays_per_light_hit"}
    assert res["rl"]["episodes"] == res["random"]["episodes"] == 32
    again = workbench.evaluate_policy(te, None, episodes=32, seed=1)
    assert again == res["random"]          # seeded: seed + 1 for random


def test_orthographic_render_matches_jax():
    with jax.enable_x64(False):
        want = jax_wb.orthographic_render(jax_rl.create_test_scene(),
                                          width=64, height=48)
    got = workbench.orthographic_render(
        rl_renderer.create_test_scene("cpu"), width=64, height=48)
    np.testing.assert_array_equal(got, want)


def test_test_scene_matches_jax():
    want = jax_scene_numpy(jax_rl.create_test_scene())
    got = rl_renderer.create_test_scene("cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v)


def jax_uniforms(key, spp, max_bounces, rays):
    """``render_guided``'s uniform draws in JAX's key schedule."""
    out = []
    for _ in range(spp):
        key, _ = jax.random.split(key)
        per = []
        for _ in range(max_bounces):
            key, kd = jax.random.split(key)
            per.append(np.asarray(jax.random.uniform(kd, (rays, 2),
                                                     jnp.float32)))
        out.append(per)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("guide", ["uniform", "policy"])
def test_render_guided_matches_jax(guide, xla_trig):
    """``render_guided`` at 40x30, 3 bounces, 2 spp (uniform) or 1 spp (a
    constant policy), with XLA's sines and cosines in both: the image bit
    for bit."""
    w, h, mb = 40, 30, 3
    spp = 2 if guide == "uniform" else 1
    policy = None
    if guide == "policy":
        def policy(obs):
            return np.tile(np.array([[0.3, 2.0]], np.float32),
                           (obs.shape[0], 1))
    with jax.enable_x64(False):
        want = jax_rl.render_guided(jax_rl.create_test_scene(), policy,
                                    jax.random.key(5), width=w, height=h,
                                    max_bounces=mb, spp=spp)
        u = jax_uniforms(jax.random.key(5), spp, mb, w * h)
    scene = rl_renderer.create_test_scene("cpu")
    got = rl_renderer.render_guided(
        scene, None if policy is None else (lambda o: policy(o.numpy())),
        u if policy is None else None, width=w, height=h, max_bounces=mb,
        spp=spp)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = rl_renderer.render_guided(
        scene, None if policy is None else (lambda o: policy(o.numpy())),
        u if policy is None else None, width=w, height=h, max_bounces=mb,
        spp=spp, impl="plain")
    assert torch.equal(plain, got)


def test_ray_tracer_rl_and_model_discovery(tmp_path, capsys):
    rt = rl_renderer.RayTracerRL(model_path=None, device="cpu")
    assert not rt.use_rl and "not found" in capsys.readouterr().out
    rl_img, trad = rt.render_comparison(width=20, height=15,
                                        out_path=tmp_path / "cmp.png")
    assert rl_img.shape == trad.shape == (15, 20, 3)
    assert (tmp_path / "cmp.png").exists() and rl_img.max() > 0
    from raytracer_tpu_torch.agents import SHIPPED_DIR
    rt = rl_renderer.RayTracerRL(SHIPPED_DIR / "sac_raytracer.npz",
                                 device="cpu")
    assert rt.use_rl
    assert rt.render_single_view(20, 15).shape == (15, 20, 3)
    assert workbench.check_model_exists("nope", tmp_path) is None
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "foo.pkl").write_bytes(b"x")
    assert workbench.check_model_exists("foo", tmp_path) is not None
