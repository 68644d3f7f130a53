"""The port's output5 experiment (raytracer_tpu_torch/trace/output5_style.py,
compare/heuristic_fb.py, compare/experiment.py, compare/simplified_fb.py)
held against the JAX package's on JAX's planes.

* ``trace_output5``, all three methods, 21x21 grid, 4 bounces, float32:
  image and stats equal to JAX run op by op (``jax.disable_jit``; each
  level's ``k1, k2, k3 = split(keys[l], 3)``).  Against JAX's jitted
  tracer (XLA turns ``/ 255`` and ``mean``'s ``/ 3`` into multiplies by
  reciprocals, which can move a ``trunc``): stats equal, every channel
  within one unit, at most 2% of rays off.
* ``output5_traditional_25_mb1``: the executed reference's 25x25 grid at
  one bounce, float64, equal (``tests/test_output5_golden.py``'s check).
* ``EnhancedFBAgent``: the same calls give the same actions, strategies
  and memory as JAX's.
* ``SimplifiedFBRenderer.trace`` on JAX's planes: equal to JAX's without a
  model (fb_prob 0); with a narrow seeded agent loaded in both from the
  port's checkpoint, fb_prob 1, at least 99% of rays equal and the guided
  bounce counts equal (the networks' f32 sums run in other orders).
* ``CustomSceneExperiment`` at a 25x25 grid: the four frames, the trials,
  the results JSON and the grid PNG.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.compare.heuristic_fb import EnhancedFBAgent as JaxHeuristic
from raytracer_tpu.compare.simplified_fb import \
    SimplifiedFBRenderer as JaxSimplified
from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.render.camera import grid_rays as jax_grid_rays
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace.output5_style import trace_output5 as jax_trace
from raytracer_tpu_torch.compare.experiment import CustomSceneExperiment
from raytracer_tpu_torch.compare.heuristic_fb import EnhancedFBAgent
from raytracer_tpu_torch.compare.simplified_fb import SimplifiedFBRenderer
from raytracer_tpu_torch.fb.agent import FBResearchAgent
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.render.camera import grid_rays
from raytracer_tpu_torch.scene.types import scene_astype
from raytracer_tpu_torch.trace.output5_style import METHODS, trace_output5

from test_torch_fb_networks import NARROW
from test_torch_scene import one_torch_thread, port_scene  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


GOLDEN = Path(__file__).parent / "golden" / "output5_traditional_25_mb1.npy"


def output5_planes(key, max_bounces, n, method, dtype=jnp.float32):
    """JAX ``trace_output5``'s draws: ``uniforms`` from each level's k1
    (``[R, 2]`` traditional, ``[R, 3]`` rl and fb) and ``glass_uniforms``
    from its k2."""
    us, gs = [], []
    for k in jax.random.split(key, max_bounces):
        k1, k2, _ = jax.random.split(k, 3)
        width = 2 if method == "traditional" else 3
        us.append(np.asarray(jax.random.uniform(k1, (n, width), dtype)))
        gs.append(np.asarray(jax.random.uniform(k2, (n,), dtype)))
    return torch.from_numpy(np.stack(us)), torch.from_numpy(np.stack(gs))


def run_both(method, key, max_bounces, ray_count=10, step=0.05, jit=False):
    js = jax_library.custom_scene()[0]
    with jax.enable_x64(False):
        o, d, h, w = jax_grid_rays(ray_count, step, 1, origin=(0, 0, 1))
        if jit:
            rj, sj = jax_trace(js, o, d, key, max_bounces=max_bounces,
                               method=method)
        else:
            with jax.disable_jit():
                rj, sj = jax_trace(js, o, d, key, max_bounces=max_bounces,
                                   method=method)
        rj, sj = np.asarray(rj), {k: float(v) for k, v in sj.items()}
        u, g = output5_planes(key, max_bounces, o.shape[0], method)
    rt, st = trace_output5(port_scene(js), torch.from_numpy(np.array(o)),
                           torch.from_numpy(np.array(d)),
                           max_bounces=max_bounces, method=method,
                           uniforms=u, glass_uniforms=g)
    return rj, sj, rt.numpy(), {k: float(v) for k, v in st.items()}


@pytest.mark.parametrize("method", METHODS)
def test_trace_output5_equals_jax_op_by_op(method):
    rj, sj, rt, st = run_both(method, jax.random.key(3), 4)
    np.testing.assert_array_equal(rt, rj)
    assert st == sj and st["steps"] > 0
    assert rt.min() >= 0 and rt.max() <= 255


@pytest.mark.parametrize("method", METHODS)
def test_trace_output5_within_bounds_of_jitted_jax(method):
    rj, sj, rt, st = run_both(method, jax.random.key(5), 4, jit=True)
    assert st == sj
    off = (rt != rj).any(-1)
    assert np.abs(rt - rj).max() <= 1.0
    assert off.mean() <= 0.02, off.mean()


def test_output5_traditional_golden():
    """tests/test_output5_golden.py's fixture: the executed reference at
    max_bounces=1, float64 (the plain sweep; the kernel is float32)."""
    ts = scene_astype(port_scene(jax_library.custom_scene()[0]),
                      torch.float64)
    o, d, h, w = grid_rays(12, 1.0 / 12, 1, origin=(0, 0, 1),
                           dtype=torch.float64, device="cpu")
    u, g = output5_planes(jax.random.key(0), 1, o.shape[0], "traditional",
                          jnp.float64)
    rgb, _ = trace_output5(ts, o, d, max_bounces=1, method="traditional",
                           uniforms=u, glass_uniforms=g, impl="plain")
    assert rgb.dtype == torch.float64
    with pytest.raises(TypeError, match="float32"):
        trace_output5(ts, o, d, max_bounces=1, method="traditional",
                      uniforms=u, glass_uniforms=g)
    np.testing.assert_array_equal(rgb.numpy().reshape(h, w, 3),
                                  np.load(GOLDEN))


def test_trace_output5_generator_and_checks():
    ts = jax_library.custom_scene()[0]
    ts = port_scene(ts)
    o, d, _, _ = grid_rays(4, 0.1, 1, origin=(0, 0, 1), device="cpu")
    a = trace_output5(ts, o, d, max_bounces=3, method="fb",
                      generator=torch.Generator().manual_seed(2))
    b = trace_output5(ts, o, d, max_bounces=3, method="fb",
                      generator=torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="method"):
        trace_output5(ts, o, d, method="pt")
    with pytest.raises(ValueError, match="generator"):
        trace_output5(ts, o, d, method="rl")
    with pytest.raises(ValueError, match="glass_uniforms"):
        trace_output5(ts, o, d, max_bounces=2, method="traditional",
                      uniforms=torch.rand((2, o.shape[0], 2)))


def test_enhanced_fb_agent_equals_jax():
    """The same calls on both: actions, strategies, memory and the
    exploration rate's decay (tests/test_compare.py's sequence)."""
    agents = (EnhancedFBAgent(seed=0), JaxHeuristic(seed=0))
    obs = np.zeros(21, np.float32)
    out = [[], []]
    for i, agent in enumerate(agents):
        out[i].append(agent.choose_direction())
        for k in range(8):
            agent.record_light_hit(obs + k, np.array([0.1 * k, 0.2, 0.9]))
        out[i] += [agent.choose_direction() for _ in range(50)]
        out[i].append(agent.create_observation(
            (1, 2, 3), (0, 0, 1), (0, 1, 0), (0.5, 0, 0, 1.5), 7, 2,
            (10, 20, 30), 1))
        agent.reset_for_new_rendering()
    for (a, ia), (b, ib) in zip(out[0][:-1], out[1][:-1]):
        np.testing.assert_array_equal(a, b)
        assert ia == ib
    np.testing.assert_array_equal(out[0][-1], out[1][-1])
    assert agents[0].exploration_rate == agents[1].exploration_rate < 0.3
    assert agents[0].light_directions == agents[1].light_directions
    assert "memory_guided" in {i["strategy"] for _, i in out[0][1:-1]}


def simplified_planes(key, max_bounces, n):
    """JAX ``SimplifiedFBRenderer.trace``'s draws: each bounce's ``key, k1,
    k2, k3 = split(key, 4)``: glass (k1), cosine (k2), fb gate (k3)."""
    g, u, f = [], [], []
    for _ in range(max_bounces):
        key, k1, k2, k3 = jax.random.split(key, 4)
        g.append(np.asarray(jax.random.uniform(k1, (n,), jnp.float32)))
        u.append(np.asarray(jax.random.uniform(k2, (n, 2), jnp.float32)))
        f.append(np.asarray(jax.random.uniform(k3, (n,), jnp.float32)))
    return [torch.from_numpy(np.stack(x)) for x in (g, u, f)]


@pytest.mark.parametrize("with_agent", [False, True])
def test_simplified_fb_renderer_matches_jax(tmp_path, with_agent):
    js, _, _, p = jax_library.custom_scene()
    sun_idx = int(np.nonzero(np.asarray(js.id) == 7)[0][0])
    cfg = dict(NARROW, max_bounces=4)
    model = None
    if with_agent:
        model = str(tmp_path / "narrow.npz")
        FBResearchAgent(FBConfig(**cfg), seed=4, device="cpu").save(model)
    key = jax.random.key(6)
    L = 3
    with jax.enable_x64(False):
        o, d, _, _ = jax_grid_rays(10, 0.05, 1, origin=(0, 0, 1))
        jr = JaxSimplified(js, sun_idx, model_path=model,
                           config=JaxConfig(**cfg))
        want = np.asarray(jr.trace(o, d, key, max_bounces=L,
                                   fb_prob=1.0 if with_agent else 0.0))
        g, u, f = simplified_planes(key, L, o.shape[0])
    tr = SimplifiedFBRenderer(port_scene(js), sun_idx, model_path=model,
                              config=FBConfig(**cfg), device="cpu")
    got = tr.trace(torch.from_numpy(np.array(o)),
                   torch.from_numpy(np.array(d)), max_bounces=L,
                   fb_prob=1.0 if with_agent else 0.0, glass_uniforms=g,
                   uniforms=u, fb_uniforms=f).numpy()
    assert tr.stats["fb_used"] == jr.stats["fb_used"]
    if with_agent:
        assert tr.stats["fb_used"] > 0
        assert (got == want).all(-1).mean() >= 0.99
    else:
        np.testing.assert_array_equal(got, want)
        img = tr.render_original_style(width=12, height=10, max_bounces=3,
                                       camera_position=p["camera_position"])
        assert img.shape == (10, 12, 3) and np.isfinite(img).all()
        assert tr.stats["rays_per_second"] > 0


def test_custom_scene_experiment_small(tmp_path):
    """tests/test_compare.py's small experiment, on the CPU: the grid cut
    to 25x25, all four frames, the trials (3 a method), the results JSON,
    the summary and the grid PNG."""
    from PIL import Image
    exp = CustomSceneExperiment(output_dir=tmp_path, mode="fast_mode",
                                device="cpu")
    exp._grid = lambda: grid_rays(12, 1.0 / 12, 1, origin=(0, 0, 1),
                                  device="cpu")
    images, times, stats = exp.render_unified_comparison()
    assert set(images) == {"true_original", "traditional", "fb", "rl"}
    for img in images.values():
        assert img.shape == (25, 25, 3) and np.isfinite(img).all()
    assert set(stats) == {"traditional", "fb", "rl"}
    png = np.asarray(Image.open(exp.output_dir / "unified_comparison.png"))
    assert png.shape == (50, 50, 3)
    trials = exp.run_performance_trials(num_trials=3)
    assert set(trials) == {"traditional", "fb", "rl"}
    out = exp.save_custom_results()
    saved = json.loads(out.read_text())
    assert saved["config"]["mode"] == "fast_mode"
    assert set(saved["results"]) == {"render_times", "method_stats",
                                     "trials"}
    assert (exp.output_dir / "custom_scene_summary.txt").exists()
    img = exp.render_custom_scene("fb", width=16, height=12, spp=2)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
