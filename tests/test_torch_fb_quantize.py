"""The full agent's bf16 and int8 guides in the port
(raytracer_tpu_torch/fb/inference.py, fb/quantize.py) held against
raytracer_tpu's on the same narrow checkpoint (tests/test_torch_fb_agent.py:
z 8, encoder 32, backward 16, ``narrow_params(seed=4)``, chandelier, agent
seed 3) and the same observations (JAX's tests/test_quantize.py draw).

* ``quantize_kernel`` bit for bit JAX's (numpy ``rint``), zero columns too;
  ``quantize_agent_params`` the same int8 kernels, scales, biases,
  LayerNorm parameters and prototype, bit for bit.
* The int8 apply on those weights against JAX's ``Int8AgentApply``: the
  int8 × int8 products are exact integers in both, so a row differs by more
  than float rounding (1e-5) only where an activation rounded to the next
  int8 level after a 1-ulp difference upstream (``rsqrt``, the rescale).
  Bound: at most ``INT8_ROWS_OFF`` of rows (measured 3 of 4,096), none by
  more than ``INT8_MAX`` (measured 0.016).
* Each of the 17 quantized layers' int32 product equals the exact integer
  product (the card's ``torch._int_mm`` route is held to it in
  ``chip_smoke.py`` phase ``fb_guide_dtypes``).
* The bf16 guide against flax's bf16 run.  Op by op (``jax.disable_jit``,
  one bf16 rounding an operation, as the port): at most one bf16 ulp of
  0.95 (2^-8) on at most 0.1% of values (measured 0.037%).  Jitted, XLA
  keeps f32 between fused bf16 operations (``xla_allow_excess_precision``),
  so the bound is the looser ``BF16_JIT`` (measured max 0.155, mean 0.0055).
* Both dtypes against the f32 guide within JAX's own int8 bounds
  (tests/test_quantize.py:38-50: max < 0.15, mean < 0.03).
* Both run as guides through ``render_path`` stepwise and hybrid, the two
  routes bit for bit; an unknown dtype raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb import quantize as jax_quantize
from raytracer_tpu_torch.fb import quantize
from raytracer_tpu_torch.render.path_renderer import render_path

from test_torch_fb_agent import agents  # noqa: F401  (fixture)
from test_torch_fb_networks import NARROW

INT8_ROWS_OFF = 0.0025
INT8_MAX = 0.05
BF16_ULP = 2.0 ** -8
BF16_EAGER_SHARE = 1e-3
BF16_JIT = dict(max=0.25, mean=0.01)
JAX_INT8 = dict(max=0.15, mean=0.03)


def _obs(n=4096, seed=1):
    rng = np.random.default_rng(seed)
    obs = rng.normal(scale=0.5, size=(n, 22)).astype(np.float32)
    obs[:, :3] = rng.uniform(-10, 10, (n, 3))
    return obs


def _tree_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _tree_equal(want[k], got[k], f"{path}/{k}")
        return
    w, g = np.asarray(want), np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


def test_quantize_kernel_bit_equal():
    rng = np.random.default_rng(0)
    for shape in ((64, 32), (22, 512), (512, 2)):
        k = rng.normal(size=shape).astype(np.float32)
        k[:, 0] = 0.0                                  # a zero column
        want = jax_quantize.quantize_kernel(k)
        got = quantize.quantize_kernel(k)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (got[1][0] == 1.0) and (got[0][:, 0] == 0).all()


def test_quantize_agent_params_bit_equal(agents):  # noqa: F811
    ja, ta = agents
    want = jax_quantize.quantize_agent_params(ja.params, ja.light_prototype)
    got = quantize.quantize_agent_params(ta.encoder, ta.backward,
                                         ja.light_prototype)
    _tree_equal(want, got)


def test_int8_apply_matches_jax(agents):  # noqa: F811
    ja, ta = agents
    qp = jax_quantize.quantize_agent_params(ja.params, ja.light_prototype)
    obs = _obs()
    want = np.asarray(jax_quantize.Int8AgentApply(z_dim=NARROW["z_dim"])(
        qp, jnp.asarray(obs)))
    got = quantize.Int8AgentApply(
        quantize.quantize_agent_params(ta.encoder, ta.backward,
                                       ja.light_prototype),
        NARROW["z_dim"], "cpu")(torch.from_numpy(obs))
    assert got.dtype == torch.float32 and got.shape == (4096, 2)
    d = np.abs(got.numpy() - want).max(axis=1)
    assert (d > 1e-5).mean() <= INT8_ROWS_OFF, (d > 1e-5).sum()
    assert d.max() <= INT8_MAX, d.max()


def test_int8_layers_exact_integer_products(agents):  # noqa: F811
    """Each of the guide's 17 quantized layers: its int32 product equals
    the exact integer product (int64 numpy) on random int8 activations."""
    _, ta = agents
    guide = ta.as_guide_fn("int8")
    layers = guide.layers()
    assert len(layers) == 17
    rng = np.random.default_rng(3)
    for layer in layers:
        qx = rng.integers(-127, 128, (37, layer.k_in), dtype=np.int8)
        want = qx.astype(np.int64) @ layer.qkernel.numpy().astype(np.int64)
        got = layer.int_product(torch.from_numpy(qx))
        assert got.dtype == torch.int32 and got.shape == (37, layer.n_out)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_guide_matches_flax(agents):  # noqa: F811
    ja, ta = agents
    obs = _obs()
    got = ta.as_guide_fn(torch.bfloat16)(torch.from_numpy(obs))
    assert got.dtype == torch.float32 and got.shape == (4096, 2)
    got = got.numpy()
    with jax.disable_jit():
        eager = np.asarray(ja.as_guide_fn(dtype=jnp.bfloat16)(
            jnp.asarray(obs)))
    d = np.abs(got - eager)
    assert d.max() <= BF16_ULP and (d > 0).mean() <= BF16_EAGER_SHARE, (
        d.max(), (d > 0).mean())
    jit = np.abs(got - np.asarray(ja.as_guide_fn(dtype=jnp.bfloat16)(
        jnp.asarray(obs))))
    assert jit.max() < BF16_JIT["max"] and jit.mean() < BF16_JIT["mean"]


def test_dtypes_near_f32_within_jax_int8_bounds(agents):  # noqa: F811
    _, ta = agents
    obs = torch.from_numpy(_obs())
    ref = ta.as_guide_fn()(obs).numpy()
    for dtype in ("int8", torch.bfloat16):
        d = np.abs(ta.as_guide_fn(dtype)(obs).numpy() - ref)
        assert d.max() < JAX_INT8["max"] and d.mean() < JAX_INT8["mean"], (
            dtype, d.max(), d.mean())


@pytest.mark.parametrize("dtype", ["int8", torch.bfloat16])
def test_dtype_guides_render_stepwise_and_hybrid(agents, dtype):  # noqa: F811
    _, ta = agents
    from raytracer_tpu_torch.scene.library import chandelier_scene
    scene, _, _, p = chandelier_scene(device="cpu")
    guide = ta.as_guide_fn(dtype)
    out = {}
    for impl in ("stepwise", "hybrid"):
        img, st = render_path(
            scene, width=16, height=8, spp=1, max_bounces=3,
            camera_position=p["camera_position"], mirror_threshold=0.9,
            guide_fn=guide, fb_prob=1.0, impl=impl, device="cpu",
            generator=torch.Generator().manual_seed(4))
        assert torch.isfinite(img).all() and st.as_dict()["fb_used"] > 0
        out[impl] = (img, st.as_dict())
    assert torch.equal(out["stepwise"][0], out["hybrid"][0])
    assert out["stepwise"][1] == out["hybrid"][1]


def test_unknown_dtype_raises(agents):  # noqa: F811
    _, ta = agents
    for bad in (torch.float16, "int4", torch.int8):
        with pytest.raises(ValueError, match="guide dtype"):
            ta.as_guide_fn(bad)
