"""Port students (raytracer_tpu_torch/fb/distill.py, fb/registry.py) held
against the JAX package's flax students on the shipped checkpoints.

* f32 (``dtype=None``): equal to flax within rtol 1e-5 / atol 1e-6
  (matmul summation order; measured max |diff| 9.5e-7 on the all-around
  student);
* bf16 (``dtype="auto"``): at least 99.9% of outputs equal (measured
  99.9992% and 99.993% on 65,536 observations); the port follows the order
  XLA gives flax's Dense chain, which a single rounding per layer does not;
* the weight carry-over into ``nn.Linear`` (transposed kernels);
* the registry's table and choices, and the shipped copies byte-equal to
  ``models/``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb import registry as jax_registry
from raytracer_tpu.fb.distill import DistilledGuide as JaxGuide
from raytracer_tpu_torch.fb import registry
from raytracer_tpu_torch.fb.distill import (DistilledGuide, StudentGuide,
                                            StudentPolicy,
                                            state_dict_from_params)

ROOT = Path(__file__).resolve().parents[1]
STUDENTS = ("fb_chandelier_distilled.npz", "fb_chandelier_distilled_2to1.npz")


def _obs(n=65536, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 22) * 8 - 4).astype(np.float32)


@pytest.mark.parametrize("name", STUDENTS)
def test_shipped_copies_are_byte_equal(name):
    copy = (registry.STUDENTS_DIR / name).read_bytes()
    assert copy == (ROOT / "models" / name).read_bytes()
    assert len(copy) == 80956


@pytest.mark.parametrize("name", STUDENTS)
def test_student_f32_matches_flax(name):
    obs = _obs(4096)
    want = np.asarray(JaxGuide.load(ROOT / "models" / name)
                      .as_guide_fn(dtype=None)(jnp.asarray(obs)))
    got = DistilledGuide.load(registry.STUDENTS_DIR / name).as_guide_fn(
        dtype=None)(torch.from_numpy(obs)).numpy()
    assert got.dtype == np.float32 and got.shape == (4096, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", STUDENTS)
def test_student_bf16_matches_flax(name):
    obs = _obs()
    want = np.asarray(JaxGuide.load(ROOT / "models" / name).as_guide_fn()(
        jnp.asarray(obs)))
    guide = DistilledGuide.load(registry.STUDENTS_DIR / name).as_guide_fn()
    assert guide.dtype == "bfloat16" and guide.hidden == (128, 128)
    got = guide(torch.from_numpy(obs)).numpy()
    assert (got == want).mean() >= 0.999, (got == want).mean()


def test_bias_rounding_order_is_flax():
    """XLA rounds a bf16 Dense's f32-accumulated product to bf16 and adds
    the bias in bf16 (a second rounding); one rounding after an f32 bias
    add, as the TPU kernel's _student_mlp does, is another function."""
    z = np.load(ROOT / "models" / STUDENTS[0])
    k, b = z["Dense_0/kernel"], z["Dense_0/bias"]
    x = _obs(4096)
    kb, bb, xb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, b, x))
    want = np.asarray(jax.jit(lambda x, k, b: x @ k + b)(xb, kb, bb)
                      .astype(jnp.float32))
    layer = StudentGuide([(k, b)], "bfloat16").layers[0]
    xt = torch.from_numpy(x).bfloat16().float()
    prod = torch.matmul(xt, layer[0])
    flax_order = (prod.bfloat16() + layer[1].bfloat16()).float().numpy()
    one_rounding = (prod + layer[1]).bfloat16().float().numpy()
    assert (flax_order == want).mean() >= 0.999
    assert (one_rounding == want).mean() < 0.95


def test_weight_carry_over_into_linear():
    """Nested JAX params and the flat npz keys give the same state dict,
    with each flax kernel [in, out] transposed into nn.Linear's [out, in];
    the module then computes the f32 guide."""
    z = dict(np.load(ROOT / "models" / STUDENTS[0]))
    nested = JaxGuide.load(ROOT / "models" / STUDENTS[0]).params
    a = state_dict_from_params(z)
    b = state_dict_from_params(jax.tree_util.tree_map(np.asarray, nested))
    assert a.keys() == b.keys() == {f"layers.{i}.{w}" for i in range(3)
                                    for w in ("weight", "bias")}
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert torch.equal(a["layers.0.weight"],
                       torch.from_numpy(z["Dense_0/kernel"]).T)
    module = StudentPolicy((128, 128))
    module.load_state_dict(a)
    obs = torch.from_numpy(_obs(512))
    guide = DistilledGuide(z, (128, 128))
    with torch.no_grad():
        np.testing.assert_allclose(module(obs).numpy(),
                                   guide.as_guide_fn(None)(obs).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(guide.module()(obs), module(obs))


def test_load_checks_hidden_widths():
    z = dict(np.load(ROOT / "models" / STUDENTS[0]))
    with pytest.raises(ValueError, match="hidden"):
        DistilledGuide(z, (64, 64))


def test_registry_table_and_choices():
    assert registry.REGISTRY == jax_registry.REGISTRY
    for w, h in ((200, 100), (800, 600), (640, 480), (1000, 500)):
        assert registry.aspect_band(w, h) == jax_registry.aspect_band(w, h)
    d = registry.STUDENTS_DIR
    assert Path(registry.model_path_for("chandelier", 200, 100, d)).name == \
        "fb_chandelier_distilled_2to1.npz"
    assert Path(registry.model_path_for("chandelier", 800, 600, d)).name == \
        "fb_chandelier_distilled.npz"
    assert Path(registry.model_path_for("complex", 800, 600, d)).name == \
        "fb_complex_distilled.npz"
    assert registry.model_path_for("cornell_box", 800, 600, d) is None
    assert registry.model_path_for("nowhere", 800, 600, d) is None
    assert registry.guide_for("nowhere", 800, 600, d) is None
    g = registry.guide_for("chandelier", 800, 600, d)
    assert g.dtype == "bfloat16"
    assert registry.guide_for("chandelier", 800, 600, d,
                              dtype=None).dtype is None
    assert Path(registry.model_path_for("cornell_box:1007", 800, 600,
                                        ROOT / "models")).name == \
        "fb_cornell_distilled.npz"
