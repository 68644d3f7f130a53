"""Port hybrid tracer (trace_path(impl="hybrid"): one
``core/cuda_level.py::path_level`` a level, the guide between levels, the
fold on tensors) held against the port's whole-trace version and the JAX
package's level-split hybrid.

* the plain hybrid equals the plain whole-trace version bit for bit,
  guided (shipped bf16 student, a random f32 student) and unguided;
* it equals JAX ``impl="hybrid"`` (its Pallas level kernel in interpret
  mode, as tests/test_pallas_path.py:184 runs it) with the one-hot student
  and unguided, images and all six counts;
* ``path_level_plain`` agrees with one level of JAX ``run_level_kernel``
  on the same inputs: states, albedo, direct light and material columns
  exactly; hit points and offset origins within 5e-5, normals and
  directions within 1e-5.  The Pallas kernel in interpret mode is compiled
  by XLA, whose CPU arithmetic is not the written order: measured on these
  inputs, 51% of the continuing lanes' hit points differ from the written
  float32 order (which numpy and the port follow), by up to 2.0e-5 where
  t = tca − √(r² − d²) cancels on the radius-100 ground sphere, and
  normals and directions by up to 3.6e-6 (ROADMAP queue 3, known gaps).
  Its cosine candidates also use cosθ = √u₀, sinθ = √(1−u₀) without acos.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core.pallas_path import run_level_kernel
from raytracer_tpu.trace.path import emissive_indices as jax_emissive
from raytracer_tpu.trace.path import scene_spec as jax_scene_spec
from raytracer_tpu_torch.core import cuda_level, cuda_path
from raytracer_tpu_torch.fb.distill import DistilledGuide
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.trace.path import (emissive_indices, scene_spec,
                                            trace_path)

from test_path import _lean_scene
from test_torch_guided import guides, one_hot_params, run_both
from test_torch_path import _rays
from test_torch_scene import port_scene


def _random_student():
    rng = np.random.RandomState(3)
    dims = (22, 32, 16, 2)
    return DistilledGuide({f"Dense_{i}": {
        "kernel": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
        "bias": (rng.randn(b) * 0.1).astype(np.float32)}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}, dims[1:-1])


@pytest.mark.parametrize("case", ["shipped_bf16", "random_f32", "unguided"])
def test_plain_hybrid_equals_plain_whole_trace(case):
    scene, _, _, _ = library.chandelier_scene(device="cpu")
    o, d = (torch.from_numpy(a) for a in _rays(2000, seed=11))
    g = torch.Generator().manual_seed(6)
    u = torch.rand((6, 2000, 2), generator=g)
    f = torch.rand((6, 2000), generator=g)
    guide = None
    if case == "shipped_bf16":
        guide = DistilledGuide.load(
            STUDENTS_DIR / "fb_chandelier_distilled.npz").as_guide_fn()
    elif case == "random_f32":
        guide = _random_student().as_guide_fn(dtype=None)
    kw = dict(max_bounces=6, mirror_threshold=0.9, uniforms=u,
              fb_uniforms=f, guide_fn=guide, fb_prob=0.8)
    a, sa = trace_path(scene, o, d, impl="plain", **kw)
    b, sb = trace_path(scene, o, d, impl="hybrid", **kw)
    assert torch.equal(a, b)
    assert sa.as_dict() == sb.as_dict()
    assert (sa.as_dict()["fb_used"] > 0) == (guide is not None)


@pytest.mark.parametrize("guided", [True, False])
def test_hybrid_equals_jax_hybrid(guided):
    o, d = _rays(2600, seed=1)
    jg, tg = guides(one_hot_params(), (4,), None) if guided else (None, None)
    kw = dict(max_bounces=4, mirror_threshold=0.9)
    if guided:
        kw["fb_prob"] = 1.0
    rj, sj, rt, st = run_both(_lean_scene(), o, d, jax.random.key(5),
                              "hybrid", jg, tg, port_impl="hybrid", **kw)
    np.testing.assert_array_equal(rt, rj)
    assert st == sj
    assert (st["fb_used"] > 0) == guided


def test_path_level_plain_matches_jax_level_kernel():
    js = _lean_scene()
    n = 3000
    rng = np.random.RandomState(12)
    o = (rng.randn(n, 3) * 0.5 + [0.0, 1.0, 2.0]).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    running = rng.rand(n) < 0.8
    u = rng.rand(n, 2).astype(np.float32)
    want = run_level_kernel(
        *(jnp.asarray(o[:, c]) for c in range(3)),
        *(jnp.asarray(d[:, c]) for c in range(3)), jnp.asarray(running),
        jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]), spec=jax_scene_spec(js),
        emissive_idx=jax_emissive(js), mirror_threshold=0.9, fast=False,
        interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    ts = port_scene(js)
    table = cuda_path.path_table(scene_spec(ts), emissive_indices(ts), 0.9,
                                 "cpu")
    got = cuda_level.path_level_plain(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(running),
        torch.from_numpy(u), table, want_hit=True)
    st = got.state.numpy()
    bit = lambda b: (st & b) != 0                               # noqa: E731
    for name, b in (("emis", cuda_level.ST_EMISSIVE),
                    ("cont", cuda_level.ST_CONT),
                    ("miss", None), ("found", cuda_level.ST_FOUND),
                    ("mirror", cuda_level.ST_MIRROR)):
        mine = (bit(cuda_level.ST_RUNNING) & ~bit(cuda_level.ST_EMISSIVE)
                & ~bit(cuda_level.ST_CONT)) if b is None else bit(b)
        np.testing.assert_array_equal(mine, want[name] > 0.5, err_msg=name)
    found = bit(cuda_level.ST_FOUND)
    np.testing.assert_array_equal(bit(cuda_level.ST_SMALL),
                                  found & (want["small"] > 0.5))
    np.testing.assert_array_equal(bit(cuda_level.ST_RUNNING), running)
    cont = bit(cuda_level.ST_CONT)
    mirror = bit(cuda_level.ST_MIRROR)
    rec = got.rec.numpy()
    for c, k in enumerate(("ar", "ag", "ab")):
        np.testing.assert_array_equal(rec[found, c], want[k][found])
    for c, k in enumerate(("dr", "dg", "db")):
        np.testing.assert_array_equal(rec[cont, 3 + c], want[k][cont])
    on, dn, hit = got.o_next.numpy(), got.d_next.numpy(), got.hit.numpy()
    for c, ax in enumerate("xyz"):
        np.testing.assert_allclose(on[cont, c], want["no" + ax][cont],
                                   rtol=0, atol=5e-5)
        np.testing.assert_array_equal(on[~cont, c], o[~cont, c])
        np.testing.assert_allclose(dn[mirror, c], want["rl" + ax][mirror],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(dn[~cont, c], d[~cont, c])
        diffuse = cont & ~mirror
        np.testing.assert_allclose(dn[diffuse, c], want["cf" + ax][diffuse],
                                   rtol=0, atol=1e-5)
    for c, k in enumerate(("px", "py", "pz", "nx", "ny", "nz")):
        np.testing.assert_allclose(hit[cont, c], want[k][cont],
                                   rtol=0, atol=5e-5 if c < 3 else 1e-5,
                                   err_msg=k)
    for c, k in enumerate(("refl", "transp", "emitf", "ior", "sid"), 6):
        np.testing.assert_array_equal(hit[cont, c], want[k][cont],
                                      err_msg=k)
    assert (hit[~cont] == 0).all()
    assert cont.sum() > 0 and mirror.sum() > 0 and (cont & ~mirror).sum() > 0
