"""Port Whitted tracer (raytracer_tpu_torch.trace.whitted,
core.cuda_whitted, core.cuda_intersect) held against the JAX package on
the same numpy-made inputs.

Bounds, and why:

* scene and light tables, vector helpers, the nearest-hit sweep, the
  far-root exit and the refraction walk: exact (the same operations in the
  same order; the port's CPU square root is correctly rounded, as XLA's
  is);
* ``trace_whitted`` against JAX run op by op (``jax.disable_jit``), in
  float32 and float64: every field exact;
* against the jitted JAX tracer: the discrete fields (hit, idx, bounces,
  through) exact.  Its floats are not compared: XLA's fused program
  differs from its own op-by-op run (its ``jnp.sum`` over xyz does not
  always add left to right), and a one-ulp difference grows through deep
  mirror and glass chains (measured at 12x12: up to 1.3e-3 in a marbles4
  normal in float32, 3e-13 in float64 on true_original), while the port
  equals the op-by-op run exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.scene.types as jax_types
from raytracer_tpu.core import intersect as jax_intersect
from raytracer_tpu.core import vec as jax_vec
from raytracer_tpu.render.camera import grid_rays as jax_grid_rays
from raytracer_tpu.render.camera import perspective_rays as jax_perspective
from raytracer_tpu.render.renderer import material_flags as jax_flags
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace import whitted as jax_whitted
from raytracer_tpu_torch.core import cuda_intersect, cuda_whitted, vec
from raytracer_tpu_torch.core.intersect import (NO_SUPPRESS, nearest_hit_c,
                                                single_sphere_exit_c)
from raytracer_tpu_torch.render.renderer import material_flags
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.types import (lights_from_numpy,
                                             lights_to_numpy, scene_astype,
                                             scene_from_numpy,
                                             scene_to_numpy)
from raytracer_tpu_torch.trace import whitted

SCENES = ("true_original", "planets2", "marbles4", "chandelier")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}
DISCRETE = ("hit", "idx", "bounces", "through")
FLOATS = ("t", "point", "normal")


def numpy_fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def jax_case(name, jdt=jnp.float32, grid=12):
    """A JAX library scene cast to ``jdt``, its lights and small camera
    rays: the notebook grid at ``grid`` rays a side over the frame's field
    of view, or a 24x16 perspective frame for the chandelier."""
    js, jgl, jpl, p = getattr(jax_library, name + "_scene")()
    js, jgl, jpl = (jax_types.scene_astype(x, jdt) for x in (js, jgl, jpl))
    if "ray_count" in p:
        o, d, _, _ = jax_grid_rays(grid, p["ray_step"] * p["ray_count"] / grid,
                                   1, origin=p["camera_position"], dtype=jdt)
    else:
        o, d = jax_perspective(24, 16, fov=60, origin=p["camera_position"],
                               variant="fb", dtype=jdt)
    return js, jgl, jpl, p, np.array(o), np.array(d)


def to_port(js, jgl=None, jpl=None):
    """The JAX scene (and lights) as the port's CPU tables, kept exactly."""
    scene = scene_from_numpy(numpy_fields(js), device="cpu")
    if jgl is None:
        return scene
    gl, pl = lights_from_numpy(numpy_fields(jgl), numpy_fields(jpl),
                               device="cpu")
    return scene, gl, pl


def port_trace(scene, o, d, **kw):
    return whitted.trace_whitted(scene, torch.from_numpy(o),
                                 torch.from_numpy(d), **kw)


def assert_trace_equal(got, want, msg="", fields=DISCRETE + FLOATS):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f"{msg}.{f}")


@pytest.mark.parametrize("name", SCENES)
def test_whitted_scene_tables_equal_jax(name):
    """Scene and light tables of every library scene: exact, at the
    SceneBuilder's float32 and cast to float64; params equal."""
    js, jgl, jpl, jp = getattr(jax_library, name + "_scene")()
    ts, tgl, tpl, tp = getattr(library, name + "_scene")(device="cpu")
    assert tp == jp
    for cast in (jnp.float32, jnp.float64):
        tdt = DTYPES[jnp.dtype(cast).name][1]
        want = [numpy_fields(jax_types.scene_astype(x, cast))
                for x in (js, jgl, jpl)]
        got = [scene_to_numpy(scene_astype(ts, tdt)),
               *lights_to_numpy(scene_astype(tgl, tdt),
                                scene_astype(tpl, tdt))]
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert material_flags(ts) == jax_flags(js)
    assert (tgl.count, tpl.count) == (jgl.count, jpl.count)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_refract_and_angle_between_equal_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    v, n = rng.normal(size=(2, 3, 500)).astype(jdt)
    ior = rng.uniform(1.0, 2.5, 500).astype(jdt)
    want_dir = jax_vec.refract_c(*v, *n, jnp.asarray(1.0, jdt), ior)
    got_dir = vec.refract_c(*torch.from_numpy(v), *torch.from_numpy(n),
                            torch.ones((), dtype=tdt), torch.from_numpy(ior))
    want_out = jax_vec.refract_c(*v, *(-n), ior, jnp.asarray(1.0, jdt))
    got_out = vec.refract_c(*torch.from_numpy(v), *torch.from_numpy(-n),
                            torch.from_numpy(ior), torch.ones((), dtype=tdt))
    assert bool(np.asarray(want_out[3]).any())     # some lanes reflect
    for w, g in zip((*want_dir, *want_out), (*got_dir, *got_out)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # angle_between_c: the clamped cosine is exact.  The arccos is not
    # XLA's: torch.acos equals the C library's arccos (numpy's, and the
    # executed reference's) in float64, which holds the float64 golden
    # bit for bit (tests/test_torch_shade.py); in float32 no two of the
    # libraries agree everywhere, and torch's is within 2 ulp of XLA's
    # (measured 2 over 2 M uniform cosines).
    with jax.disable_jit():
        c = np.array(jnp.clip(jax_vec.dot_c(*v, *n)
                                / (jax_vec.magnitude_c(*v)
                                   * jax_vec.magnitude_c(*n)), -1.0, 1.0))
    got = vec.angle_between_c(*torch.from_numpy(v),
                              *torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(torch.acos(torch.from_numpy(c)).numpy(),
                                  got)
    if dtype == "float64":
        np.testing.assert_array_equal(got, np.arccos(c))
    else:
        np.testing.assert_array_max_ulp(
            got, np.asarray(jax_vec.angle_between_c(*v, *n)), maxulp=2)


def _hit_rays(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(dtype), d.astype(dtype)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("by_abs", [False, True])
def test_nearest_hit_equals_jax(by_abs, fast):
    """The sweep with ids suppressed on every third ray, both metrics and
    both hit tests: every output exact, through the kernel's wrapper (its
    plain version on CPU tensors) and through ``nearest_hit_c``."""
    js = jax_library.chandelier_scene()[0]
    ts = to_port(js)
    o, d = _hit_rays(3601, seed=1)
    sup = np.where(np.arange(3601) % 3 == 0, np.asarray(js.id)[0],
                   NO_SUPPRESS).astype(np.int32)
    want = jax_intersect.nearest_hit_c(*o.T, *d.T, js, jnp.asarray(sup),
                                       by_abs=by_abs, fast=fast)
    assert 0 < np.asarray(want.found).mean() < 1
    table = cuda_intersect.sphere_table(ts)
    launches = cuda_intersect.nearest_hit.launches
    t, idx, found = cuda_intersect.nearest_hit(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(sup),
        table, by_abs=by_abs, fast=fast)
    assert cuda_intersect.nearest_hit.launches == launches
    np.testing.assert_array_equal(found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want.t))
    h = nearest_hit_c(*torch.from_numpy(o).T, *torch.from_numpy(d).T,
                      table.spec, fast=fast, by_abs=by_abs,
                      suppress_id=torch.from_numpy(sup))
    for f in ("px", "py", "pz", "nx", "ny", "nz"):
        np.testing.assert_array_equal(getattr(h, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_single_sphere_exit_and_refract_walk_equal_jax():
    """Rays entering a glass sphere (n=2, total internal reflection is
    common): the far-root exit and the whole walk, every output exact."""
    rng = np.random.default_rng(2)
    n = 400
    c = np.asarray([0.0, 0.0, 2.0], np.float32)
    r = np.float32(0.5)
    # Entry points on the sphere, directions into it.
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    p = (c + r * nrm).astype(np.float32)
    d = (-nrm + 0.9 * rng.normal(size=(n, 3))).astype(np.float32)
    nrm = nrm.astype(np.float32)
    cx, cy, cz = (np.full(n, v, np.float32) for v in c)
    rad = np.full(n, r, np.float32)
    ior = np.full(n, 2.0, np.float32)
    want = jax_intersect.single_sphere_exit_c(*p.T, *d.T, cx, cy, cz, rad)
    T = torch.from_numpy
    got = single_sphere_exit_c(*T(p).T, *T(d).T, T(cx), T(cy), T(cz),
                               T(rad))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with jax.disable_jit():       # its while_loop, op by op
        want = jax_whitted._refract_walk_c(*d.T, *nrm.T, *p.T, cx, cy, cz,
                                           rad, ior, jnp.float32)
    counters = {"walk_steps": 0, "walk_exits": 0}
    got = whitted._refract_walk_c(*T(d).T, *T(nrm).T, *T(p).T, T(cx),
                                  T(cy), T(cz), T(rad), T(ior),
                                  counters=counters)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ok = got[0].numpy()
    assert 0 < ok.mean() <= 1
    assert counters["walk_exits"] == int(ok.sum())
    assert counters["walk_steps"] > counters["walk_exits"]   # some TIR


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", SCENES)
def test_trace_whitted_equals_jax(name, dtype):
    """At 8x8 (the chandelier 24x16): every field exact against JAX run op
    by op, the discrete fields exact against the jitted tracer.  In
    float32 ``impl="kernel"`` on CPU tensors (the kernel's plain version,
    no launch) and ``sweep="kernel"`` give the same result."""
    jdt, tdt = DTYPES[dtype]
    js, _, _, p, o, d = jax_case(name, jdt, grid=8)
    eg, em = jax_flags(js)
    kw = dict(max_bounces=p.get("max_bounces", 5), enable_glass=eg,
              enable_mirror=em)
    jitted = jax_whitted.trace_whitted(js, jnp.asarray(o), jnp.asarray(d),
                                       **kw)
    with jax.disable_jit():
        want = jax_whitted.trace_whitted(js, jnp.asarray(o), jnp.asarray(d),
                                         **kw)
    ts = to_port(js)
    launches = cuda_whitted.whitted_trace.launches
    runs = [("plain", "plain")]
    if dtype == "float32":
        runs += [("plain", "kernel"), ("kernel", "plain")]
    for impl, sweep in runs:
        got = port_trace(ts, o, d, impl=impl, sweep=sweep, **kw)
        assert got.t.dtype == tdt
        assert_trace_equal(got, want, f"{name}.{impl}.{sweep}")
        assert_trace_equal(got, jitted, f"{name}.{impl}.{sweep} (jit)",
                           fields=DISCRETE)
    assert cuda_whitted.whitted_trace.launches == launches
    if name in ("planets2", "marbles4"):
        assert int(got.through.max()) >= 1 and bool(got.hit.any())


def test_trace_whitted_resume_and_shadow_budget_equal_jax():
    """Mid-chain entry (suppressed ids, bounces0, through0) and a budget
    of 0, as the shadow trace and env stepping use them: every field exact
    against JAX run op by op."""
    js, _, _, p, o, d = jax_case("marbles4", jnp.float32, grid=8)
    rng = np.random.default_rng(3)
    ids = np.asarray(js.id)
    sup = rng.choice(np.append(ids, NO_SUPPRESS), o.shape[0]).astype(
        np.int32)
    b0 = rng.integers(0, 4, o.shape[0]).astype(np.int32)
    t0 = rng.integers(0, 2, o.shape[0]).astype(np.int32)
    for mb in (0, 3):
        with jax.disable_jit():
            want = jax_whitted.trace_whitted(
                js, jnp.asarray(o), jnp.asarray(d), max_bounces=mb,
                suppress_id=jnp.asarray(sup), bounces0=jnp.asarray(b0),
                through0=jnp.asarray(t0))
        got = port_trace(to_port(js), o, d, max_bounces=mb,
                         suppress_id=torch.from_numpy(sup),
                         bounces0=torch.from_numpy(b0),
                         through0=torch.from_numpy(t0), impl="plain")
        assert_trace_equal(got, want, f"budget {mb}")


def test_kernel_impl_refuses_what_it_does_not_take():
    """Float64, a resumed chain or a per-level kernel sweep with
    ``impl="kernel"`` raise (no quiet fall back to plain); nothing
    launches."""
    js, _, _, p, o, d = jax_case("true_original", jnp.float64, grid=2)
    ts = to_port(js)
    launches = cuda_whitted.whitted_trace.launches
    with pytest.raises(TypeError, match="float32"):
        port_trace(ts, o, d, impl="kernel")
    ts32 = to_port(jax_types.scene_astype(js, jnp.float32))
    o32, d32 = o.astype(np.float32), d.astype(np.float32)
    with pytest.raises(ValueError, match="impl='plain'"):
        port_trace(ts32, o32, d32, impl="kernel",
                   bounces0=torch.zeros(o.shape[0], dtype=torch.int32))
    with pytest.raises(ValueError, match="impl='plain'"):
        port_trace(ts32, o32, d32, impl="kernel", sweep="kernel")
    with pytest.raises(ValueError, match="scene is"):
        port_trace(ts32, o, d, impl="plain")
    assert cuda_whitted.whitted_trace.launches == launches
