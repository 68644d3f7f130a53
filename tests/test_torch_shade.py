"""Port Whitted shading, grid camera and frame renderer
(raytracer_tpu_torch.trace.shade, render.camera.grid_rays,
render.renderer) held against the JAX package, the scalar oracle and the
executed-reference goldens.

Bounds, and why:

* ``incidence``, ``terminal_rgb`` and ``grid_rays``: exact.  Shading
  rounds each channel to an integer (``round(albedo * light / 255)``), so
  the one place the port's arithmetic may differ from XLA's, the arccos
  (torch's equals the C library's; tests/test_torch_whitted.py), moves no
  shaded value at these inputs;
* the float64 ``render_whitted(impl="plain")`` against
  tests/golden/true_original_61.npy: tests/test_golden_reference.py's own
  bound (max diff < 1e-12, more than 90% of values exact); against the
  scalar oracle: tests/test_whitted_parity.py's (MSE < 1e-9, exact
  fraction > 0.999).  Measured: exact everywhere;
* against the jitted JAX renderer in float32: every value within one
  float32 ulp of 1.0 (6e-8): XLA turns ``img / 255`` into a multiply by
  ``f32(1/255)``, the port divides.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import raytracer_tpu.scene.types as jax_types
from raytracer_tpu.render import renderer as jax_renderer
from raytracer_tpu.render.camera import grid_rays as jax_grid_rays
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace import shade as jax_shade
from raytracer_tpu.trace import whitted as jax_whitted
from raytracer_tpu_torch.core import cuda_intersect
from raytracer_tpu_torch.render.camera import grid_rays
from raytracer_tpu_torch.render.renderer import render_whitted
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.types import scene_astype
from raytracer_tpu_torch.trace import shade
from raytracer_tpu_torch.trace.whitted import TraceResult

from test_torch_whitted import DTYPES, jax_case, to_port

GOLDEN = Path(__file__).parent / "golden"
PARITY = Path(__file__).parents[1] / "showcase" / "parity_fullres"
NOTEBOOK = ("true_original", "planets2", "marbles4")


def test_incidence_equal_jax():
    rng = np.random.default_rng(4)
    ang = rng.uniform(0, np.pi, 1000)
    for max_angle in (np.pi / 2, np.pi):
        want = jax_shade.incidence(jnp.asarray(ang), jnp.asarray(max_angle))
        got = shade.incidence(torch.from_numpy(ang),
                              torch.tensor(max_angle, dtype=torch.float64))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shadow_max_bounces", [0, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NOTEBOOK)
def test_terminal_rgb_equals_jax(name, dtype, shadow_max_bounces):
    """The same JAX termini shaded by both packages (41x41 grid): exact.
    In float32 ``impl="kernel"`` on CPU tensors (the kernels' plain
    versions, no launch) gives the same colours."""
    jdt, _ = DTYPES[dtype]
    js, jgl, jpl, p, o, d = jax_case(name, jdt, grid=20)
    res = jax_whitted.trace_whitted(js, jnp.asarray(o), jnp.asarray(d),
                                    max_bounces=p["max_bounces"])
    bg = p["background"]
    want = np.asarray(jax_shade.terminal_rgb(
        js, jgl, jpl, res, jnp.asarray(bg, jdt),
        shadow_max_bounces=shadow_max_bounces))
    ts, tgl, tpl = to_port(js, jgl, jpl)
    tres = TraceResult(**{f: torch.from_numpy(np.array(getattr(res, f)))
                          for f in ("hit", "idx", "point", "normal", "t",
                                    "bounces", "through")})
    impls = ["plain"] + (["kernel"] if dtype == "float32" else [])
    launches = cuda_intersect.nearest_hit.launches
    for impl in impls:
        got = shade.terminal_rgb(ts, tgl, tpl, tres, bg,
                                 shadow_max_bounces=shadow_max_bounces,
                                 impl=impl).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=impl)
    assert cuda_intersect.nearest_hit.launches == launches
    assert (want > np.asarray(bg)).any()          # some light arrives


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("args", [(100, 0.01, 3, (0, 0, 1)),
                                  (100, 0.005, 1, (0, 0, 5)),
                                  (7, 0.3, 2, (0.5, -1, 10))])
def test_grid_rays_equal_jax(args, dtype):
    jdt, tdt = DTYPES[dtype]
    n, step, mult, origin = args
    jo, jd, jh, jw = jax_grid_rays(n, step, mult, origin=origin, dtype=jdt)
    to, td, th, tw = grid_rays(n, step, mult, origin=origin, dtype=tdt,
                               device="cpu")
    assert (th, tw) == (jh, jw) == (2 * n * mult + 1,) * 2
    assert td.dtype == tdt and to.is_contiguous()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _f64(name):
    s, gl, pl, p = getattr(library, name + "_scene")(device="cpu")
    return (*(scene_astype(x, torch.float64) for x in (s, gl, pl)), p)


def test_true_original_61_golden_f64():
    """tests/test_golden_reference.py's frame and bound, through the
    port's plain float64 renderer."""
    s, gl, pl, p = _f64("true_original")
    o, d, h, w = grid_rays(30, 1.0 / 30.0, 1, origin=p["camera_position"],
                           dtype=torch.float64, device="cpu")
    img = render_whitted(s, gl, pl, o, d, h, w, max_bounces=5,
                         background=p["background"], mode="unit",
                         impl="plain").numpy()
    ref = np.load(GOLDEN / "true_original_61.npy")
    diff = np.abs(img - ref)
    assert diff.max() < 1e-12
    assert (diff == 0).mean() > 0.9


def _to_oracle(scene, gl, pl):
    f = lambda t: tuple(float(v) for v in t.tolist())    # noqa: E731
    spheres = [oracle.OSphere(
        centre=f(scene.centre[i]), radius=float(scene.radius[i]),
        colour=f(scene.colour[i]), reflective=float(scene.reflective[i]),
        transparent=float(scene.transparent[i]),
        emitive=float(scene.emitive[i]), ior=float(scene.ior[i]),
        id=int(scene.id[i])) for i in range(scene.num_spheres)]
    glights = [oracle.OGlobalLight(
        vector=f(gl.vector[i]), colour=f(gl.colour[i]),
        strength=float(gl.strength[i]), max_angle=float(gl.max_angle[i]))
        for i in range(gl.count)]
    plights = [oracle.OPointLight(
        id=int(pl.id[i]), position=f(pl.position[i]),
        colour=f(pl.colour[i]), strength=float(pl.strength[i]),
        max_angle=float(pl.max_angle[i]), func=int(pl.func[i]))
        for i in range(pl.count)]
    return spheres, glights, plights


@pytest.mark.parametrize("name,ray_count,ray_step", [
    ("true_original", 30, 1.0 / 30.0), ("planets2", 30, 5.0 / 300.0),
    ("marbles4", 30, 0.2 / 30.0)])
def test_render_whitted_matches_oracle_f64(name, ray_count, ray_step):
    """tests/test_whitted_parity.py's frames and bounds: the mirror chain
    and its fallback (planets2), glass n=2 with total internal reflection
    and sky misses (marbles4), shadow rays and both light kinds."""
    s, gl, pl, p = _f64(name)
    o, d, h, w = grid_rays(ray_count, ray_step, 1,
                           origin=p["camera_position"], dtype=torch.float64,
                           device="cpu")
    bg = p["background"]
    miss = p.get("sky_colour", bg)
    img = render_whitted(s, gl, pl, o, d, h, w, max_bounces=p["max_bounces"],
                         background=bg, miss_colour=miss,
                         impl="plain").numpy()
    n, step = ray_count, ray_step
    xs = [r * step for r in range(-n, 0)] + [r * step
                                            for r in range(0, n + 1)]
    ys = [r * step for r in range(n, 0, -1)] + [-r * step
                                                for r in range(0, n + 1)]
    ref = np.asarray(oracle.render(
        *_to_oracle(s, gl, pl), tuple(map(float, p["camera_position"])), xs,
        ys, p["max_bounces"], tuple(map(float, bg)), tuple(map(float, miss)),
        mode="unit"))
    diff = np.abs(img - ref)
    assert float(np.mean(diff ** 2)) < 1e-9
    assert float(np.mean(diff < 1e-12)) > 0.999


@pytest.mark.parametrize("name", NOTEBOOK)
def test_render_whitted_matches_jax_jitted_renderer(name):
    """Float32 frames at 25x25 through the jitted JAX renderer and the
    port's plain renderer: every value within one float32 ulp of 1.0."""
    js, jgl, jpl, p, o, d = jax_case(name, jnp.float32, grid=12)
    h = w = 25
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p.get("sky_colour"))
    want = np.asarray(jax_renderer.render_whitted(
        js, jgl, jpl, jnp.asarray(o), jnp.asarray(d), h, w, **kw))
    ts, tgl, tpl = to_port(js, jgl, jpl)
    got = render_whitted(ts, tgl, tpl, torch.from_numpy(o),
                         torch.from_numpy(d), h, w, impl="plain",
                         **kw).numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 6e-8


def test_render_whitted_chunks_padding_and_modes():
    """Chunked (ragged last chunk, edge-padded) and padded-wavefront
    renders equal the whole frame; ``raw`` is the unit image times 255
    before the clip; bad arguments raise."""
    s, gl, pl, p = library.marbles4_scene(device="cpu")
    o, d, h, w = grid_rays(10, 0.02, 1, origin=p["camera_position"],
                           device="cpu")
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p["sky_colour"], impl="plain")
    whole = render_whitted(s, gl, pl, o, d, h, w, **kw)
    chunked = render_whitted(s, gl, pl, o, d, h, w, chunk_rays=100, **kw)
    assert torch.equal(whole, chunked)
    pad = torch.cat([o, o[:5]]), torch.cat([d, d[:5]])
    padded = render_whitted(s, gl, pl, *pad, h, w, n_valid=h * w, **kw)
    assert torch.equal(whole, padded)
    raw = render_whitted(s, gl, pl, o, d, h, w, mode="raw", **kw)
    assert torch.equal(torch.clamp_max(raw / torch.tensor(255.0), 1.0),
                       whole)
    assert bool((raw == raw.round()).all())         # integer colours
    with pytest.raises(ValueError, match="mode"):
        render_whitted(s, gl, pl, o, d, h, w, mode="hdr", impl="plain")
    with pytest.raises(ValueError, match="n_valid"):
        render_whitted(s, gl, pl, o, d, h + 1, w, impl="plain")
    with pytest.raises(ValueError, match="impl"):
        render_whitted(s, gl, pl, o, d, h, w, impl="pallas")


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_true_original_601_fullres_golden(dtype):
    """The full 601x601 frame against the executed reference.  Float64:
    tests/test_parity_fullres.py's bounds (MSE < 1e-8, at most 4 pixels
    off by more than 1/255; measured 5.7e-11 and 1).  Float32, the
    kernel's type: at most 32 divergent pixels and MSE over the agreeing
    pixels below 1e-8 (JAX float32 measured 8 and 2.1e-10,
    showcase/parity_fullres/parity.json; the port measured 2 and
    3.1e-10)."""
    tdt = DTYPES[dtype][1]
    s, gl, pl, p = library.true_original_scene(device="cpu")
    s, gl, pl = (scene_astype(x, tdt) for x in (s, gl, pl))
    o, d, h, w = grid_rays(p["ray_count"], p["ray_step"], p["multiple"],
                           origin=p["camera_position"], dtype=tdt,
                           device="cpu")
    img = render_whitted(s, gl, pl, o, d, h, w, max_bounces=5,
                         background=p["background"], impl="plain")
    img = img.numpy().astype(np.float64)
    ref = np.load(PARITY / "true_original_601_ref.npy").astype(np.float64)
    dd = np.abs(img - ref)
    per_px = dd.max(axis=-1)
    if dtype == "float64":
        assert float(np.mean(dd ** 2)) < 1e-8
        assert int((per_px > 1 / 255).sum()) <= 4
    else:
        agree = per_px <= 1 / 255
        assert int((~agree).sum()) <= 32
        assert float(np.mean(dd[agree] ** 2)) < 1e-8
