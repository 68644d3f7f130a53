"""The port's camera paths, turntables and compact Whitted
(raytracer_tpu_torch/render/animation.py, ``impl="compact"``) held against
the JAX package on the same inputs.

* ``look_at_rays``, ``camera_path_rays``, ``orbit_eyes``, ``lerp_eyes`` and
  ``scene_focus`` equal JAX's exactly, the camera run eagerly with 64-bit
  mode off (its ``jnp.cross`` and ``jnp.linalg.norm`` are jitted programs
  in which XLA fuses multiply-adds; the port does the same);
* every Whitted frame equals the port's single-frame ``render_whitted``
  bit for bit; against JAX's ``render_whitted_frames`` run op by op the
  frames are equal, against the jitted one within one float32 ulp;
* path frames against JAX's jitted ``render_path_frames`` on JAX's jitter
  and trace planes (``keys = split(key, F)``, each frame's ``k_jit,
  k_trace = split(k)``), with the bounds of tests/test_torch_render.py
  (unguided) and tests/test_torch_guided.py (the shipped bf16 student);
  the summed stats;
* the compact trace equal to the port's plain trace bit for bit on the
  four library scenes (which tests/test_torch_whitted.py holds to JAX's
  trace), and on marbles4, the glass scene, to JAX's
  ``trace_whitted_compact`` run op by op bit for bit and to the jitted one
  in its discrete fields.  Against the jitted one the floats are not
  bounded here: XLA fuses multiply-adds in the refraction walk, and at
  marbles4 one normal component of 423 hits moved by 1.3e-3, past
  tests/test_whitted_parity.py::test_compact_matches_fused's bound (which
  holds JAX's jitted compact against JAX's jitted fused trace, both fused
  alike).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.distill import DistilledGuide as JaxGuide
from raytracer_tpu.render import animation as jax_anim
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace import whitted as jax_whitted
from raytracer_tpu_torch.fb.distill import DistilledGuide
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR
from raytracer_tpu_torch.render import animation
from raytracer_tpu_torch.render.renderer import render_whitted
from raytracer_tpu_torch.trace import whitted

from test_torch_guided import jax_planes
from test_torch_scene import one_torch_thread, port_scene  # noqa: F401
from test_torch_whitted import (DISCRETE, SCENES, assert_trace_equal,
                                jax_case, jax_flags, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STATS = ("total_rays", "total_intersections", "light_hits",
         "small_light_hits", "fb_used", "fb_success")


@pytest.mark.parametrize("fov, w, h", [(60.0, 17, 11), (37.5, 24, 18)])
def test_look_at_rays_equal_jax(fov, w, h):
    rng = np.random.default_rng(int(fov))
    for _ in range(3):
        eye, target = rng.normal(size=3) * 4, rng.normal(size=3)
        jit = rng.random((2, h, w, 2)).astype(np.float32)
        with jax.enable_x64(False):
            jo, jd = jax_anim.look_at_rays(w, h, eye=eye, target=target,
                                           fov=fov)
            jdj = jax.vmap(lambda j: jax_anim.look_at_rays(
                w, h, eye=eye, target=target, fov=fov, sample_xy=j)[1])(
                jnp.asarray(jit))
        o, d = animation.look_at_rays(w, h, eye=eye, target=target, fov=fov,
                                      device="cpu")
        _, dj = animation.look_at_rays(w, h, eye=eye, target=target,
                                       fov=fov, sample_xy=torch.from_numpy(jit))
        assert d.dtype == torch.float32 and d.shape == (h * w, 3)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(dj.numpy(),
                                      np.asarray(jdj).reshape(-1, 3))


def test_camera_paths_and_focus_equal_jax():
    target = (0.3, 1.0, -2.0)
    with jax.enable_x64(False):
        cases = [((target, 3.0, 5.0, 8), {}),
                 ((target, 3.0, 5.0, 3), {"sweep": np.pi}),
                 ((target, 2.0, 1.0, 1), {"start_angle": 0.5})]
        for args, kw in cases:
            np.testing.assert_array_equal(
                animation.orbit_eyes(*args, device="cpu", **kw).numpy(),
                np.asarray(jax_anim.orbit_eyes(*args, **kw)))
        np.testing.assert_array_equal(
            animation.lerp_eyes((0, 0, 0), (2, 4, 6), 5, device="cpu").numpy(),
            np.asarray(jax_anim.lerp_eyes((0, 0, 0), (2, 4, 6), 5)))
        eyes = jax_anim.orbit_eyes(target, 4.0, 1.5, 6)
        jo, jd = jax_anim.camera_path_rays(eyes, target, 19, 13, fov=70.0)
    o, d = animation.camera_path_rays(
        animation.orbit_eyes(target, 4.0, 1.5, 6, device="cpu"), target, 19,
        13, fov=70.0)
    assert d.shape == (6, 19 * 13, 3)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    for name in ("chandelier", "planets2"):
        js = getattr(jax_library, name + "_scene")()[0]
        np.testing.assert_array_equal(animation.scene_focus(port_scene(js)),
                                      jax_anim.scene_focus(js))


def test_whitted_frames_equal_single_frames_and_jax():
    js, jgl, jpl, p = jax_library.true_original_scene()
    scene, gl, pl = to_port(js, jgl, jpl)
    target = (0.0, 0.0, 0.0)
    w, h, F = 16, 12, 3
    o, d = animation.camera_path_rays(
        animation.orbit_eyes(target, 3.0, 0.5, F, device="cpu"), target, w, h)
    kw = dict(max_bounces=p["max_bounces"], background=p["background"])
    frames = animation.render_whitted_frames(scene, gl, pl, o, d, h, w, **kw)
    assert frames.shape == (F, h, w, 3)
    for f in range(F):
        single = render_whitted(scene, gl, pl, o[f].contiguous(),
                                d[f].contiguous(), h, w, **kw)
        assert torch.equal(frames[f], single)
    assert not torch.equal(frames[0], frames[1])
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    with jax.enable_x64(False):
        jitted = np.asarray(jax_anim.render_whitted_frames(
            js, jgl, jpl, jo, jd, h, w, **kw))
        with jax.disable_jit():
            eager = np.asarray(jax_anim.render_whitted_frames(
                js, jgl, jpl, jo, jd, h, w, **kw))
    np.testing.assert_array_equal(frames.numpy(), eager)
    # Jitted, XLA multiplies by 1/255: one float32 ulp.
    np.testing.assert_array_max_ulp(frames.numpy(), jitted, maxulp=1)


def jax_frame_planes(key, F, spp, h, w, max_bounces):
    """``render_path_frames``'s draws: ``keys = split(key, F)``, each
    frame's ``k_jit, k_trace = split(k)``, the jitter from ``k_jit`` and
    the trace planes from ``k_trace``."""
    jit, u, fb = [], [], []
    for k in jax.random.split(key, F):
        k_jit, k_trace = jax.random.split(k)
        jit.append(np.asarray(jax.random.uniform(k_jit, (spp, h, w, 2),
                                                 jnp.float32)))
        uk, fk = jax_planes(k_trace, max_bounces, spp * h * w)
        u.append(uk)
        fb.append(fk)
    return (torch.from_numpy(np.stack(a)) for a in (jit, u, fb))


@pytest.mark.parametrize("guided", [False, True],
                         ids=["unguided", "student"])
def test_path_frames_match_jax(guided):
    """Chandelier 24x12, 2 frames, 2 spp, 3 bounces, mirror_threshold 0.9.
    Unguided: the summed stats equal; every subpixel within one 8-bit step
    and at least 99% within one float32 ulp of 1.0 (6e-8, the jitted
    ``/ 255``).  Guided by the shipped bf16 student: at least 90% of pixels
    equal to that ulp, light and small-light hits within 0.9-1.12x, fb_used
    > 0.  Measured: every count equal in both, every subpixel within 6e-8.
    """
    js, _, _, _ = jax_library.chandelier_scene()
    target = jax_anim.scene_focus(js)
    F, w, h, spp, L = 2, 24, 12, 2, 3
    kw = dict(width=w, height=h, spp=spp, max_bounces=L,
              background=(2.0, 2.0, 5.0))
    name = "fb_chandelier_distilled.npz"
    jg = JaxGuide.load(STUDENTS_DIR / name).as_guide_fn() if guided else None
    tg = (DistilledGuide.load(STUDENTS_DIR / name).as_guide_fn() if guided
          else None)
    key = jax.random.key(3)
    with jax.enable_x64(False):
        eyes = jax_anim.orbit_eyes(target, 6.0, 2.0, F)
        want, wst = jax_anim.render_path_frames(js, key, eyes, target,
                                                guide_fn=jg, **kw)
        jit, u, fb = jax_frame_planes(key, F, spp, h, w, L)
    want = np.asarray(want)
    got, gst = animation.render_path_frames(
        port_scene(js), torch.from_numpy(np.array(eyes)), target,
        jitter=jit, uniforms=u, fb_uniforms=fb if guided else None,
        guide_fn=tg, impl="plain", device="cpu", **kw)
    got = got.numpy()
    assert got.shape == (F, h, w, 3)
    gst = gst.as_dict()
    wst = {s: int(getattr(wst, s)) for s in STATS}
    if not guided:
        assert gst == wst
        diff = np.abs(got - want)
        assert diff.max() <= 1 / 255
        assert (diff <= 6e-8).mean() >= 0.99
    else:
        assert gst["fb_used"] > 0
        same = (np.abs(got - want) <= 6e-8).all(-1)
        assert same.mean() >= 0.9, same.mean()
        for f in ("light_hits", "small_light_hits"):
            assert wst[f] > 0 and 0.9 <= gst[f] / wst[f] <= 1.12, (gst, wst)
    # The generator's draws: jitter, uniforms, fb plane, frame by frame.
    g = torch.Generator().manual_seed(1)
    a, sa = animation.render_path_frames(
        port_scene(js), torch.from_numpy(np.array(eyes)), target,
        generator=g, guide_fn=tg, device="cpu", **kw)
    g = torch.Generator().manual_seed(1)
    planes = [[torch.rand(s, generator=g) for s in
               ((spp, h, w, 2), (L, spp * h * w, 2), (L, spp * h * w))
               [:3 if guided else 2]] for _ in range(F)]
    b, sb = animation.render_path_frames(
        port_scene(js), torch.from_numpy(np.array(eyes)), target,
        jitter=torch.stack([p[0] for p in planes]),
        uniforms=torch.stack([p[1] for p in planes]),
        fb_uniforms=torch.stack([p[2] for p in planes]) if guided else None,
        guide_fn=tg, device="cpu", **kw)
    assert torch.equal(a, b) and sa.as_dict() == sb.as_dict()


@pytest.mark.parametrize("name", SCENES)
def test_compact_equals_plain_and_jax(name):
    """Every field bit for bit against the port's plain trace, with the
    default min_bucket and one below the live count; marbles4 against JAX's
    compact trace as the module note says."""
    js, jgl, jpl, p, o, d = jax_case(name, grid=8)
    eg, em = jax_flags(js)
    kw = dict(max_bounces=p.get("max_bounces", 5), enable_glass=eg,
              enable_mirror=em)
    ts = to_port(js)
    # The chandelier's JAX camera is float64 under the suite's 64-bit mode;
    # trace_whitted casts, the level loop below takes the rays as given.
    to, td = torch.from_numpy(o), torch.from_numpy(d).float()
    plain = whitted.trace_whitted(ts, to, td, impl="plain", **kw)
    counters = {}
    from raytracer_tpu_torch.core import cuda_intersect, cuda_whitted
    table = cuda_intersect.sphere_table(ts, eg, em)
    small = cuda_whitted.whitted_trace_compact(
        to, td, None, table, max_bounces=kw["max_bounces"], min_bucket=4,
        counters=counters)
    for res in (whitted.trace_whitted(ts, to, td, impl="compact", **kw),
                small):
        assert_trace_equal(res, plain, name)
    lanes = counters["lanes"]
    assert lanes[0] == (o.shape[0], o.shape[0])
    if len(lanes) > 1:
        assert 4 < lanes[1][0] <= lanes[1][1] < o.shape[0], lanes
    if name != "marbles4":      # JAX's compact runs for the glass scene
        return
    jkw = dict(min_bucket=4, **kw)
    with jax.enable_x64(False), jax.disable_jit():
        eager = jax_whitted.trace_whitted_compact(
            js, jnp.asarray(o), jnp.asarray(d), **jkw)
    assert_trace_equal(small, eager, f"{name} (JAX op by op)")
    jitted = jax_whitted.trace_whitted_compact(
        js, jnp.asarray(o), jnp.asarray(d), **jkw)
    hit = np.asarray(jitted.hit)
    np.testing.assert_array_equal(small.hit.numpy(), hit)
    for f in DISCRETE[1:]:
        np.testing.assert_array_equal(getattr(small, f).numpy()[hit],
                                      np.asarray(getattr(jitted, f))[hit])


def test_render_whitted_compact_image_equals_plain():
    js, jgl, jpl, p, o, d = jax_case("planets2", grid=10)
    scene, gl, pl = to_port(js, jgl, jpl)
    n = int(np.sqrt(o.shape[0]))
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p.get("sky_colour"))
    imgs = [render_whitted(scene, gl, pl, torch.from_numpy(o),
                           torch.from_numpy(d), n, n, impl=impl, **kw)
            for impl in ("plain", "compact")]
    assert torch.equal(imgs[0], imgs[1])
    with pytest.raises(ValueError, match="compact"):
        whitted.trace_whitted(scene, torch.from_numpy(o), torch.from_numpy(d),
                              impl="compact", sweep="kernel")


def test_entry_points_ask_for_the_card():
    """Without ``device``, the camera paths and the path frames run on
    ``cuda``: with no card they raise, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    scene = port_scene(jax_library.chandelier_scene()[0])
    for call in (lambda: animation.orbit_eyes((0, 0, 0), 1.0, 0.0, 2),
                 lambda: animation.lerp_eyes((0, 0, 0), (1, 1, 1), 2),
                 lambda: animation.look_at_rays(4, 3, eye=(0, 0, 1),
                                                target=(0, 0, 0)),
                 lambda: animation.render_path_frames(
                     scene, torch.zeros((1, 3)), (0, 0, -1), width=4,
                     height=3, generator=torch.Generator())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
