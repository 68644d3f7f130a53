"""The port's comparison harness (raytracer_tpu_torch/compare/harness.py)
and chunked renderer (``render_path(spp_chunk=...)``) held against the JAX
package's on JAX's planes, and the port's student pins.

* ``run_comparison`` at 32x16@2spp/3 on the chandelier, both sides
  ``impl="stepwise"``, each side fed the planes JAX draws from its key
  (``k1, k2 = split(key(seed))``; a side's ``k_jit, k_trace =
  split(k)``): with no model, with the shipped all-around student and
  with a seeded full-width agent written by the port's ``save_fb``.  JAX
  runs op by op (``jax.disable_jit``) with 64-bit mode off; every count of
  ``statistics.json`` equal (measured: equal in all three cases), the
  schema key for key.
* ``render_path(spp_chunk=2)`` at 24x12@4spp/3, mirror_threshold 0.9,
  against JAX's jitted chunked renderer on its per-chunk planes (``keys =
  split(key, chunks)``): every count equal, the image within the bounds
  ``tests/test_torch_render.py`` states against jitted JAX (every subpixel
  within 1/255, at least 99% within one float32 ulp of 1.0).
* The student pins of ``tests/test_distill.py`` through the port's
  harness, same configurations and thresholds, the port's own seeded
  draws.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.compare import harness as jax_harness
from raytracer_tpu.render import path_renderer as jax_renderer
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu_torch.compare import harness
from raytracer_tpu_torch.fb.agent import FBResearchAgent
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR
from raytracer_tpu_torch.render.path_renderer import render_path

from test_torch_guided import jax_planes
from test_torch_scene import one_torch_thread, port_scene  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "models"
COUNTS = ("total_rays", "total_intersections", "light_hits",
          "small_light_hits")
FB_COUNTS = COUNTS + ("fb_used", "fb_success", "fb_success_rate",
                      "samples_per_pixel")


def render_planes(key, spp, h, w, max_bounces):
    """The planes JAX's ``render_path`` draws from ``key``: ``k_jit,
    k_trace = split(key)``, the jitter from ``k_jit``, each level's from
    ``k_trace``."""
    k_jit, k_trace = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k_jit, (spp, h, w, 2),
                                         jnp.float32))
    u, f = jax_planes(k_trace, max_bounces, spp * h * w)
    return {"jitter": torch.from_numpy(jitter),
            "uniforms": torch.from_numpy(u),
            "fb_uniforms": torch.from_numpy(f)}


def seeded_agent_checkpoint(path):
    """A full-width agent with seeded weights, written by the port."""
    FBResearchAgent(FBConfig(), seed=3, device="cpu").save(path)
    return path


@pytest.mark.parametrize("model", ["none", "student", "agent"])
def test_run_comparison_matches_jax(tmp_path, monkeypatch, model):
    w, h, spp, bounces, seed = 32, 16, 2, 3, 4
    if model == "none":
        # JAX builds a seeded full-width agent it does not use when there
        # is no model (loaded False); op by op that costs ~16 s.
        monkeypatch.setattr(jax_harness, "TrainedFBAgent",
                            lambda *a, **k: SimpleNamespace(loaded=False))
    model_path = {"none": None,
                  "student": str(STUDENTS_DIR / "fb_chandelier_distilled.npz"),
                  "agent": None}[model]
    if model == "agent":
        model_path = str(seeded_agent_checkpoint(tmp_path / "agent.npz"))
    js, _, _, p = jax_library.chandelier_scene()
    kw = dict(camera_position=p["camera_position"], width=w, height=h,
              samples_per_pixel=spp, max_bounces=bounces,
              model_path=model_path, save_png=False, warmup=False,
              impl="stepwise", seed=seed)
    with jax.enable_x64(False), jax.disable_jit():
        want = jax_harness.run_comparison(js, out_dir=tmp_path / "jax",
                                          **kw)
    k1, k2 = jax.random.split(jax.random.key(seed))
    got = harness.run_comparison(
        port_scene(js), out_dir=tmp_path / "port", device="cpu",
        traditional_planes=render_planes(k1, spp, h, w, bounces),
        fb_planes=render_planes(k2, spp, h, w, bounces), **kw)
    assert set(got) == set(want)
    for side in ("traditional", "fb"):
        assert set(got[side]) == set(want[side])
    assert got["implementations"] == want["implementations"]
    assert set(got["comparison"]) == set(want["comparison"])
    assert {k: got["traditional"][k] for k in COUNTS} == \
        {k: want["traditional"][k] for k in COUNTS}
    assert {k: got["fb"][k] for k in FB_COUNTS} == \
        {k: want["fb"][k] for k in FB_COUNTS}
    for k in ("ray_efficiency", "small_light_improvement"):
        assert got["comparison"][k] == want["comparison"][k]
    if model == "none":
        assert got["fb"]["fb_used"] == 0
    else:
        assert got["fb"]["fb_used"] > 0
    saved = json.loads((tmp_path / "port" / "statistics.json").read_text())
    assert saved == json.loads(json.dumps(got))


def test_statistics_json_schema_and_png(tmp_path):
    """JAX's tests/test_compare.py schema checks, on the port's own seeded
    draws, with the comparison PNG (two frames and the difference side by
    side)."""
    from PIL import Image
    stats = harness.chandelier_comparison(
        width=24, height=12, samples_per_pixel=2, max_bounces=3,
        out_dir=tmp_path / "cmp", device="cpu", impl="plain")
    assert set(stats) == {"traditional", "fb", "comparison",
                          "implementations"}
    for side in ("traditional", "fb"):
        assert stats[side]["total_rays"] > 0
        assert stats[side]["rays_per_second"] > 0
    assert set(stats["comparison"]) == {"speedup", "ray_efficiency",
                                        "small_light_improvement"}
    assert stats["fb"]["fb_used"] == 0
    assert stats["implementations"] == {"traditional": "plain",
                                        "fb": "plain", "timing_iters": 1}
    png = np.asarray(Image.open(tmp_path / "cmp" / "comparison.png"))
    assert png.shape == (12, 72, 3)
    again = harness.chandelier_comparison(
        width=24, height=12, samples_per_pixel=2, max_bounces=3,
        out_dir=tmp_path / "cmp2", device="cpu", impl="plain",
        save_png=False)
    for side in ("traditional", "fb"):
        assert {k: again[side][k] for k in COUNTS} == \
            {k: stats[side][k] for k in COUNTS}
    with pytest.raises(ValueError, match="spp_chunk"):
        harness.chandelier_comparison(width=8, height=4,
                                      samples_per_pixel=4, spp_chunk=3,
                                      out_dir=tmp_path / "x", device="cpu")


def test_spp_chunk_matches_jax_chunked():
    js, _, _, p = jax_library.chandelier_scene()
    w, h, spp, chunk, bounces = 24, 12, 4, 2, 3
    kw = dict(width=w, height=h, spp=spp, max_bounces=bounces,
              camera_position=p["camera_position"], mirror_threshold=0.9)
    key = jax.random.key(11)
    with jax.enable_x64(False):
        want, want_st = jax_renderer.render_path(js, key, spp_chunk=chunk,
                                                 **kw)
        want = np.asarray(want)
        planes = [render_planes(k, chunk, h, w, bounces)
                  for k in jax.random.split(key, spp // chunk)]
    got, got_st = render_path(
        port_scene(js), impl="plain", device="cpu", spp_chunk=chunk,
        jitter=torch.cat([pl["jitter"] for pl in planes]),
        uniforms=torch.stack([pl["uniforms"] for pl in planes]), **kw)
    assert {f: int(getattr(got_st, f)) for f in COUNTS} == \
        {f: int(getattr(want_st, f)) for f in COUNTS}
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 1 / 255
    assert (diff <= 6e-8).mean() >= 0.99


def test_spp_chunk_sums_its_chunks_and_refuses_other_impls():
    """The chunked frame is ``floor(sum of the chunks' integer sums / spp)``
    over chunks rendered one by one on the same planes, stats summed; the
    generator draws a chunk's planes in turn; hybrid and stepwise refuse
    ``spp_chunk`` (JAX: fused only) and a chunk must divide spp."""
    ts = port_scene(jax_library.chandelier_scene()[0])
    p = jax_library.chandelier_scene()[3]
    kw = dict(width=10, height=6, max_bounces=3, mirror_threshold=0.9,
              camera_position=p["camera_position"], device="cpu")
    g = torch.Generator().manual_seed(1)
    jitter = torch.rand((4, 6, 10, 2), generator=g)
    u = torch.rand((2, 3, 120, 2), generator=g)
    img, st = render_path(ts, spp=4, spp_chunk=2, jitter=jitter, uniforms=u,
                          impl="kernel", **kw)
    from raytracer_tpu_torch.render.camera import perspective_rays
    from raytracer_tpu_torch.trace.path import trace_path
    total, rays = torch.zeros((6, 10, 3)), 0
    for c in range(2):
        o, d = perspective_rays(10, 6, fov=60.0, origin=p["camera_position"],
                                sample_xy=jitter[2 * c:2 * c + 2])
        rgb, s = trace_path(ts, o, d, max_bounces=3, mirror_threshold=0.9,
                            uniforms=u[c], impl="plain")
        total += rgb.reshape(2, 6, 10, 3).sum(0)
        rays += int(s.total_rays)
    want = torch.clamp_max(torch.floor(total / 4) / 255.0, 1.0)
    assert torch.equal(img, want) and int(st.total_rays) == rays
    a = render_path(ts, spp=4, spp_chunk=2, impl="plain",
                    generator=torch.Generator().manual_seed(5), **kw)
    b = render_path(ts, spp=4, spp_chunk=2, impl="plain",
                    generator=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(a[0], b[0]) and a[1].as_dict() == b[1].as_dict()
    for impl in ("hybrid", "stepwise"):
        with pytest.raises(ValueError, match="spp_chunk"):
            render_path(ts, spp=4, spp_chunk=2, impl=impl,
                        generator=torch.Generator().manual_seed(0), **kw)
    with pytest.raises(ValueError, match="divisible"):
        render_path(ts, spp=4, spp_chunk=3, impl="plain",
                    generator=torch.Generator().manual_seed(0), **kw)


# tests/test_distill.py's student pins, at their configurations (4 spp, 8
# bounces, seed 5) and thresholds, through the port's harness with its
# default impl "stepwise" (JAX's default too): (comparison, student,
# width, height, least small-light improvement).
PINS = {
    "distilled_chandelier_2to1_aspect": (
        "chandelier", "fb_chandelier_distilled.npz", 100, 50, 1.5),
    "distilled_chandelier_4to3_aspect": (
        "chandelier", "fb_chandelier_distilled.npz", 120, 90, 2.2),
    "specialist_2to1": (
        "chandelier", "fb_chandelier_distilled_2to1.npz", 100, 50, 4.0),
    "distilled_complex": (
        "complex", "fb_complex_distilled.npz", 100, 50, 10.0),
}


@pytest.mark.parametrize("pin", sorted(PINS))
def test_shipped_student_pins(tmp_path, pin):
    which, name, w, h, floor = PINS[pin]
    fn = (harness.chandelier_comparison if which == "chandelier"
          else harness.complex_comparison)
    stats = fn(model_path=str(STUDENTS_DIR / name), width=w, height=h,
               samples_per_pixel=4, max_bounces=8, seed=5, save_png=False,
               warmup=False, out_dir=tmp_path / pin, device="cpu")
    assert stats["fb"]["fb_used"] > 0
    imp = stats["comparison"]["small_light_improvement"]
    assert imp > floor, f"{pin}: small-light improvement {imp}"


def test_shipped_cornell_student_pin(tmp_path):
    """tests/test_distill.py's cornell student on the held-out variation
    1007 (impl "fused" there, "plain" here), > 2x."""
    model = MODELS / "fb_cornell_distilled.npz"
    if not model.exists():
        pytest.skip("shipped model missing")
    from raytracer_tpu_torch.scene.templates import generate_scene
    scene, name = generate_scene("cornell_box", 1007, device="cpu")
    stats = harness.run_comparison(
        scene, camera_position=(0.0, 0.5, 0.0), width=100, height=50,
        samples_per_pixel=4, max_bounces=8, model_path=str(model),
        out_dir=tmp_path / "cornell", scene_name=name, save_png=False,
        impl="plain", seed=5, warmup=False, device="cpu")
    assert stats["fb"]["fb_used"] > 0
    imp = stats["comparison"]["small_light_improvement"]
    assert imp > 2.0, f"cornell student improvement {imp}"


def test_matched_signal_mode_spends_fewer_samples(tmp_path):
    """tests/test_distill.py's matched-signal pin: the FB side at 2 spp
    against 4, both recorded, the FB side's rays 0.3-0.75x."""
    stats = harness.chandelier_comparison(
        model_path=str(STUDENTS_DIR / "fb_chandelier_distilled.npz"),
        width=40, height=20, samples_per_pixel=4, max_bounces=4, seed=3,
        save_png=False, fb_samples_per_pixel=2, warmup=False,
        out_dir=tmp_path / "matched", device="cpu")
    assert stats["traditional"]["samples_per_pixel"] == 4
    assert stats["fb"]["samples_per_pixel"] == 2
    ratio = stats["fb"]["total_rays"] / stats["traditional"]["total_rays"]
    assert 0.3 < ratio < 0.75, ratio


def test_complex_student_copy_is_byte_equal():
    copy = (STUDENTS_DIR / "fb_complex_distilled.npz").read_bytes()
    assert copy == (MODELS / "fb_complex_distilled.npz").read_bytes()

