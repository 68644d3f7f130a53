"""The Whitted shading kernel (raytracer_tpu_torch/core/cuda_shade.py,
csrc/whitted_shade.cu) and the routes into it.

On the CPU: the wrapper runs the plain shading with no launch, rejects
what the kernel does not take with no launch, ``terminal_rgb`` keeps the
shadow trace for ``shadow_max_bounces > 0``, the frame shades with the
table its trace built, which equals a fresh ``sphere_table`` of the scene
(with and without glass and mirrors), and the launch count is among the
counters.  On a card: the kernel against ``terminal_rgb(impl="plain")``
in float32 on the same termini, bit for bit: planets2 at 2001x2001 on two
eyes, the library scenes, the RL env's scene at 2,048 rays, the edge
cases (1 and 129 termini, misses only, termini on a light's own sphere,
``func`` -1 and 0, no global light, no point light, 1 and 1,024
spheres), and ``render_grid``'s whole frame against the plain route, one
shading launch and no nearest-hit launch a frame.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_whitted_shade.py -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import cuda_intersect, cuda_shade
from raytracer_tpu_torch.render import renderer
from raytracer_tpu_torch.render.camera import grid_rays
from raytracer_tpu_torch.render.renderer import (material_flags, render_grid,
                                                 render_whitted)
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.types import (SceneBuilder,
                                             empty_global_lights,
                                             empty_point_lights)
from raytracer_tpu_torch.trace.shade import terminal_rgb
from raytracer_tpu_torch.trace.whitted import trace_whitted
from raytracer_tpu_torch.utils import profiling

CARD_ONLY = ("needs an NVIDIA GPU: run on the card with python -m pytest "
             "--noconftest tests/test_torch_whitted_shade.py -m cuda")
SKY = (5.0, 10.0, 200.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch on one CPU thread: the suite runs in several xdist workers
    at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def card():
    if not torch.cuda.is_available():
        pytest.skip(CARD_ONLY)
    return torch.device("cuda")


def edge_scene(device, glass_and_mirror=True):
    """Two light spheres (point lights 50 with func 0 and 51 with func -1),
    a diffuse floor, and, with ``glass_and_mirror``, a glass ball, a mirror
    and a sphere both glass and mirror (the mirror rule wins: it blocks);
    a global light from above."""
    b = SceneBuilder()
    b.add_sphere((0.0, 2.0, -6.0), 0.5, (255, 240, 200), emitive=1.0, id=50)
    b.add_sphere((2.5, 0.5, -5.0), 0.4, (200, 220, 255), emitive=0.5, id=51)
    b.add_sphere((0.0, -101.0, -6.0), 100.0, (120, 200, 90), id=5)
    if glass_and_mirror:
        b.add_sphere((0.0, 0.6, -6.0), 0.6, (250, 250, 250), transparent=1.0,
                     ior=1.5, id=3)
        b.add_sphere((-1.6, 0.0, -6.5), 0.8, (200, 200, 200), reflective=1.0,
                     id=4)
        b.add_sphere((1.3, -0.2, -6.2), 0.5, (90, 90, 250), reflective=1.0,
                     transparent=1.0, ior=1.3, id=6)
    b.add_point_light(50, (0.0, 2.0, -6.0), (255, 255, 255), strength=1.5,
                      max_angle=1.4, func=0)
    b.add_point_light(51, (2.5, 0.5, -5.0), (255, 200, 150), strength=0.8,
                      max_angle=np.pi / 2, func=-1)
    b.add_global_light((0.2, 1.0, 0.3), (255, 255, 255), strength=0.4,
                       max_angle=1.2)
    return b.build(device=device)


def random_scene(n_spheres, seed, device):
    """``n_spheres`` seeded spheres in front of the origin (some glass, some
    mirrors, two emitting), two point lights on the emitting ones."""
    g = np.random.default_rng(seed)
    b = SceneBuilder()
    for s in range(n_spheres):
        c = (g.uniform(-4, 4), g.uniform(-3, 3), g.uniform(-12, -3))
        kind = g.integers(0, 6)
        b.add_sphere(c, g.uniform(0.05, 0.8), tuple(g.uniform(0, 255, 3)),
                     reflective=1.0 if kind == 0 else g.uniform(0, 0.9),
                     transparent=1.0 if kind == 1 else 0.0,
                     emitive=1.0 if s < 2 else 0.0, ior=1.4, id=100 + s)
    for s in range(min(2, n_spheres)):
        b.add_point_light(100 + s, tuple(b.spheres[s].centre), (255, 255, 255),
                          strength=1.0, max_angle=1.5, func=s - 1)
    return b.build(device=device)


def termini(scene, n, seed, device, origin=(0.0, 0.5, 0.0), max_bounces=4):
    """Whitted termini of ``n`` seeded rays from ``origin``."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((n, 3), generator=g) * torch.tensor([0.5, 0.4, 1.0])
    d[:, 2] = -d[:, 2].abs()
    o = torch.tensor(origin).expand(n, 3).contiguous()
    eg, em = material_flags(scene)
    table = cuda_intersect.sphere_table(scene, eg, em)
    res = trace_whitted(scene, o.to(device), d.to(device), max_bounces,
                        impl="kernel" if device.type == "cuda" else "plain",
                        table=table)
    return res, table


def shade_both(scene, gl, pl, res, table, background, miss=None):
    """The kernel's colours and the plain route's, after one launch."""
    before = cuda_shade.whitted_shade.launches
    got = cuda_shade.whitted_shade(scene, gl, pl, res, background, miss,
                                   table)
    torch.cuda.synchronize()
    assert cuda_shade.whitted_shade.launches == before + 1
    want = terminal_rgb(scene, gl, pl, res, background, impl="plain",
                        table=table, miss_colour=miss)
    return got, want


def assert_bits(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        int((got != want).any(-1).sum()), float((got - want).abs().max()))


# -- CPU ----------------------------------------------------------------


def test_wrapper_on_cpu_runs_plain_without_a_launch():
    scene, gl, pl = edge_scene("cpu")
    res, table = termini(scene, 257, seed=1, device=torch.device("cpu"))
    before = (cuda_shade.whitted_shade.launches,
              cuda_intersect.nearest_hit.launches)
    for miss in (None, SKY):
        got = cuda_shade.whitted_shade(scene, gl, pl, res, (2, 2, 5), miss,
                                       table)
        want = terminal_rgb(scene, gl, pl, res, (2, 2, 5), impl="plain",
                            miss_colour=miss)
        assert torch.equal(got, want)
        routed = terminal_rgb(scene, gl, pl, res, (2, 2, 5), impl="kernel",
                              miss_colour=miss)
        assert torch.equal(routed, want)
    assert bool(res.hit.any()) and not bool(res.hit.all())
    assert (cuda_shade.whitted_shade.launches,
            cuda_intersect.nearest_hit.launches) == before


@pytest.mark.parametrize("case", ["f64", "point_shape", "idx_dtype",
                                  "hit_length", "spheres",
                                  "table_of_another_scene", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    scene, gl, pl = edge_scene("cpu")
    res, table = termini(scene, 16, seed=2, device=torch.device("cpu"))
    exc = ValueError
    if case == "f64":
        res, exc = dataclasses.replace(res, point=res.point.double(),
                                       normal=res.normal.double()), TypeError
    elif case == "point_shape":
        res = dataclasses.replace(res, point=torch.zeros((16, 4)))
    elif case == "idx_dtype":
        res = dataclasses.replace(res, idx=res.idx.long())
    elif case == "hit_length":
        res = dataclasses.replace(res, hit=torch.ones(17, dtype=torch.bool))
    elif case == "spheres":
        big = cuda_intersect.MAX_SPHERES + 1
        table = cuda_intersect.SphereTable(
            (table.spec[0],) * big, (False,) * big, (False,) * big,
            torch.zeros((big, 8)), torch.zeros(big, dtype=torch.int32))
    elif case == "table_of_another_scene":
        table = cuda_intersect.sphere_table(edge_scene("cpu", False)[0])
    elif case == "device":
        res = dataclasses.replace(res, point=res.point.to("meta"),
                                  normal=res.normal.to("meta"))
    before = cuda_shade.whitted_shade.launches
    with pytest.raises(exc):
        cuda_shade.whitted_shade(scene, gl, pl, res, (0, 0, 0), None, table)
    assert cuda_shade.whitted_shade.launches == before


def test_shadow_bounces_keep_the_trace_route(monkeypatch):
    """``shadow_max_bounces > 0`` traces the shadow rays (``trace_whitted``),
    never the shading kernel's sweep; 0 goes to the shading kernel."""
    scene, gl, pl = edge_scene("cpu")
    res, table = termini(scene, 129, seed=3, device=torch.device("cpu"))
    calls = []

    def spy(*args):
        calls.append(args)
        return cuda_shade.whitted_shade_plain(*args)

    monkeypatch.setattr(cuda_shade, "whitted_shade", spy)
    plain = terminal_rgb(scene, gl, pl, res, (1, 2, 3), 1, impl="plain")
    kernel = terminal_rgb(scene, gl, pl, res, (1, 2, 3), 1, impl="kernel")
    assert torch.equal(kernel, plain) and not calls
    terminal_rgb(scene, gl, pl, res, (1, 2, 3), 0, impl="kernel")
    assert len(calls) == 1


@pytest.mark.parametrize("name", ["planets2", "chandelier", "custom",
                                  "edges", "edges_plain", "mirror_only",
                                  "glass_only"])
def test_frame_shades_with_its_trace_table(name, monkeypatch):
    """``shade_flat`` hands its trace's table to the shading; under
    ``material_flags`` it equals a fresh ``sphere_table`` of the scene in
    every column, the mirror and glass ones included, with and without
    glass and mirrors in the scene."""
    if name.startswith("edges"):
        scene, gl, pl = edge_scene("cpu", name == "edges")
    elif name in ("mirror_only", "glass_only"):
        b = SceneBuilder()
        b.add_sphere((0.0, 0.0, -5.0), 1.0, reflective=float(
            name == "mirror_only"), transparent=float(name == "glass_only"),
            ior=1.5, id=1)
        b.add_sphere((0.0, 3.0, -5.0), 0.5, emitive=1.0, id=2)
        b.add_point_light(2, (0.0, 3.0, -5.0), (255, 255, 255))
        scene, gl, pl = b.build(device="cpu")
    else:
        scene, gl, pl, _ = getattr(library, name + "_scene")(device="cpu")
    seen = []

    def capture(*args, **kw):
        seen.append(kw["table"])
        return terminal_rgb(*args, **kw)

    monkeypatch.setattr(renderer, "terminal_rgb", capture)
    o, d, h, w = grid_rays(4, 0.2, 1, origin=(0.0, 0.5, 1.0), device="cpu")
    render_whitted(scene, gl, pl, o, d, h, w, max_bounces=3, impl="plain")
    fresh = cuda_intersect.sphere_table(scene)
    (table,) = seen
    assert torch.equal(table.spheres, fresh.spheres)
    assert torch.equal(table.ids, fresh.ids)
    assert (table.spec, table.mirror, table.glass) == (
        fresh.spec, fresh.mirror, fresh.glass)
    assert table.mirror == tuple(bool(v) for v in scene.reflective == 1.0)
    assert table.glass == tuple(bool(v) for v in scene.transparent == 1.0)


def test_counters_name_the_shading_launches():
    c = profiling.counters()
    assert c["launches.whitted_shade"] == cuda_shade.whitted_shade.launches


# -- card ---------------------------------------------------------------


@pytest.mark.cuda
def test_planets2_2001_on_two_eyes_equals_plain_on_card():
    dev = card()
    scene, gl, pl, p = library.planets2_scene(device=dev)
    eg, em = material_flags(scene)
    table = cuda_intersect.sphere_table(scene, eg, em)
    for eye in (p["camera_position"], (0.04, -0.03, 4.97)):
        o, d, h, w = grid_rays(p["ray_count"], p["ray_step"], p["multiple"],
                               origin=eye, device=dev)
        assert h * w == 2001 * 2001
        res = trace_whitted(scene, o, d, p["max_bounces"], impl="kernel",
                            table=table)
        for miss in (None, SKY):
            got, want = shade_both(scene, gl, pl, res, table,
                                   p["background"], miss)
            assert_bits(got, want)
        assert 0.1 < float(res.hit.float().mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["true_original", "custom", "marbles4",
                                  "training_scene_complete"])
def test_library_scenes_equal_plain_on_card(name):
    dev = card()
    if name == "training_scene_complete":
        from raytracer_tpu_torch.env.scenes import training_scene_complete
        scene, gl, pl = training_scene_complete(device=dev)
        res, table = termini(scene, 2048, seed=4, device=dev,
                             origin=(0.0, 0.0, 0.0), max_bounces=8)
        bg, miss = (0.0, 0.0, 0.0), None
    else:
        scene, gl, pl, p = getattr(library, name + "_scene")(device=dev)
        o, d, _, _ = grid_rays(60, p.get("ray_step", 0.01) * 100 / 60, 1,
                               origin=p["camera_position"], device=dev)
        eg, em = material_flags(scene)
        table = cuda_intersect.sphere_table(scene, eg, em)
        res = trace_whitted(scene, o, d, p["max_bounces"], impl="kernel",
                            table=table)
        bg, miss = p.get("background", (0, 0, 0)), p.get("sky_colour")
    got, want = shade_both(scene, gl, pl, res, table, bg, miss)
    assert_bits(got, want)
    assert bool(res.hit.any())
    if pl.count:
        assert bool((want > torch.tensor(bg, device=dev)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["R1", "R129", "misses_only",
                                  "light_sphere_termini", "no_global_light",
                                  "no_point_light", "no_lights",
                                  "one_sphere", "max_spheres"])
def test_edge_cases_equal_plain_on_card(case):
    dev = card()
    scene, gl, pl = edge_scene(dev)
    if case == "one_sphere":
        scene, gl, pl = random_scene(1, seed=5, device=dev)
    elif case == "max_spheres":
        scene, gl, pl = random_scene(cuda_intersect.MAX_SPHERES, seed=6,
                                     device=dev)
    res, table = termini(scene, 20_000, seed=7, device=dev)
    if case == "R1":
        res = dataclasses.replace(
            res, **{f: getattr(res, f)[int(res.hit.nonzero()[0]):][:1]
                    for f in ("hit", "idx", "point", "normal")})
    elif case == "R129":
        res = dataclasses.replace(res, **{f: getattr(res, f)[:129]
                                          for f in ("hit", "idx", "point",
                                                    "normal")})
    elif case == "misses_only":
        res = dataclasses.replace(res, hit=torch.zeros_like(res.hit))
    elif case == "light_sphere_termini":
        on_light = res.hit & (table.ids[res.idx] == 50)
        assert int(on_light.sum()) > 0
    if case in ("no_global_light", "no_lights"):
        gl = empty_global_lights(dev)
    if case in ("no_point_light", "no_lights"):
        pl = empty_point_lights(dev)
    got, want = shade_both(scene, gl, pl, res, table, (2.0, 2.0, 5.0), SKY)
    assert_bits(got, want)
    if case == "misses_only":
        assert bool((got == torch.tensor(SKY, device=dev)).all())


@pytest.mark.cuda
def test_render_grid_frame_equals_plain_route_on_card():
    """The CLI's and the benchmark cell's frame: one shading launch, one
    Whitted launch and no nearest-hit launch, the image the plain route's
    bit for bit."""
    dev = card()
    scene, gl, pl, p = library.planets2_scene(device=dev)
    render_grid(scene, gl, pl, p, device=dev)           # builds, warms up
    torch.cuda.synchronize()
    before = profiling.counters()
    img = render_grid(scene, gl, pl, p, eye=(0.02, 0.01, 5.03), device=dev)
    torch.cuda.synchronize()
    after = profiling.counters()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["launches.whitted_shade"] == 1
    assert delta["launches.whitted_trace"] == 1
    assert delta["launches.nearest_hit"] == 0
    o, d, h, w = grid_rays(p["ray_count"], p["ray_step"], p["multiple"],
                           origin=(0.02, 0.01, 5.03), device=dev)
    want = render_whitted(scene, gl, pl, o, d, h, w,
                          max_bounces=p["max_bounces"],
                          background=p["background"],
                          miss_colour=p.get("sky_colour"), impl="plain")
    assert_bits(img, want)
