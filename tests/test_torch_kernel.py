"""The kernels' wrappers (raytracer_tpu_torch/core/cuda_path.py,
cuda_level.py, cuda_whitted.py, cuda_intersect.py) and, on a card, each
kernel against its plain PyTorch version.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel.py -m cuda
"""
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import (cuda_intersect, cuda_level, cuda_path,
                                      cuda_whitted)
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.render.camera import grid_rays
from raytracer_tpu_torch.render.renderer import material_flags, render_whitted
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.scene.types import scene_astype
from raytracer_tpu_torch.tools import level_edges, sweep_edges
from raytracer_tpu_torch.trace.path import (emissive_indices, scene_spec,
                                            trace_path)
from raytracer_tpu_torch.trace.whitted import trace_whitted

TRACE_FIELDS = ("hit", "idx", "t", "point", "normal", "bounces", "through")


def _rays(n, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    o = torch.zeros((n, 3)) + torch.tensor([0.0, 2.0, 0.0])
    return o.to(device), torch.randn((n, 3), generator=g).to(device)


def _table(n_spheres=3, n_emissive=1, device="cpu"):
    spec = tuple((0.0, 0.0, -5.0 - i, 1.0, 200.0, 100.0, 50.0, 0.0, 0.0,
                  1.0 if i < n_emissive else 0.0, 1.0, i)
                 for i in range(n_spheres))
    return cuda_path.path_table(spec, tuple(range(n_emissive)), 0.9, device)


def test_kernel_impl_on_cpu_runs_plain_without_a_launch():
    scene, _, _, _ = chandelier_scene(device="cpu")
    o, d = _rays(301, seed=3)
    before = cuda_path.path_trace.launches
    k_rgb, k_st = trace_path(scene, o, d, max_bounces=4,
                             mirror_threshold=0.0, impl="kernel")
    p_rgb, p_st = trace_path(scene, o, d, max_bounces=4,
                             mirror_threshold=0.0, impl="plain")
    assert cuda_path.path_trace.launches == before
    assert torch.equal(k_rgb, p_rgb)
    assert k_st.as_dict() == p_st.as_dict()
    counts = cuda_path.path_trace(o, d, None, _table(), max_bounces=4,
                                  background=(2.0, 2.0, 5.0))[1]
    assert counts.dtype == torch.int32 and counts.shape == (301, 4)


@pytest.mark.parametrize("case", [
    "f64", "shape", "strided", "length", "uniform_shape", "uniform_dtype",
    "bounces", "spheres", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    R = 16
    o = torch.zeros((R, 3))
    d = torch.ones((R, 3))
    u, table, mb = None, _table(), 4
    exc = ValueError
    before = cuda_path.path_trace.launches
    if case == "f64":
        o, exc = o.double(), TypeError
    elif case == "shape":
        o = torch.zeros((R, 4))
    elif case == "strided":
        d = torch.ones((3, R)).t()
    elif case == "length":
        d = torch.ones((R + 1, 3))
    elif case == "uniform_shape":
        u = torch.zeros((mb + 1, R, 2))
    elif case == "uniform_dtype":
        u, exc = torch.zeros((mb, R, 2), dtype=torch.float64), TypeError
    elif case == "bounces":
        mb = cuda_path.MAX_BOUNCES + 1
    elif case == "spheres":
        table = _table(n_spheres=cuda_path.MAX_SPHERES + 1)
    elif case == "device":
        o, d = o.to("meta"), d.to("meta")
        table = _table(device="meta")
    with pytest.raises(exc):
        cuda_path.path_trace(o, d, u, table, max_bounces=mb,
                             background=(2.0, 2.0, 5.0))
    assert cuda_path.path_trace.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel vs plain version on the card, ragged 3601 rays: bit-equal
    without diffuse bounces; with them (mirror_threshold=0.9) within
    tests/test_pallas_path.py's bounds, >= 95% of subpixels equal and hit
    statistics within 2% (acosf/sinf/cosf may round differently in the two
    builds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    scene, _, _, _ = chandelier_scene(device="cuda")
    o, d = _rays(3601, seed=4, device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    for thr in (0.0, 0.9):
        u = (None if thr == 0.0 else
             torch.rand((6, 3601, 2), device="cuda", generator=g))
        kw = dict(max_bounces=6, mirror_threshold=thr, uniforms=u)
        before = cuda_path.path_trace.launches
        k_rgb, k_st = trace_path(scene, o, d, impl="kernel", **kw)
        p_rgb, p_st = trace_path(scene, o, d, impl="plain", **kw)
        torch.cuda.synchronize()
        assert cuda_path.path_trace.launches == before + 1
        k, p = k_rgb.cpu().numpy(), p_rgb.cpu().numpy()
        if thr == 0.0:
            np.testing.assert_array_equal(k, p)
            assert k_st.as_dict() == p_st.as_dict()
        else:
            assert (k == p).mean() >= 0.95
            for f in ("total_rays", "total_intersections", "light_hits"):
                a, b = int(getattr(p_st, f)), int(getattr(k_st, f))
                assert abs(a - b) <= max(0.02 * a, 2), f


def _whitted_case(name, device, ray_count=20):
    """A notebook scene and a coarse grid over its field of view."""
    scene, gl, pl, p = getattr(library, name + "_scene")(device=device)
    o, d, h, w = grid_rays(ray_count, p["ray_step"] * p["ray_count"]
                           / ray_count, 1, origin=p["camera_position"],
                           device=device)
    return scene, gl, pl, p, o, d, h, w


@pytest.mark.parametrize("case", [
    "f64", "shape", "strided", "length", "suppress_dtype", "suppress_shape",
    "spheres", "device", "bounces"])
def test_whitted_wrappers_reject_what_the_kernels_do_not_take(case):
    scene = _whitted_case("planets2", "cpu")[0]
    table = cuda_intersect.sphere_table(scene)
    R = 16
    o = torch.zeros((R, 3))
    d = torch.ones((R, 3))
    sup, mb, exc = None, 3, ValueError
    if case == "f64":
        o, exc = o.double(), TypeError
    elif case == "shape":
        o = torch.zeros((R, 4))
    elif case == "strided":
        d = torch.ones((3, R)).t()
    elif case == "length":
        d = torch.ones((R + 1, 3))
    elif case == "suppress_dtype":
        sup = torch.zeros(R, dtype=torch.int64)
    elif case == "suppress_shape":
        sup = torch.zeros(R + 1, dtype=torch.int32)
    elif case == "spheres":
        big = cuda_intersect.MAX_SPHERES + 1
        table = cuda_intersect.SphereTable(
            (table.spec[0],) * big, (False,) * big, (False,) * big,
            torch.zeros((big, 8)), torch.zeros(big, dtype=torch.int32))
    elif case == "device":
        o, d = o.to("meta"), d.to("meta")
    elif case == "bounces":
        mb = -1
    before = (cuda_whitted.whitted_trace.launches,
              cuda_intersect.nearest_hit.launches)
    with pytest.raises(exc):
        cuda_whitted.whitted_trace(o, d, sup, table, max_bounces=mb)
    if case != "bounces":
        with pytest.raises(exc):
            cuda_intersect.nearest_hit(o, d, sup, table)
    assert (cuda_whitted.whitted_trace.launches,
            cuda_intersect.nearest_hit.launches) == before


def test_whitted_kernel_impl_on_cpu_runs_plain_without_a_launch():
    scene, gl, pl, p, o, d, h, w = _whitted_case("marbles4", "cpu")
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p["sky_colour"])
    before = (cuda_whitted.whitted_trace.launches,
              cuda_intersect.nearest_hit.launches)
    a = render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)
    b = render_whitted(scene, gl, pl, o, d, h, w, impl="plain", **kw)
    c = render_whitted(scene, gl, pl, o, d, h, w, **kw)      # "auto"
    assert torch.equal(a, b) and torch.equal(a, c)
    assert a.shape == (h, w, 3) and a.dtype == torch.float32
    assert (cuda_whitted.whitted_trace.launches,
            cuda_intersect.nearest_hit.launches) == before
    with pytest.raises(TypeError, match="float32"):
        render_whitted(*(scene_astype(x, torch.float64)
                         for x in (scene, gl, pl)), o.double(), d.double(),
                       h, w, impl="kernel", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["true_original", "planets2", "marbles4",
                                  "chandelier"])
def test_whitted_kernels_match_plain_on_card(name):
    """Both Whitted kernels against their plain versions on the card:
    bit-equal traces (the camera entry, ids suppressed on every third ray
    and, for the shadow budget, a budget of 0), bit-equal nearest hits on
    both metrics and both hit tests, and bit-equal frames (impl="kernel"
    launching both kernels, and sweep="kernel")."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    if name == "chandelier":
        scene, gl, pl, p = chandelier_scene(device="cuda")
        g = torch.Generator("cuda").manual_seed(5)
        o = torch.zeros((3601, 3), device="cuda") + torch.tensor(
            p["camera_position"], dtype=torch.float32, device="cuda")
        d = torch.randn((3601, 3), device="cuda", generator=g)
        h, w = 1, 3601
    else:
        scene, gl, pl, p, o, d, h, w = _whitted_case(name, "cuda", 60)
    eg, em = material_flags(scene)
    table = cuda_intersect.sphere_table(scene, eg, em)
    i = torch.arange(o.shape[0], device="cuda")
    sup = torch.where(i % 3 == 0, table.ids[i % len(table.spec)],
                      NO_SUPPRESS).to(torch.int32)
    for s, mb in ((None, p["max_bounces"]), (sup, p["max_bounces"]),
                  (sup, 0)):
        before = cuda_whitted.whitted_trace.launches
        a = cuda_whitted.whitted_trace(o, d, s, table, max_bounces=mb)
        b = cuda_whitted.whitted_trace_plain(o, d, s, table, max_bounces=mb)
        torch.cuda.synchronize()
        assert cuda_whitted.whitted_trace.launches == before + 1
        for f in TRACE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    dn = torch.nn.functional.normalize(d, dim=1)
    for by_abs in (False, True):
        for fast in (False, True):
            a = cuda_intersect.nearest_hit(o, dn, sup, table, by_abs=by_abs,
                                           fast=fast)
            b = cuda_intersect.nearest_hit_plain(o, dn, sup, table,
                                                 by_abs=by_abs, fast=fast)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    kw = dict(max_bounces=p["max_bounces"], background=p["background"],
              miss_colour=p.get("sky_colour"))
    before = (cuda_whitted.whitted_trace.launches,
              cuda_intersect.nearest_hit.launches)
    img_k = render_whitted(scene, gl, pl, o, d, h, w, impl="kernel", **kw)
    img_p = render_whitted(scene, gl, pl, o, d, h, w, impl="plain", **kw)
    img_s = render_whitted(scene, gl, pl, o, d, h, w, impl="plain",
                           sweep="kernel", **kw)
    torch.cuda.synchronize()
    assert cuda_whitted.whitted_trace.launches == before[0] + 1
    assert cuda_intersect.nearest_hit.launches > before[1] or pl.count == 0
    assert torch.equal(img_k, img_p) and torch.equal(img_s, img_p)
    res = trace_whitted(scene, o, d, p["max_bounces"], enable_glass=eg,
                        enable_mirror=em, impl="kernel")
    assert bool(res.hit.any())


def _student(kind="one_hot", width=16, hidden_layers=2, seed=0,
             n_in=22, n_out=2):
    """A 22->width(->width)->2 student: ``one_hot`` (a0 = px through the
    hidden units, a1 = -nx; exact in any summation order) or ``random``."""
    from raytracer_tpu_torch.fb.distill import DistilledGuide
    dims = (n_in,) + (width,) * hidden_layers + (n_out,)
    rng = np.random.RandomState(seed)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        if kind == "random":
            k = (rng.randn(a, b) / np.sqrt(a)).astype(np.float32)
        else:
            k = np.zeros((a, b), np.float32)
            if i == 0:
                for j, c in enumerate((0, 1, 2, 6)):
                    k[c, j] = 1.0
            elif i < len(dims) - 2:
                k[np.arange(min(a, b)), np.arange(min(a, b))] = 1.0
            else:
                k[0, 0], k[3, 1] = 1.0, -1.0
        params[f"Dense_{i}"] = {"kernel": k,
                                "bias": np.zeros(b, np.float32)}
    return DistilledGuide(params, dims[1:-1])


@pytest.mark.parametrize("case", [
    "fb_missing", "fb_shape", "fb_dtype", "fb_device", "uniforms_missing",
    "wide_student", "deep_student", "obs_dim", "not_student"])
def test_guided_wrapper_rejects_what_the_kernel_does_not_take(case):
    R, mb = 16, 4
    o = torch.zeros((R, 3))
    d = torch.ones((R, 3))
    u = torch.zeros((mb, R, 2))
    f = torch.zeros((mb, R))
    guide = _student().as_guide_fn()
    exc = ValueError
    if case == "fb_missing":
        f = None
    elif case == "fb_shape":
        f = torch.zeros((mb, R + 1))
    elif case == "fb_dtype":
        f, exc = f.double(), TypeError
    elif case == "fb_device":
        f, exc = f.to("meta"), TypeError
    elif case == "uniforms_missing":
        u = None
    elif case == "wide_student":
        guide = _student(width=cuda_path.MAX_STUDENT_WIDTH + 1).as_guide_fn()
    elif case == "deep_student":
        guide = _student(hidden_layers=3).as_guide_fn()
    elif case == "obs_dim":
        guide = _student(n_in=21).as_guide_fn()
    elif case == "not_student":
        guide = lambda obs: obs[:, :2]                          # noqa: E731
    before = cuda_path.path_trace.launches
    with pytest.raises(exc):
        cuda_path.path_trace(o, d, u, _table(), max_bounces=mb,
                             background=(2.0, 2.0, 5.0), guide=guide,
                             fb_uniforms=f)
    assert cuda_path.path_trace.launches == before
    if case == "not_student":
        scene = chandelier_scene(device="cpu")[0]
        with pytest.raises(ValueError, match="student"):
            trace_path(scene, o, d, max_bounces=mb, impl="kernel",
                       guide_fn=guide, uniforms=u, fb_uniforms=f)


def test_guided_kernel_impl_on_cpu_runs_plain_without_a_launch():
    scene, _, _, _ = chandelier_scene(device="cpu")
    o, d = _rays(301, seed=5)
    g = torch.Generator().manual_seed(1)
    u = torch.rand((4, 301, 2), generator=g)
    f = torch.rand((4, 301), generator=g)
    guide = _student("random", width=24).as_guide_fn()
    kw = dict(max_bounces=4, mirror_threshold=0.9, uniforms=u,
              fb_uniforms=f, guide_fn=guide, fb_prob=0.7)
    before = (cuda_path.path_trace.launches, cuda_level.path_level.launches)
    k_rgb, k_st = trace_path(scene, o, d, impl="kernel", **kw)
    p_rgb, p_st = trace_path(scene, o, d, impl="plain", **kw)
    h_rgb, h_st = trace_path(scene, o, d, impl="hybrid", **kw)
    assert (cuda_path.path_trace.launches,
            cuda_level.path_level.launches) == before
    assert torch.equal(k_rgb, p_rgb) and torch.equal(h_rgb, p_rgb)
    assert k_st.as_dict() == p_st.as_dict() == h_st.as_dict()
    assert 0 < k_st.as_dict()["fb_used"]
    counts = cuda_path.path_trace(
        o, d, u, _table(), max_bounces=4, background=(2.0, 2.0, 5.0),
        guide=guide, fb_uniforms=f)[1]
    assert counts.dtype == torch.int32 and counts.shape == (301, 6)


@pytest.mark.parametrize("case", [
    "f64", "shape", "strided", "running_dtype", "running_shape", "u_shape",
    "u_dtype", "spheres", "device"])
def test_level_wrapper_rejects_what_the_kernel_does_not_take(case):
    R = 16
    o = torch.zeros((R, 3))
    d = torch.ones((R, 3))
    run = torch.ones(R, dtype=torch.bool)
    u, table, exc = None, _table(), ValueError
    if case == "f64":
        o, exc = o.double(), TypeError
    elif case == "shape":
        o = torch.zeros((R, 4))
    elif case == "strided":
        d = torch.ones((3, R)).t()
    elif case == "running_dtype":
        run, exc = torch.ones(R, dtype=torch.uint8), TypeError
    elif case == "running_shape":
        run = torch.ones(R + 1, dtype=torch.bool)
    elif case == "u_shape":
        u = torch.zeros((R, 3))
    elif case == "u_dtype":
        u, exc = torch.zeros((R, 2), dtype=torch.float64), TypeError
    elif case == "spheres":
        table = _table(n_spheres=cuda_path.MAX_SPHERES + 1)
    elif case == "device":
        o, d = o.to("meta"), d.to("meta")
        run, table = run.to("meta"), _table(device="meta")
    before = cuda_level.path_level.launches
    with pytest.raises(exc):
        cuda_level.path_level(o, d, run, u, table)
    assert cuda_level.path_level.launches == before


def test_level_on_cpu_is_plain_and_passes_idle_lanes_through():
    o, d = _rays(257, seed=6)
    d = torch.nn.functional.normalize(d, dim=1)
    run = torch.arange(257) % 3 != 0
    u = torch.rand((257, 2), generator=torch.Generator().manual_seed(2))
    table = _table(n_spheres=5, n_emissive=2)
    before = cuda_level.path_level.launches
    a = cuda_level.path_level(o, d, run, u, table, want_hit=True)
    b = cuda_level.path_level_plain(o, d, run, u, table, want_hit=True)
    assert cuda_level.path_level.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    idle = ~run
    assert (a.state[idle] == 0).all() and (a.rec[idle] == 0).all()
    assert torch.equal(a.o_next[idle], o[idle])
    assert torch.equal(a.d_next[idle], d[idle])
    cont = (a.state & cuda_level.ST_CONT) != 0
    assert (a.hit[~cont] == 0).all() and a.hit.shape == (257, 11)


@pytest.mark.cuda
def test_guided_and_level_kernels_match_plain_on_card():
    """On the card: the guided kernel equals its plain version bit for bit
    with a one-hot 22->128->128->2 student (f32 and bf16), and a random
    student within tests/test_pallas_path.py:149-181's bounds (>= 90% of
    samples equal, light hits within 0.9-1.12x); the level kernel equals
    path_level_plain bit for bit; the hybrid equals the whole-trace kernel
    with the one-hot student."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    scene, _, _, _ = chandelier_scene(device="cuda")
    o, d = _rays(3601, seed=7, device="cuda")
    g = torch.Generator("cuda").manual_seed(3)
    u = torch.rand((6, 3601, 2), device="cuda", generator=g)
    f = torch.rand((6, 3601), device="cuda", generator=g)
    kw = dict(max_bounces=6, mirror_threshold=0.9, uniforms=u,
              fb_uniforms=f, fb_prob=1.0)
    for kind in ("one_hot", "random"):
        for dtype in (None, "auto"):
            guide = _student(kind, width=128).as_guide_fn(dtype=dtype)
            before = cuda_path.path_trace.launches
            k_rgb, k_st = trace_path(scene, o, d, impl="kernel",
                                     guide_fn=guide, **kw)
            p_rgb, p_st = trace_path(scene, o, d, impl="plain",
                                     guide_fn=guide, **kw)
            h_rgb, h_st = trace_path(scene, o, d, impl="hybrid",
                                     guide_fn=guide, **kw)
            torch.cuda.synchronize()
            assert cuda_path.path_trace.launches == before + 1
            k, p = k_rgb.cpu().numpy(), p_rgb.cpu().numpy()
            assert k_st.as_dict()["fb_used"] > 0
            if kind == "one_hot":
                np.testing.assert_array_equal(k, p)
                np.testing.assert_array_equal(h_rgb.cpu().numpy(), k)
                assert k_st.as_dict() == p_st.as_dict() == h_st.as_dict()
            else:
                assert (k == p).all(-1).mean() >= 0.9
                a, b = int(k_st.light_hits), int(p_st.light_hits)
                assert a == b or (b > 0 and 0.9 <= a / b <= 1.12)
    dn = torch.nn.functional.normalize(d, dim=1)
    run = torch.rand(3601, device="cuda", generator=g) < 0.8
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.9, "cuda")
    for uu, want_hit in ((u[0], True), (None, False)):
        before = cuda_level.path_level.launches
        a = cuda_level.path_level(o, dn, run, uu, table, want_hit=want_hit)
        b = cuda_level.path_level_plain(o, dn, run, uu, table,
                                        want_hit=want_hit)
        torch.cuda.synchronize()
        assert cuda_level.path_level.launches == before + 1
        assert all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(a, b))


@pytest.mark.cuda
def test_tensor_core_route_edge_cases_match_plain_on_card():
    """On the card, the bf16 students' tensor-core route
    (csrc/path_guided.cu): one-hot students bit for bit against the plain
    version, and the hybrid equal to the whole trace, on a ragged ray count,
    at fb_prob 0.5 (warps holding every number of guided lanes), with one
    hidden layer and at width 24 (not a multiple of 16); seeded dense
    students within tests/test_pallas_path.py:149-181's bounds; at
    fb_prob 0 the route equals the unguided kernel on the same uniforms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    scene, _, _, _ = chandelier_scene(device="cuda")
    o, d = _rays(3601, seed=8, device="cuda")
    g = torch.Generator("cuda").manual_seed(4)
    u = torch.rand((6, 3601, 2), device="cuda", generator=g)
    f = torch.rand((6, 3601), device="cuda", generator=g)
    kw = dict(max_bounces=6, mirror_threshold=0.9, uniforms=u,
              fb_uniforms=f)
    cases = [("one_hot", 128, 2, 1.0), ("one_hot", 128, 2, 0.5),
             ("one_hot", 128, 1, 0.5), ("one_hot", 24, 2, 0.5),
             ("random", 128, 1, 0.5), ("random", 24, 2, 1.0)]
    for kind, width, layers, fb_prob in cases:
        guide = _student(kind, width=width, hidden_layers=layers
                         ).as_guide_fn()
        assert cuda_path.guided_route(guide) == "bf16_mma"
        before = cuda_path.path_trace.route_launches["bf16_mma"]
        k_rgb, k_st = trace_path(scene, o, d, impl="kernel", guide_fn=guide,
                                 fb_prob=fb_prob, **kw)
        p_rgb, p_st = trace_path(scene, o, d, impl="plain", guide_fn=guide,
                                 fb_prob=fb_prob, **kw)
        torch.cuda.synchronize()
        assert cuda_path.path_trace.route_launches["bf16_mma"] == before + 1
        k, p = k_rgb.cpu().numpy(), p_rgb.cpu().numpy()
        assert k_st.as_dict()["fb_used"] > 0, (kind, width, layers)
        if kind == "one_hot":
            h_rgb, h_st = trace_path(scene, o, d, impl="hybrid",
                                     guide_fn=guide, fb_prob=fb_prob, **kw)
            np.testing.assert_array_equal(k, p)
            np.testing.assert_array_equal(h_rgb.cpu().numpy(), k)
            assert k_st.as_dict() == p_st.as_dict() == h_st.as_dict()
        else:
            assert (k == p).all(-1).mean() >= 0.9
            a, b = int(k_st.light_hits), int(p_st.light_hits)
            assert a == b or (b > 0 and 0.9 <= a / b <= 1.12)
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 0.9, "cuda")
    tkw = dict(max_bounces=6, background=(2.0, 2.0, 5.0))
    rgb0, cnt0 = cuda_path.path_trace(o, d, u, table, guide=guide,
                                      fb_uniforms=f, fb_prob=0.0, **tkw)
    rgb_u, cnt_u = cuda_path.path_trace(o, d, u, table, **tkw)
    assert torch.equal(rgb0, rgb_u) and torch.equal(cnt0[:, :4], cnt_u)
    assert not cnt0[:, 4:].any()


@pytest.mark.cuda
def test_level_edges_match_plain_on_card():
    """On the card, on seeded scenes built to cross the shared level's
    exact rewrites (tools/level_edges.py: radii with T(r) != fl(r*r) and
    rays grazing them, lights whose cut passes through the hit points,
    grazing normals): the unguided path kernel equals its plain version bit
    for bit at mirror_threshold 0 (exact and fast) and within
    test_kernel_matches_plain_on_card's diffuse bounds at 0.9; the level
    kernel equals path_level_plain level by level on the same inputs; the
    hybrid equals the whole-trace kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    for seed in (30, 31):
        scene, o, d = level_edges.edge_scene(seed, 20_000, "cuda")
        R = o.shape[0]
        u = torch.rand((6, R, 2), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))
        for thr, fast, uu in ((0.0, False, None), (0.0, True, None),
                              (0.9, False, u)):
            table = cuda_path.path_table(scene_spec(scene),
                                         emissive_indices(scene), thr, "cuda")
            kw = dict(max_bounces=6, background=(2.0, 2.0, 5.0), fast=fast)
            before = cuda_path.path_trace.launches
            rk, ck = cuda_path.path_trace(o, d, uu, table, **kw)
            rp, cp = cuda_path.path_trace_plain(o, d, uu, table, **kw)
            levels = []

            def checked(lo, ld, lrun, lu, ltable, **lkw):
                a = cuda_level.path_level(lo, ld, lrun, lu, ltable, **lkw)
                b = cuda_level.path_level_plain(lo, ld, lrun, lu, ltable,
                                                **lkw)
                levels.append(all(torch.equal(x, y) for x, y in zip(a, b)
                                  if x is not None))
                return a

            before_level = cuda_level.path_level.launches
            rh, ch = cuda_path.trace_levels(checked, o, d, uu, table, **kw)
            torch.cuda.synchronize()
            assert cuda_path.path_trace.launches == before + 1
            assert cuda_level.path_level.launches == before_level + 6
            assert levels == [True] * 6, (seed, thr, fast, levels)
            assert torch.equal(rh, rk) and torch.equal(ch, ck)
            k, p = rk.cpu().numpy(), rp.cpu().numpy()
            if thr == 0.0:
                np.testing.assert_array_equal(k, p)
                assert torch.equal(ck, cp)
            else:
                assert (k == p).mean() >= 0.95
                a, b = ck.sum(0).tolist(), cp.sum(0).tolist()
                assert all(abs(x - y) <= max(0.02 * y, 2)
                           for x, y in zip(a, b)), (a, b)


@pytest.mark.cuda
def test_sweep_edges_match_plain_on_card():
    """On the card, on seeded ray sets built to cross the sweep's exact
    rewrites (tools/sweep_edges.py: d2 in (fl(r*r), T(r)] and one float
    above, tca at +-0 and at subnormals, equal metrics, the nearest sphere
    suppressed, origins inside, NaN and infinite components; every edge
    crossed), a ragged count and a view 12 bytes off 16-byte alignment,
    and the chandelier's camera rays: the nearest-hit kernel equals
    nearest_hit_plain bit for bit in all four modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    table, o, d, sup = sweep_edges.edge_case(40, 40_000, "cuda")
    assert all(v > 0 for v in
               sweep_edges.edge_counts(o, d, sup, table).values())
    l_table, l_o, l_d = sweep_edges.level_rays("cuda", 41, 200, 150, 2)
    cases = [(o, d, sup, table), (o[:3601], d[:3601], sup[:3601], table),
             (o[1:], d[1:], sup[1:], table),      # 12 and 4 bytes off
             (l_o, l_d, None, l_table)]
    before = cuda_intersect.nearest_hit.launches
    for co, cd, cs, ct in cases:
        for by_abs in (False, True):
            for fast in (False, True):
                a = cuda_intersect.nearest_hit(co, cd, cs, ct, by_abs=by_abs,
                                               fast=fast)
                b = cuda_intersect.nearest_hit_plain(co, cd, cs, ct,
                                                     by_abs=by_abs, fast=fast)
                assert all(torch.equal(x, y) for x, y in zip(a, b)), (
                    co.shape, by_abs, fast)
    torch.cuda.synchronize()
    assert cuda_intersect.nearest_hit.launches == before + 4 * len(cases)


def _agent_trace_inputs(R=3601, levels=6):
    """The chandelier on the card, a narrow seeded FB agent (z 8, encoder
    32, backward 16) and seeded rays and draws for a guided stepwise
    trace."""
    scene, _, _, p = chandelier_scene(device="cuda")
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           p["camera_position"],
                           config=FBConfig(z_dim=8, e_hidden_dim=32,
                                           f_hidden_dim=32, b_hidden_dim=16),
                           seed=1, device="cuda")
    o, d = _rays(R, seed=11, device="cuda")
    g = torch.Generator("cuda").manual_seed(5)
    kw = dict(max_bounces=levels, mirror_threshold=0.9,
              uniforms=torch.rand((levels, R, 2), device="cuda",
                                  generator=g),
              fb_uniforms=torch.rand((levels, R), device="cuda",
                                     generator=g),
              fb_prob=0.8, guide_fn=agent.as_guide_fn())
    return scene, o, d, kw


@pytest.mark.cuda
def test_stepwise_kernel_sweep_equals_plain_sweep_on_card(monkeypatch):
    """On the card: trace_path(impl="stepwise") launches the nearest-hit
    kernel once a level, and equals the same trace with
    nearest_hit_plain as its sweep bit for bit, image and all six counts,
    guided by a narrow seeded FB agent, at every guide level and with
    guide_max_level=2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    scene, o, d, kw = _agent_trace_inputs()
    for gml in (None, 2):
        before = cuda_intersect.nearest_hit.launches
        k_rgb, k_st = trace_path(scene, o, d, impl="stepwise",
                                 guide_max_level=gml, **kw)
        torch.cuda.synchronize()
        assert cuda_intersect.nearest_hit.launches == before + 6
        with monkeypatch.context() as m:
            m.setattr(cuda_intersect, "nearest_hit",
                      cuda_intersect.nearest_hit_plain)
            p_rgb, p_st = trace_path(scene, o, d, impl="stepwise",
                                     guide_max_level=gml, **kw)
        torch.cuda.synchronize()
        assert cuda_intersect.nearest_hit.launches == before + 6
        assert torch.equal(k_rgb, p_rgb)
        assert k_st.as_dict() == p_st.as_dict()
        assert k_st.as_dict()["fb_used"] > 0


@pytest.mark.cuda
def test_stepwise_equals_hybrid_with_an_agent_on_card():
    """On the card, with a narrow seeded FB agent: the stepwise trace (the
    nearest-hit kernel a level) equals the hybrid (the level kernel a
    level) bit for bit, and with guide_max_level=3 equals the hybrid whose
    fb plane is 2.0 (never below fb_prob) from level 3 on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    scene, o, d, kw = _agent_trace_inputs()
    s_rgb, s_st = trace_path(scene, o, d, impl="stepwise", **kw)
    h_rgb, h_st = trace_path(scene, o, d, impl="hybrid", **kw)
    torch.cuda.synchronize()
    assert torch.equal(s_rgb, h_rgb)
    assert s_st.as_dict() == h_st.as_dict()
    f3 = kw["fb_uniforms"].clone()
    f3[3:] = 2.0
    s3, st3 = trace_path(scene, o, d, impl="stepwise", guide_max_level=3,
                         **kw)
    h3, sh3 = trace_path(scene, o, d, impl="hybrid",
                         **dict(kw, fb_uniforms=f3))
    torch.cuda.synchronize()
    assert torch.equal(s3, h3) and st3.as_dict() == sh3.as_dict()
    assert 0 < int(st3.fb_used) < int(s_st.fb_used)


@pytest.mark.cuda
def test_distill_shooting_kernel_equals_plain_on_card(monkeypatch):
    """On the card: the distillation's observation walk and its shooting
    (``light_hit_weights``, ``hindsight_aim_targets``) launch the
    nearest-hit kernel and equal the same with ``nearest_hit_plain`` as
    the sweep, bit for bit, under a narrow seeded agent's actions and
    exact aims at the small lights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    from raytracer_tpu_torch.fb import distill
    from raytracer_tpu_torch.trace.sampling import direction_to_action
    dev = torch.device("cuda")
    scene, _, _, p = chandelier_scene(device=dev)
    agent = TrainedFBAgent(None, scene, small_light_indices(scene),
                           p["camera_position"],
                           config=FBConfig(z_dim=8, e_hidden_dim=32,
                                           f_hidden_dim=32, b_hidden_dim=16),
                           seed=1, device=dev)
    guide = agent.as_guide_fn()
    kw = dict(width=48, height=24, spp=2, frames=2, device=dev,
              camera_position=p["camera_position"])

    def run():
        obs = distill.collect_observations(
            scene, guide, generator=torch.Generator(dev).manual_seed(3),
            **kw)
        acts = np.clip(distill._chunked(guide, obs, dev), -1, 1)
        small = small_light_indices(scene)
        rows = np.arange(0, obs.shape[0], 3)
        centre = scene.centre[torch.from_numpy(small[rows % len(small)])
                              .to(dev)]
        pt = torch.from_numpy(obs[rows, 0:3]).to(dev)
        aim = (centre - pt) / (centre - pt).norm(dim=-1, keepdim=True)
        acts[rows] = direction_to_action(
            aim, torch.from_numpy(obs[rows, 6:9]).to(dev),
            convention="renderer").cpu().numpy()
        return (obs, distill.light_hit_weights(scene, obs, acts, device=dev),
                *distill.hindsight_aim_targets(scene, obs, acts, device=dev))

    before = cuda_intersect.nearest_hit.launches
    k = run()
    torch.cuda.synchronize()
    assert cuda_intersect.nearest_hit.launches == before + 2 * 8 + 2
    with monkeypatch.context() as m:
        m.setattr(cuda_intersect, "nearest_hit",
                  cuda_intersect.nearest_hit_plain)
        pl = run()
    assert cuda_intersect.nearest_hit.launches == before + 18
    for a, b in zip(k, pl):
        np.testing.assert_array_equal(a, b)
    assert (k[1] == 19.0).sum() > 0 and k[0].shape[0] > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["traditional", "rl", "fb"])
def test_output5_kernel_sweep_equals_plain_on_card(method):
    """On the card: ``trace_output5`` with the nearest-hit kernel as each
    level's sweep equals it with ``nearest_hit_plain``, image and stats,
    on the same planes (the experiment's fast_mode grid, 3 bounces)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_kernel.py "
                    "-m cuda")
    from raytracer_tpu_torch.trace.output5_style import (draw_planes,
                                                         trace_output5)
    dev = torch.device("cuda")
    scene, _, _, _ = library.custom_scene(device=dev)
    o, d, _, _ = grid_rays(100, 0.01, 1, origin=(0, 0, 1), device=dev)
    u, g = draw_planes(method, 3, o.shape[0],
                       torch.Generator(dev).manual_seed(4), dev)
    kw = dict(max_bounces=3, method=method, uniforms=u, glass_uniforms=g)
    before = cuda_intersect.nearest_hit.launches
    rk, sk = trace_output5(scene, o, d, impl="kernel", **kw)
    torch.cuda.synchronize()
    assert cuda_intersect.nearest_hit.launches == before + 3
    rp, sp = trace_output5(scene, o, d, impl="plain", **kw)
    assert torch.equal(rk, rp)
    assert {k: float(v) for k, v in sk.items()} == \
        {k: float(v) for k, v in sp.items()}
