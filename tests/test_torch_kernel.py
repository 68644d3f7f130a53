"""The kernels' wrappers (raytracer_tpu_torch/core/cuda_path.py,
cuda_whitted.py, cuda_intersect.py) and, on a card, each kernel against its
plain PyTorch version.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel.py -m cuda
"""
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import cuda_intersect, cuda_path, cuda_whitted
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS
from raytracer_tpu_torch.render.camera import grid_rays
from raytracer_tpu_torch.render.renderer import material_flags, render_whitted
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.scene.types import scene_astype
from raytracer_tpu_torch.trace.path import trace_path
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
