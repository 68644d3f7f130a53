"""The path kernel's wrapper (raytracer_tpu_torch/core/cuda_path.py) and,
on a card, the kernel against its plain PyTorch version.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernel.py -m cuda
"""
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import cuda_path
from raytracer_tpu_torch.scene.library import chandelier_scene
from raytracer_tpu_torch.trace.path import trace_path


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
    scene, _ = chandelier_scene(device="cpu")
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
    scene, _ = chandelier_scene(device="cuda")
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
