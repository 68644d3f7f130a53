"""Port (raytracer_tpu_torch) scene tables, scene statics and camera held
against the JAX package: all exact.

Data crosses between the packages as numpy arrays; JAX inputs are built
with explicit float32 dtypes (conftest turns on 64-bit mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render.camera import perspective_rays as jax_perspective
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.trace import path as jax_path
from raytracer_tpu_torch.core.device import resolve_device
from raytracer_tpu_torch.render.camera import perspective_rays
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.types import (SceneBuilder, scene_astype,
                                             scene_from_numpy, scene_to_numpy)
from raytracer_tpu_torch.trace import path as port_path

from test_path import _lean_scene


def jax_scene_numpy(scene):
    return {f.name: np.asarray(getattr(scene, f.name))
            for f in dataclasses.fields(scene)}


def port_scene(jax_scene):
    """The JAX scene's table as the port's CPU ``Scene``."""
    return scene_from_numpy(jax_scene_numpy(jax_scene), device="cpu")


def test_chandelier_table_equals_jax():
    js, _, _, jp = jax_library.chandelier_scene()
    ts, _, _, tp = library.chandelier_scene(device="cpu")
    want = jax_scene_numpy(js)
    got = scene_to_numpy(ts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tp == jp


def test_builder_and_numpy_round_trip():
    b = SceneBuilder()
    b.add_sphere((0.1, -0.2, 0.3), 0.7, (1, 2, 3), reflective=0.5,
                 transparent=0.25, emitive=1.0, ior=1.33, id=9)
    s, _, _ = b.build(device="cpu")
    assert s.num_spheres == 1 and s.id.dtype == torch.int32
    assert s.centre.dtype == torch.float32
    back = scene_from_numpy(scene_to_numpy(s), device="cpu")
    for k, v in scene_to_numpy(back).items():
        np.testing.assert_array_equal(v, scene_to_numpy(s)[k])
    assert scene_astype(s, torch.float64).radius.dtype == torch.float64
    with pytest.raises(ValueError, match="float32"):
        scene_from_numpy({**scene_to_numpy(s),
                          "radius": np.zeros(1, np.float64)}, device="cpu")


@pytest.mark.parametrize("threshold", [0.0, 0.9])
@pytest.mark.parametrize("which", ["chandelier", "lean"])
def test_scene_statics_equal_jax(which, threshold):
    js = (jax_library.chandelier_scene()[0] if which == "chandelier"
          else _lean_scene())
    ts = port_scene(js)
    assert port_path.scene_spec(ts) == jax_path.scene_spec(js)
    assert port_path.emissive_indices(ts) == jax_path.emissive_indices(js)
    assert (port_path.no_diffuse_possible(ts, threshold)
            == jax_path.no_diffuse_possible(js, threshold))


@pytest.mark.parametrize("jittered", [False, True])
@pytest.mark.parametrize("size", [(40, 20), (37, 23)])
def test_perspective_rays_equal_jax_x64_off(size, jittered):
    """Exact against the JAX camera with 64-bit mode off, as it runs on its
    TPU (with 64-bit mode on, JAX's directions come out float64)."""
    w, h = size
    sxy = (np.random.default_rng(1).random((h, w, 2), dtype=np.float32)
           if jittered else None)
    with jax.enable_x64(False):
        jo, jd = jax_perspective(
            w, h, fov=60.0, origin=(0.0, 2.0, 0.0), variant="fb",
            sample_xy=None if sxy is None else jnp.asarray(sxy),
            dtype=jnp.float32)
        jo, jd = np.asarray(jo), np.asarray(jd)
    to, td = perspective_rays(
        w, h, fov=60.0, origin=(0.0, 2.0, 0.0),
        sample_xy=None if sxy is None else torch.from_numpy(sxy),
        device="cpu")
    assert jd.dtype == np.float32 and td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(to.numpy(), jo)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No card and no device="cpu": raise, never run on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        library.chandelier_scene()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        perspective_rays(4, 2)
    scene, _, _, _ = library.chandelier_scene(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_path(scene, width=4, height=2, spp=1,
                    generator=torch.Generator().manual_seed(0))
    assert resolve_device("cpu") == torch.device("cpu")
    o, d = perspective_rays(4, 2, device="cpu")
    assert o.device.type == "cpu" and d.shape == (8, 3)
