"""The port's multi-device renders (raytracer_tpu_torch/parallel/mesh.py) on
eight CPU "devices" (``make_mesh(devices=["cpu"] * 8)``), held against
JAX's raytracer_tpu/parallel/mesh.py on ``make_mesh(8)`` over the eight
host devices tests/conftest.py gives JAX, and against the port's own
unsharded renders.

Every case takes a ray, frame or sample count that its dp does not
divide, so the edge padding runs in both packages.  JAX runs op by op
(``jax.disable_jit``, 64-bit mode off) where the bound is bit for bit: the
port rounds once per written operation as JAX does then
(tests/test_torch_render.py's module note).

* ``shard_rays``: the padded shards equal JAX's padded array;
* ``render_whitted_sharded`` (true_original, 121 rays over 8 shards) and
  ``render_whitted_frames_sharded`` (5 frames over 8): equal to the
  port's unsharded render bit for bit; to JAX's, bit for bit for the
  single frame and within one float32 ulp for the frames (JAX's
  ``shard_map`` run op by op takes minutes, so it runs jitted, where XLA
  multiplies by 1/255: tests/test_torch_animation.py's bound);
* ``render_path_sharded`` with ``impl="stepwise"`` (chandelier 13x5@2/3,
  130 samples padded to 136) on JAX's draws: the jitter from ``k_jit`` and
  the trace planes over the padded wavefront from ``k_trace`` (``k_jit,
  k_trace = split(key)``).  The image and the summed stats, padding rays
  included, equal JAX's; the image equals the port's unsharded render on
  the planes' first 130 rows;
* a guided dp x tp render (dp 4, tp 2; the seeded small ``FBConfig`` of
  tests/test_properties.py:115-139, saved by JAX and read by the port):
  ``shard_fb_params`` splits the same kernels as JAX's does; against JAX's
  jitted sharded render every subpixel within 1e-5 (JAX's own bound,
  sharded against unsharded; measured 1.5e-8) and the summed stats equal; against the port's
  unsharded render within 1e-5, ``fb_used`` at least its own (the
  padding rays add theirs).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.config import FBConfig as JaxConfig
from raytracer_tpu.fb.inference import TrainedFBAgent as JaxAgent
from raytracer_tpu.fb.inference import small_light_indices as jax_small
from raytracer_tpu.parallel import mesh as jax_mesh
from raytracer_tpu.scene import library as jax_library
from raytracer_tpu.utils.checkpoint import save_fb
from raytracer_tpu_torch.fb.config import FBConfig
from raytracer_tpu_torch.fb.inference import (TrainedFBAgent,
                                              small_light_indices)
from raytracer_tpu_torch.fb.networks import Dense
from raytracer_tpu_torch.parallel import mesh as pmesh
from raytracer_tpu_torch.render.animation import (camera_path_rays,
                                                  orbit_eyes,
                                                  render_whitted_frames)
from raytracer_tpu_torch.render.camera import grid_rays
from raytracer_tpu_torch.render.path_renderer import render_path
from raytracer_tpu_torch.render.renderer import render_whitted

from test_torch_guided import jax_planes
from test_torch_scene import one_torch_thread, port_scene  # noqa: F401
from test_torch_whitted import to_port

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU8 = ["cpu"] * 8
STATS = ("total_rays", "total_intersections", "light_hits",
         "small_light_hits", "fb_used", "fb_success")


def test_make_mesh_and_shard_rays():
    m = pmesh.make_mesh(devices=CPU8, tp=2)
    assert m.shape == {"dp": 4, "tp": 2} and len(m.rows) == 4
    assert pmesh.make_mesh(4, devices=CPU8).shape == {"dp": 4, "tp": 1}
    assert m.shape == dict(jax_mesh.make_mesh(8, tp=2).shape)
    with pytest.raises(ValueError):
        pmesh.make_mesh(devices=CPU8, tp=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh()
    a = np.arange(21.0, dtype=np.float32).reshape(7, 3)
    (shards,), n0 = pmesh.shard_rays(pmesh.make_mesh(devices=CPU8),
                                     torch.from_numpy(a))
    (want,), jn0 = jax_mesh.shard_rays(jax_mesh.make_mesh(8),
                                       jnp.asarray(a))
    assert n0 == jn0 == 7 and len(shards) == 8
    np.testing.assert_array_equal(torch.cat(shards).numpy(),
                                  np.asarray(want))


def _jax_true_original():
    js, jgl, jpl, p = jax_library.true_original_scene()
    return (js, jgl, jpl), to_port(js, jgl, jpl), p


def test_whitted_sharded_equals_unsharded():
    jsc, (scene, gl, pl), p = _jax_true_original()
    o, d, h, w = grid_rays(11, p["ray_step"] * p["ray_count"] / 11,
                           origin=p["camera_position"], device="cpu")
    assert o.shape[0] % 8                      # padding needed
    kw = dict(max_bounces=p["max_bounces"], background=p["background"])
    want = render_whitted(scene, gl, pl, o, d, h, w, **kw)
    got = pmesh.render_whitted_sharded(pmesh.make_mesh(devices=CPU8), scene,
                                       gl, pl, o, d, h, w, **kw)
    assert torch.equal(got, want)
    with jax.enable_x64(False), jax.disable_jit():
        jgot = jax_mesh.render_whitted_sharded(
            jax_mesh.make_mesh(8), *jsc, jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()), h, w, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_whitted_frames_sharded_equals_frames():
    jsc, (scene, gl, pl), p = _jax_true_original()
    target = (0.0, 0.0, 0.0)
    o, d = camera_path_rays(orbit_eyes(target, 3.0, 0.5, 5, device="cpu"),
                            target, 8, 6)
    kw = dict(max_bounces=p["max_bounces"], background=p["background"])
    want = render_whitted_frames(scene, gl, pl, o, d, 6, 8, **kw)
    got = pmesh.render_whitted_frames_sharded(pmesh.make_mesh(devices=CPU8),
                                              scene, gl, pl, o, d, 6, 8,
                                              **kw)
    assert got.shape == (5, 6, 8, 3) and torch.equal(got, want)
    assert not torch.equal(got[0], got[4])
    # Jitted (shard_map run op by op takes minutes): XLA multiplies by
    # 1/255, one float32 ulp (tests/test_torch_animation.py).
    with jax.enable_x64(False):
        jgot = jax_mesh.render_whitted_frames_sharded(
            jax_mesh.make_mesh(8), *jsc, jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()), 6, 8, **kw)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(jgot), maxulp=1)


def jax_sharded_planes(key, spp, h, w, max_bounces, dp):
    """JAX ``render_path_sharded``'s draws: ``k_jit, k_trace =
    split(key)``; the jitter from ``k_jit``, the trace planes from
    ``k_trace`` over the wavefront padded to a multiple of ``dp``."""
    k_jit, k_trace = jax.random.split(key)
    R = spp * h * w
    jit = np.array(jax.random.uniform(k_jit, (spp, h, w, 2), jnp.float32))
    u, fb = jax_planes(k_trace, max_bounces, R + (-R) % dp)
    return dict(jitter=torch.from_numpy(jit), uniforms=torch.from_numpy(u),
                fb_uniforms=torch.from_numpy(fb))


def jax_sharded_path(mesh, js, key, guide_fn=None, eager=True, **kw):
    with jax.enable_x64(False), jax.disable_jit(eager):
        img, st = jax_mesh.render_path_sharded(mesh, js, key,
                                               guide_fn=guide_fn, **kw)
        return np.asarray(img), {s: int(getattr(st, s)) for s in STATS}


def _path_case(spp):
    js, _, _, p = jax_library.chandelier_scene()
    return js, port_scene(js), dict(
        width=13, height=5, spp=spp, max_bounces=3,
        camera_position=p["camera_position"], background=p["background"],
        impl="stepwise")


def test_path_sharded_stepwise_equals_unsharded():
    js, scene, kw = _path_case(spp=2)
    key = jax.random.key(7)
    planes = jax_sharded_planes(key, 2, 5, 13, 3, dp=8)
    assert planes["uniforms"].shape[1] == 136            # 130 padded
    planes["fb_uniforms"] = None
    out, ost = pmesh.render_path_sharded(pmesh.make_mesh(devices=CPU8),
                                         scene, **planes, **kw)
    want, wst = jax_sharded_path(jax_mesh.make_mesh(8), js, key, **kw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert ost.as_dict() == wst
    assert wst["total_rays"] >= 136 and wst["total_intersections"] > 0
    ref, _ = render_path(scene, device="cpu", jitter=planes["jitter"],
                         uniforms=planes["uniforms"][:, :130], **kw)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="padded"):
        pmesh.render_path_sharded(
            pmesh.make_mesh(devices=["cpu"] * 3), scene, **planes, **kw)


def _kernel_paths(params, prefix=""):
    """The flax paths of a JAX param tree's kernels, each with whether
    its last axis is split over ``tp``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_kernel_paths(v, f"{prefix}{k}."))
        elif k == "kernel":
            out[prefix[:-1]] = "tp" in tuple(v.sharding.spec)
    return out


def test_path_sharded_guided_dp_tp(tmp_path):
    js, scene, kw = _path_case(spp=2)
    cfg = dict(z_dim=32, e_hidden_dim=256, f_hidden_dim=256,
               b_hidden_dim=128)
    p = jax_library.chandelier_scene()[3]
    ja = JaxAgent(None, js, jax_small(js), p["camera_position"],
                  config=JaxConfig(**cfg), seed=0)
    path = tmp_path / "small.npz"
    save_fb(path, types.SimpleNamespace(target_encoder=ja.params["encoder"],
                                        **ja.params), JaxConfig(**cfg))
    fb = TrainedFBAgent(str(path), scene, small_light_indices(scene),
                        p["camera_position"], config=FBConfig(**cfg),
                        device="cpu")
    key = jax.random.key(11)
    planes = jax_sharded_planes(key, 2, 5, 13, 3, dp=4)
    assert planes["uniforms"].shape[1] == 132            # 130 padded
    ref, rst = render_path(scene, guide_fn=fb.as_guide_fn(), device="cpu",
                           jitter=planes["jitter"],
                           uniforms=planes["uniforms"][:, :130],
                           fb_uniforms=planes["fb_uniforms"][:, :130], **kw)

    jm = jax_mesh.make_mesh(8, tp=2)
    ja.params = {k: jax_mesh.shard_fb_params(jm, v)
                 for k, v in ja.params.items()}
    m = pmesh.make_mesh(devices=CPU8, tp=2)
    for name, attr in (("encoder", "encoder"), ("backward", "backward"),
                       ("forward", "forward_model")):
        module = pmesh.shard_fb_params(m, getattr(fb, attr))
        split = {n: isinstance(c, pmesh.ShardedDense)
                 for n, c in module.named_modules()
                 if isinstance(c, (pmesh.ShardedDense, Dense))}
        assert split == _kernel_paths(ja.params[name]), name
        if name != "forward":
            setattr(fb, attr, module)
    assert isinstance(fb.encoder.Dense_0, pmesh.ShardedDense)
    assert not isinstance(
        fb.encoder.MultiHeadDotProductAttention_0.query, pmesh.ShardedDense)
    # A kernel of two output axes (the attention's at FBConfig()'s widths)
    # splits its last axis, as JAX's P(None, None, "tp") does.
    dense = Dense(8, (4, 128))
    with torch.no_grad():
        dense.kernel.normal_(generator=torch.Generator().manual_seed(0))
        dense.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn((5, 8), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(pmesh.ShardedDense(dense, m.devices[0])(x),
                               dense(x), rtol=0, atol=1e-6)

    out, ost = pmesh.render_path_sharded(m, scene, guide_fn=fb.as_guide_fn(),
                                         **planes, **kw)
    # Jitted: the bound is not bit for bit, and op by op takes longer.
    want, wst = jax_sharded_path(jm, js, key, eager=False,
                                 guide_fn=ja.as_guide_fn(dtype=None), **kw)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert ost.as_dict() == wst and wst["fb_used"] > 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    assert int(ost.fb_used) >= int(rst.fb_used) > 0
