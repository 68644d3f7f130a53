"""The nearest-hit sweep's exact rewrites (raytracer_tpu_torch/csrc/
sphere.cuh, the sweep of csrc/nearest_hit.cu and csrc/whitted_trace.cu),
held on the CPU against the plain sweep that computes every term
(core/cuda_intersect.py::nearest_hit_plain) and against JAX's
raytracer_tpu/core/intersect.py::nearest_hit_c:

* ``SphereTable.spheres`` stages ``T(r)`` (``intersect.inside_threshold``,
  the largest float32 whose square root is at most ``r``) in its column 7,
  and keeps every other column as it was;
* ``tools/sweep_edges.py::sweep_model``, the kernel's sweep in float32
  torch in its order of operations (``tca < 0`` rejected before ``d2``, the
  inside test ``d2 <= T(r)``, ``thc`` and ``t`` only for a valid sphere),
  equals ``nearest_hit_plain`` bit for bit on seeded edge rays in all four
  modes (signed ``t`` or ``|t|``, exact or fast), and every edge is
  crossed;
* ``nearest_hit_plain`` equals JAX's ``nearest_hit_c`` on those rays,
  every output exact (JAX in float32 with 64-bit mode off), once the CPU
  flushes subnormals to zero as XLA does; in IEEE arithmetic, the card's,
  they differ only where ``tca`` is a subnormal;
* the edge rays have teeth: the model with a threshold one float below
  ``T(r)``, ``fl(r*r)`` or one float above ``T(r)`` differs from the plain
  sweep on them;
* ``cuda_intersect.sweep_work``, from which ``chip_smoke.py`` counts the
  kernels' bounds, matches a count made by hand on a 3-sphere scene, and
  the Whitted plain version's counters carry it level by level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.scene.types as jax_types
from raytracer_tpu.core import intersect as jax_intersect
from raytracer_tpu_torch.core import cuda_intersect, cuda_path, cuda_whitted
from raytracer_tpu_torch.core.intersect import NO_SUPPRESS, inside_threshold
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.scene.types import SceneBuilder
from raytracer_tpu_torch.tools import sweep_edges

SCENES = ("custom", "true_original", "planets2", "marbles4", "chandelier")
MODES = [(False, False), (False, True), (True, False), (True, True)]
EDGE_SEED, EDGE_RAYS = 9, 8000


@pytest.fixture(scope="module")
def edges():
    return sweep_edges.edge_case(EDGE_SEED, EDGE_RAYS, "cpu")


@pytest.mark.parametrize("name", SCENES)
def test_sphere_table_stages_inside_threshold_in_column_7(name):
    scene = getattr(library, name + "_scene")(device="cpu")[0]
    for flags in ((True, True), (False, True), (True, False)):
        table = cuda_intersect.sphere_table(scene, *flags)
        rows = table.spheres.numpy()
        assert rows.dtype == np.float32 and rows.shape == (len(table.spec),
                                                           8)
        # Columns 0-6 as before: cx cy cz r ior mirror glass, each the
        # float32 of the scene's value.
        want = np.array([(r[0], r[1], r[2], r[3], r[10], float(m), float(g))
                         for r, m, g in zip(table.spec, table.mirror,
                                            table.glass)], np.float32)
        np.testing.assert_array_equal(rows[:, :7], want)
        np.testing.assert_array_equal(rows[:, 7],
                                      inside_threshold(rows[:, 3]))
        assert table.mirror == tuple(flags[1] and r[7] == 1.0
                                     for r in table.spec)
    # One function serves both tables.
    assert cuda_path.inside_threshold is inside_threshold


def test_edge_rays_cross_every_edge(edges):
    table, o, d, sup = edges
    assert o.shape == d.shape == (EDGE_RAYS, 3) and sup.shape == (EDGE_RAYS,)
    counts = sweep_edges.edge_counts(o, d, sup, table)
    assert all(v > 0 for v in counts.values()), counts
    # Radii whose T(r) is not fl(r*r): the window holds a float.
    r = table.spheres[:, 3].numpy()
    assert (table.spheres[:, 7].numpy() != r * r).all()


@pytest.mark.parametrize("by_abs,fast", MODES)
def test_sweep_model_equals_plain_on_edge_rays(edges, by_abs, fast):
    table, o, d, sup = edges
    want = cuda_intersect.nearest_hit_plain(o, d, sup, table, by_abs=by_abs,
                                            fast=fast)
    got = sweep_edges.sweep_model(o, d, sup, table, by_abs=by_abs,
                                  fast=fast)
    for g, w, f in zip(got, want, ("t", "idx", "found")):
        assert g.dtype == w.dtype, f
        assert torch.equal(g, w), f
    # Through the wrapper (its plain version on CPU tensors), no launch.
    before = cuda_intersect.nearest_hit.launches
    got = cuda_intersect.nearest_hit(o, d, sup, table, by_abs=by_abs,
                                     fast=fast)
    assert cuda_intersect.nearest_hit.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # The edges matter in this mode: some rays hit, some miss.
    assert 0 < int(want[2].sum()) < EDGE_RAYS


def _jax_scene(table):
    rows = table.spec
    f32 = np.float32
    return jax_types.Scene(
        centre=jnp.asarray(np.array([r[:3] for r in rows], f32)),
        radius=jnp.asarray(np.array([r[3] for r in rows], f32)),
        colour=jnp.asarray(np.array([r[4:7] for r in rows], f32)),
        reflective=jnp.asarray(np.array([r[7] for r in rows], f32)),
        transparent=jnp.asarray(np.array([r[8] for r in rows], f32)),
        emitive=jnp.asarray(np.array([r[9] for r in rows], f32)),
        ior=jnp.asarray(np.array([r[10] for r in rows], f32)),
        id=jnp.asarray(np.array([r[11] for r in rows], np.int32)))


def _subnormal_tca(table, o, d):
    """Rays whose tca, in IEEE float32, is a subnormal for some sphere."""
    tiny = float(np.finfo(np.float32).tiny)
    out = torch.zeros(o.shape[0], dtype=torch.bool)
    for row in table.spec:
        tca = ((row[0] - o[:, 0]) * d[:, 0] + (row[1] - o[:, 1]) * d[:, 1]
               + (row[2] - o[:, 2]) * d[:, 2])
        out |= (tca != 0.0) & (tca.abs() < tiny)
    return out


@pytest.mark.parametrize("by_abs,fast", MODES)
def test_nearest_hit_plain_equals_jax_on_edge_rays(edges, by_abs, fast):
    """XLA on the CPU flushes subnormal float32 to zero (as the TPU does):
    with the CPU flushing them too, the plain version equals JAX on every
    ray.  In IEEE arithmetic (the card, the kernel and the plain version
    by default) they differ only on rays whose tca is a subnormal: JAX
    takes a negative one as -0, which passes tca >= 0."""
    table, o, d, sup = edges
    on, dn, sn = o.numpy(), d.numpy(), sup.numpy()
    with jax.enable_x64(False):
        js = _jax_scene(table)
        h = jax_intersect.nearest_hit_c(
            *(jnp.asarray(on[:, k], jnp.float32) for k in range(3)),
            *(jnp.asarray(dn[:, k], jnp.float32) for k in range(3)),
            js, jnp.asarray(sn, jnp.int32), by_abs=by_abs, fast=fast)
        got = (np.asarray(h.t), np.asarray(h.idx), np.asarray(h.found))
    assert got[0].dtype == np.float32
    assert torch.set_flush_denormal(True)
    try:
        flushed = cuda_intersect.nearest_hit_plain(o, d, sup, table,
                                                   by_abs=by_abs, fast=fast)
    finally:
        torch.set_flush_denormal(False)
    for g, w in zip(got, flushed):
        np.testing.assert_array_equal(g, w.numpy())
    ieee = cuda_intersect.nearest_hit_plain(o, d, sup, table, by_abs=by_abs,
                                            fast=fast)
    differ = torch.from_numpy(
        (got[0] != ieee[0].numpy()) | (got[1] != ieee[1].numpy())
        | (got[2] != ieee[2].numpy()))
    sub = _subnormal_tca(table, o, d)
    assert bool(sub.any())
    assert not bool((differ & ~sub).any())


@pytest.mark.parametrize("wrong", ["one_float_below", "r_squared",
                                   "one_float_above"])
def test_edge_rays_tell_a_wrong_threshold_apart(edges, wrong):
    """The exact test with any threshold but T(r) fails on the edge rays
    (fl(r*r) is the fast test's: right on random rays, wrong here)."""
    table, o, d, sup = edges
    t = table.spheres[:, 7].numpy()
    r = table.spheres[:, 3].numpy()
    w = {"one_float_below": np.nextafter(t, np.float32(0.0)),
         "r_squared": r * r,
         "one_float_above": np.nextafter(t, np.float32(np.inf))}[wrong]
    for by_abs in (False, True):
        want = cuda_intersect.nearest_hit_plain(o, d, sup, table,
                                                by_abs=by_abs)
        got = sweep_edges.sweep_model(o, d, sup, table, by_abs=by_abs,
                                      fast=False, threshold=w)
        assert not torch.equal(got[2], want[2]), (wrong, by_abs)
    # Random rays do not tell them apart.
    g = torch.Generator().manual_seed(3)
    ro = torch.rand((2000, 3), generator=g) * 8 - 4
    rd = torch.nn.functional.normalize(torch.randn((2000, 3), generator=g),
                                       dim=1)
    want = cuda_intersect.nearest_hit_plain(ro, rd, None, table)
    got = sweep_edges.sweep_model(ro, rd, None, table, by_abs=False,
                                  fast=False, threshold=w)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _three_spheres():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 5.0), 1.0, id=7)      # ahead on +z
    b.add_sphere((0.0, 0.0, -5.0), 1.0, id=8)     # ahead on -z
    b.add_sphere((3.0, 0.0, 5.0), 1.0, id=9)      # off to the side
    scene, _, _ = b.build(device="cpu")
    return scene, cuda_intersect.sphere_table(scene)


def test_sweep_work_matches_a_hand_count():
    """Four rays from the origin against the three spheres, by hand (tca =
    L.d; valid: tca >= 0, d2 <= T(r), not suppressed):
    +z: A 5 valid, B -5, C 5 with d2 9 > 1: 2 ahead, 1 valid;
    -z: A -5, B 5 valid, C -5: 1 ahead, 1 valid;
    +x: A 0 (d2 25), B 0 (d2 25), C 3 (d2 25): 3 ahead, none valid;
    +z with A's id suppressed: 2 ahead, none valid."""
    _, table = _three_spheres()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0]])
    sup = torch.tensor([NO_SUPPRESS] * 3 + [7], dtype=torch.int32)
    for fast in (False, True):
        work = cuda_intersect.sweep_work(o, d, sup, table, fast=fast)
        assert work == {"sphere_tests": 12, "front_sphere_tests": 8,
                        "valid_sphere_tests": 2}
    work = cuda_intersect.sweep_work(o, d, None, table)
    assert work["valid_sphere_tests"] == 3
    active = torch.tensor([True, False, True, False])
    work = cuda_intersect.sweep_work(o, d, sup, table, active=active)
    assert work == {"sphere_tests": 6, "front_sphere_tests": 5,
                    "valid_sphere_tests": 1}
    t, idx, found = cuda_intersect.nearest_hit_plain(o, d, sup, table)
    assert found.tolist() == [True, True, False, False]
    assert idx.tolist()[:2] == [0, 1] and t.tolist()[:2] == [4.0, 4.0]


def test_whitted_counters_carry_the_sweep_work():
    """whitted_trace_plain's counters add each level's sweep_work over its
    active rays: on the three spheres, one level a ray (each terminal)."""
    scene, table = _three_spheres()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
                      [0.0, 0.0, 2.0]])
    work = {}
    cuda_whitted.whitted_trace_plain(o, d, None, table, max_bounces=3,
                                     counters=work)
    assert work["levels"] == 4
    assert (work["sphere_tests"], work["front_sphere_tests"],
            work["valid_sphere_tests"]) == (12, 8, 3)
