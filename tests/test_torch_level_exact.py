"""The shared level's exact rewrites (raytracer_tpu_torch/csrc/
path_common.cuh), held on the CPU against the plain level that computes
every term (core/cuda_path.py::level_plain, the op-for-op counterpart of
raytracer_tpu/trace/path.py::_trace_path_lean_impl):

* the sweep's inside test ``d2 <= T(r)`` (``cuda_path.inside_threshold``)
  agrees with the plain ``sqrt(d2) <= r`` on every float32 within 64 ulps
  of ``T(r)``, and on ``+inf`` and NaN, for every radius of every library
  scene, seeded random radii and r in {0, tiny, huge, inf, NaN};
  It also equals the plain test on every level of a seeded edge scene
  (``tools/level_edges.py``) whose rays put d2 between fl(r*r) and T(r);
* direct light's far and back-facing culls, evaluated in float32 torch as
  the kernels evaluate them (``level_edges.culled``), never drop a non-zero term of
  the plain direct light: on every level of the chandelier at
  40x30@2spp/8 and of an edge scene (``mirror_threshold`` 0.0 and 0.9,
  exact and fast), and on adversarial points at the cut distance +- a few
  ulps and at grazing angles;
* ``PathTable``'s ``inside`` and ``light_cut`` planes match a numpy
  computation made another way;
* ``level_edges.level_work``, from which ``chip_smoke.py`` counts the
  kernels' bounds, agrees with counts made from the plain level.
"""
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import cuda_path, vec
from raytracer_tpu_torch.core.intersect import nearest_hit_c
from raytracer_tpu_torch.render.camera import perspective_rays
from raytracer_tpu_torch.scene import library
from raytracer_tpu_torch.tools import level_edges
from raytracer_tpu_torch.trace.path import (_direct_lighting_c,
                                            emissive_indices, scene_spec)

SCENES = ("custom", "true_original", "planets2", "marbles4", "chandelier")
INF = np.float32(np.inf)


def _library_radii(name):
    scene = getattr(library, name + "_scene")(device="cpu")[0]
    return scene.radius.numpy().astype(np.float32)


def _radii(case):
    if case in SCENES:
        return _library_radii(case)
    rng = np.random.default_rng(8)
    if case == "random":
        return np.concatenate([
            rng.uniform(0.0, 100.0, 3000),
            10.0 ** rng.uniform(-20.0, 18.0, 3000)]).astype(np.float32)
    return np.array([0.0, -0.0, 1e-45, 1e-40, 1.2e-38, 3e-20, 1.8446743e19,
                     3.4e38, np.finfo(np.float32).max, np.inf, -np.inf,
                     -1.0, np.nan], dtype=np.float32)


def _step(x, k):
    """``x`` moved by ``k`` float32 ulps (toward +inf for k > 0)."""
    to = INF if k > 0 else -INF
    for _ in range(abs(k)):
        x = np.nextafter(x, to).astype(np.float32)
    return x


@pytest.mark.parametrize("case", SCENES + ("random", "special"))
def test_inside_threshold_agrees_with_sqrt_test(case):
    r = _radii(case)
    t = cuda_path.inside_threshold(r)
    assert t.dtype == np.float32 and t.shape == r.shape
    checked = 0
    with np.errstate(invalid="ignore", over="ignore"):
        x = _step(t, -65)
        for _ in range(129):
            x = _step(x, 1)
            ok = (x >= 0) | np.isnan(x)     # the sweep's d2 is >= 0 or NaN
            exact = np.sqrt(x) <= r
            np.testing.assert_array_equal((x <= t)[ok], exact[ok])
            checked += int(ok.sum())
        for d2 in (np.float32(0.0), INF, np.float32(np.nan)):
            np.testing.assert_array_equal(d2 <= t, np.sqrt(d2) <= r)
    assert checked > 0
    if case in ("random", "chandelier"):
        # The rewrite is not the fast test's d2 <= r*r.
        with np.errstate(over="ignore"):
            assert (t != r * r).any()


def _threshold_by_bisection(r):
    """The largest float32 x >= 0 with sqrt(x) <= r, by bisection over the
    ordered bit patterns of the non-negative float32 values."""
    r = np.float32(r)
    if np.isnan(r):
        return np.float32(np.nan)
    if r < 0:
        return -INF
    lo, hi = 0, 0x7F800000                # +0 .. +inf as int32 patterns
    as_f = lambda i: np.array([i], np.int32).view(np.float32)[0]
    if np.sqrt(as_f(hi)) <= r:
        return INF
    while hi - lo > 1:                    # sqrt(as_f(lo)) <= r < at hi
        mid = (lo + hi) // 2
        if np.sqrt(as_f(mid)) <= r:
            lo = mid
        else:
            hi = mid
    return as_f(lo)


def _random_spec(rng, n, n_emissive):
    rows = []
    for i in range(n):
        c = rng.uniform(-5, 5, 3)
        col = rng.uniform(0, 255, 3)
        if i == 1:
            col = (np.nan, 1.0, 2.0)                 # not finite: no cut
        if i == 2:
            col = (-300.0, 5.0, 0.0)                 # |colour| counts
        rows.append((*map(float, np.float32(c)),
                     float(np.float32(rng.uniform(0.01, 3.0))),
                     *map(float, np.float32(col)), 0.5, 0.0,
                     1.0 if i < n_emissive else 0.0, 1.0, i))
    return tuple(rows)


@pytest.mark.parametrize("case", ["chandelier", "random"])
def test_path_table_planes_match_numpy(case):
    if case == "chandelier":
        scene = library.chandelier_scene(device="cpu")[0]
        spec, em = scene_spec(scene), emissive_indices(scene)
    else:
        spec, em = _random_spec(np.random.default_rng(3), 9, 4), (0, 1, 2, 3)
    table = cuda_path.path_table(spec, em, 0.9, "cpu")
    assert table.inside.dtype == table.light_cut.dtype == torch.float32
    assert table.inside.shape == (len(spec),)
    assert table.light_cut.shape == (len(em),)
    want = np.array([_threshold_by_bisection(row[3]) for row in spec],
                    np.float32)
    np.testing.assert_array_equal(table.inside.numpy(), want)
    cut = []
    for s in em:
        col = np.abs(np.array(spec[s][4:7], np.float64))
        c = 0.3 * col.max() * (1.0 + 2.0 ** -10)
        cut.append(max(c, 2.0 ** -60) if np.isfinite(col).all() else np.inf)
    np.testing.assert_array_equal(table.light_cut.numpy(),
                                  np.array(cut, np.float32))
    # The other planes are as before: exact float32 images of the spec.
    np.testing.assert_array_equal(table.spheres.numpy(), torch.tensor(
        [row[:12] for row in spec], dtype=torch.float32).numpy())
    assert torch.equal(table.emissive, torch.tensor(em, dtype=torch.int32))


def _light_terms(rows, s, px, py, pz, nx, ny, nz, idx, fast):
    """The plain direct light's term of emissive sphere ``s`` alone."""
    return _direct_lighting_c(rows, (s,), px, py, pz, nx, ny, nz, idx, fast)


def _level_inputs(case, mirror_threshold, fast):
    """Every level's inputs of a plain trace, 8 bounces: the chandelier at
    40x30@2spp (numpy-seeded jitter) or 4,000 rays of a seeded
    ``level_edges.edge_scene``; numpy-seeded uniforms."""
    rng = np.random.default_rng(21)
    if case == "chandelier":
        scene, _, _, params = library.chandelier_scene(device="cpu")
        jitter = torch.from_numpy(rng.random((2, 30, 40, 2),
                                             dtype=np.float32))
        o, d = perspective_rays(40, 30, fov=params["fov"],
                                origin=params["camera_position"],
                                sample_xy=jitter)
    else:
        scene, o, d = level_edges.edge_scene(1, 4000, "cpu")
    u = torch.from_numpy(rng.random((8, o.shape[0], 2), dtype=np.float32))
    table = cuda_path.path_table(scene_spec(scene), emissive_indices(scene),
                                 mirror_threshold, "cpu")
    levels = []

    def recording(lo, ld, lrun, lu, ltable, **kw):
        levels.append((lo, ld, lrun, lu))
        return cuda_path.level_plain(lo, ld, lrun, lu, ltable, **kw)

    cuda_path.trace_levels(recording, o.contiguous(), d.contiguous(), u,
                           table, max_bounces=8, background=(2.0, 2.0, 5.0),
                           fast=fast)
    return table, levels


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("mirror_threshold", [0.0, 0.9])
@pytest.mark.parametrize("case", ["chandelier", "edges"])
def test_light_culls_drop_no_nonzero_term_on_levels(case, mirror_threshold,
                                                    fast):
    table, levels = _level_inputs(case, mirror_threshold, fast)
    rows = table.spec
    cuts = table.light_cut.tolist()
    tested = culled = far_only = 0
    for lo, ld, lrun, _ in levels:
        h = nearest_hit_c(*lo.unbind(1), *ld.unbind(1), rows, fast=fast)
        emis = torch.tensor([row[9] > 0 for row in rows])[h.idx.long()]
        cont = lrun & h.found & ~emis
        if not cont.any():
            continue
        p = (h.px, h.py, h.pz)
        n = (h.nx, h.ny, h.nz)
        for s, cut in zip(table.emissive_idx, cuts):
            skip = level_edges.culled(*rows[s][:3], cut, *p, *n) & cont
            terms = _light_terms(rows, s, *p, *n, h.idx, fast)
            nonzero = (terms[0] != 0) | (terms[1] != 0) | (terms[2] != 0)
            assert not (skip & nonzero).any(), (s, int((skip & nonzero)
                                                       .sum()))
            tested += int(cont.sum())
            culled += int(skip.sum())
            tx = [c - q for c, q in zip(rows[s][:3], p)]
            d2 = tx[0] * tx[0] + tx[1] * tx[1] + tx[2] * tx[2]
            far_only += int((skip & (d2 > cut)).sum())
    # Not vacuous: a large share of the terms is skipped, by both tests.
    assert tested > 10_000
    assert culled > 0.25 * tested and 0 < far_only < culled


def test_inside_threshold_equals_sqrt_test_on_edge_rays():
    """The sweep's per-sphere validity with d2 <= T(r) equals the plain
    (tca >= 0) & (sqrt(d2) <= r) on every level of an edge scene, whose
    silhouette rays put d2 between fl(r*r) and T(r)."""
    table, levels = _level_inputs("edges", 0.0, False)
    in_window = 0
    for lo, ld, lrun, _ in levels:
        (ox, oy, oz), (dx, dy, dz) = lo.unbind(1), ld.unbind(1)
        for row, t in zip(table.spec, table.inside.tolist()):
            lx, ly, lz = row[0] - ox, row[1] - oy, row[2] - oz
            tca = lx * dx + ly * dy + lz * dz
            d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca,
                                 0.0)
            plain = (tca >= 0.0) & (vec.sqrt(d2) <= row[3])
            assert torch.equal(plain, (tca >= 0.0) & (d2 <= t))
            in_window += int((plain & ~(d2 <= row[3] * row[3])).sum())
    assert in_window > 10


def _grazing_normals(rng, t, n):
    """Unit normals (normalise3's rounding) nearly perpendicular to ``t
    [n, 3]``: cos(t, normal) within +-1e-5, some exactly 0 in reals."""
    t = t / np.linalg.norm(t, axis=1, keepdims=True)
    perp = np.cross(t, rng.normal(size=(n, 3)))
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    eps = rng.choice([0.0, 1e-9, -1e-9, 1e-8, -1e-8, 1e-7, -1e-7, 1e-6,
                      -1e-6, 1e-5, -1e-5], size=(n, 1))
    v = torch.from_numpy((perp + eps * t).astype(np.float32))
    return vec.normalise_safe_c(v[:, 0], v[:, 1], v[:, 2])


def test_light_culls_drop_no_nonzero_term_on_adversarial_points():
    rng = np.random.default_rng(5)
    n = 20_000
    centre = (0.25, -1.5, 3.0)
    colours = [(255.0, 255.0, 240.0), (3.0, 1.0, 0.5), (0.0, 0.0, 0.0),
               (200.0, 0.0, 0.0), (np.inf, 1.0, 1.0)]
    rows = tuple((*centre, 0.1, *col, 0.0, 0.0, 1.0, 1.0, k)
                 for k, col in enumerate(colours))
    cuts = cuda_path.light_cut([r[4:7] for r in rows])
    idx = torch.full((n,), -1, dtype=torch.int32)   # no light is the hit
    checked_near = 0
    for k, row in enumerate(rows):
        cut = float(cuts[k])
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        # Points at the cut distance (d2 at the cut +- a few ulps, and at
        # 0.3 * max colour, where w * colour reaches 1) and close points.
        base = np.sqrt(np.float64(cut if 1e-6 < cut < np.inf else 1.0))
        scale = base * (1.0 + rng.choice(
            [-4e-7, -1.2e-7, 0.0, 1.2e-7, 4e-7, -1e-3, -9.7e-4, -5e-4],
            size=n))
        scale[: n // 4] = rng.uniform(1e-3, 1e-2, n // 4)
        pts = np.asarray(centre) - dirs * scale[:, None]
        p = torch.from_numpy(pts.astype(np.float32)).unbind(1)
        t = np.asarray(centre) - pts.astype(np.float32)
        normals = {
            "facing": vec.normalise_safe_c(*torch.from_numpy(
                t.astype(np.float32)).unbind(1)),
            "away": vec.normalise_safe_c(*torch.from_numpy(
                (-t).astype(np.float32)).unbind(1)),
            "grazing": _grazing_normals(rng, t, n),
            "nan": tuple(torch.full((n,), np.nan) for _ in range(3)),
        }
        for name, nrm in normals.items():
            skip = level_edges.culled(*row[:3], cut, *p, *nrm)
            terms = _light_terms(rows, k, *p, *nrm, idx, False)
            nonzero = (terms[0] != 0) | (terms[1] != 0) | (terms[2] != 0)
            assert not (skip & nonzero).any(), (k, name)
            if name == "nan" or not np.isfinite(cut):
                assert not skip.any(), (k, name)
            if name == "facing" and max(row[4:7]) >= 3.0 and np.isfinite(cut):
                # Just inside 0.3 * max colour the terms are not zero and
                # the cull keeps them: the cut is tight.
                tx = [c - q for c, q in zip(row[:3], p)]
                d2 = tx[0] * tx[0] + tx[1] * tx[1] + tx[2] * tx[2]
                near = d2 < 0.3 * max(row[4:7]) * (1 - 1e-4)
                near &= d2 > 0.3 * max(row[4:7]) * (1 - 2e-3)
                assert nonzero[near].all() and not skip[near].any()
                checked_near += int(near.sum())
            if name == "grazing" and 200.0 <= max(row[4:7]) < np.inf:
                # Close, bright and grazing: tiny positive cosines give
                # non-zero terms, and some negative ones are skipped.
                close = torch.from_numpy(scale < 1e-2)
                assert (nonzero & close).any() and (skip & close).any()
    assert checked_near > 100


@pytest.mark.parametrize("mirror_threshold", [0.0, 0.9])
@pytest.mark.parametrize("case", ["chandelier", "edges"])
def test_level_work_counts_the_plain_level(case, mirror_threshold):
    """``level_work`` against counts made from the plain level on every
    level: valid sphere tests by the plain ``sqrt(d2) <= r``, continuing
    and mirror lanes from ``level_plain``, and no fewer lights computed
    than non-zero plain terms."""
    table, levels = _level_inputs(case, mirror_threshold, False)
    rows = table.spec
    total = dict.fromkeys(("sphere_tests", "front_sphere_tests",
                           "valid_sphere_tests", "light_terms",
                           "lights_computed"), 0)
    for lo, ld, lrun, lu in levels:
        w = level_edges.level_work(lo, ld, lrun, lu, table)
        st = cuda_path.level_plain(lo, ld, lrun, lu, table).state.to(
            torch.int32)
        cont = (st & cuda_path.ST_CONT) != 0
        mirror = cont & ((st & cuda_path.ST_MIRROR) != 0)
        (ox, oy, oz), (dx, dy, dz) = lo.unbind(1), ld.unbind(1)
        front = valid = 0
        for row in rows:
            lx, ly, lz = row[0] - ox, row[1] - oy, row[2] - oz
            tca = lx * dx + ly * dy + lz * dz
            d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca,
                                 0.0)
            front += int((lrun & (tca >= 0.0)).sum())
            valid += int((lrun & (tca >= 0.0)
                          & (vec.sqrt(d2) <= row[3])).sum())
        h = nearest_hit_c(*lo.unbind(1), *ld.unbind(1), rows, fast=False)
        nonzero = 0
        for s in table.emissive_idx:
            terms = _light_terms(rows, s, h.px, h.py, h.pz, h.nx, h.ny, h.nz,
                                 h.idx, False)
            nonzero += int((cont & ((terms[0] != 0) | (terms[1] != 0)
                                    | (terms[2] != 0))).sum())
        assert w["sphere_tests"] == len(rows) * int(lrun.sum())
        assert w["front_sphere_tests"] == front
        assert w["valid_sphere_tests"] == valid
        assert w["continuing"] == int(cont.sum())
        assert w["reflections"] == int(mirror.sum())
        assert w["light_terms"] == len(table.emissive_idx) * int(cont.sum())
        assert nonzero <= w["lights_computed"] <= w["light_terms"]
        for k in total:
            total[k] += w[k]
    # Not vacuous: the data leaves work out at every step.
    assert (0 < total["valid_sphere_tests"] < total["front_sphere_tests"]
            < total["sphere_tests"])
    assert 0 < total["lights_computed"] < total["light_terms"]
