"""Seeded rays on the edges of the nearest-hit sweep's exact rewrites.

``csrc/sphere.cuh::test`` (the sweep of ``csrc/nearest_hit.cu`` and
``csrc/whitted_trace.cu``) rejects a sphere on ``tca < 0`` before it
computes ``d2``, takes the exact inside test as ``d2 <= T(r)`` without its
square root (``T(r)``: ``core/intersect.py::inside_threshold``, column 7
of ``SphereTable.spheres``), and computes ``thc``, ``t`` and the metric
only for a valid sphere.  ``edge_case`` builds a scene and rays that cross
each of those: ``d2`` in ``(fl(r*r), T(r)]`` and one float above ``T(r)``,
``tca`` at +-0 and at +-subnormals, two spheres with equal metrics, the
nearest sphere suppressed, origins inside a sphere (``t < 0``), and NaN
and infinite components.  ``edge_counts`` says how many tests or rays sit
on each edge.  ``chip_smoke.py`` (phase ``nearest_hit``) and the tests
hold the kernel against ``nearest_hit_plain`` on them.

``shadow_rays`` and ``level_rays`` give the sweep's two timed shapes: the
Whitted shadow sweep (``trace/shade.py``'s, which the shading kernel now
runs inside itself) and the stepwise path level's sweep
(``raytracer_tpu/trace/path.py:711-713``).

``sweep_model`` is the kernel's sweep in float32 PyTorch, op for op and
in its order (each quantity computed only on the lanes where the kernel
computes it), with the inside test's threshold as an argument, so that a
test can show that the edge rays tell a wrong threshold apart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import cuda_intersect, vec
from ..core.intersect import NO_SUPPRESS, inside_threshold, nearest_hit_c
from ..render.camera import perspective_rays
from ..scene.library import chandelier_scene
from ..scene.types import SceneBuilder

N_BASE = 6            # spheres with T(r) != fl(r*r)
DUPLICATES = (0, 1)   # base spheres repeated under a new id (equal metrics)
SUBNORMAL = float(np.float32(1e-40))


def _radius(rng, lo, hi):
    """A float32 radius in [lo, hi) whose T(r) is not fl(r*r)."""
    while True:
        r = np.float32(rng.uniform(lo, hi))
        if inside_threshold(r) != r * r:
            return float(r)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def edge_case(seed: int, n_rays: int, device=None):
    """``(table, origins [R, 3], dirs [R, 3], suppress_id [R])`` on
    ``device``, R = ``n_rays`` rounded down to a multiple of 8: a
    ``SphereTable`` of 8 spheres (6 whose ``T(r)`` is not ``fl(r*r)``, and
    spheres 0 and 1 again under new ids) and seven groups of rays (the
    first twice the size of the others): silhouette grazes from
    close by, so that ``d2`` spans a few floats around ``r*r``; rays along
    an axis through a centre's plane, so that ``tca`` is +0, -0 or a
    +-subnormal; rays at a duplicated sphere, half with the first copy
    suppressed; rays whose nearest sphere is suppressed; origins inside a
    sphere; and rays with a NaN or infinite component."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    centres, radii = [], []
    for k in range(N_BASE):
        c = rng.uniform(-4.0, 4.0, 3)
        r = _radius(rng, 0.5, 2.5)
        b.add_sphere(tuple(c), r, id=10 + k)
        centres.append(np.float32(c).astype(np.float64))
        radii.append(r)
    for j, k in enumerate(DUPLICATES):
        b.add_sphere(tuple(centres[k]), radii[k], id=20 + j)
        centres.append(centres[k])
        radii.append(radii[k])
    scene, _, _ = b.build(device="cpu")
    table = cuda_intersect.sphere_table(scene)
    centres, radii = np.array(centres), np.array(radii)
    ids = np.array([row[-1] for row in table.spec], np.int64)
    n_sph = len(radii)

    m = n_rays // 8
    groups = []
    # 1. Grazes: the ray passes a centre at r (1 +- 2e-7), from 0-0.3 units
    #    before the tangent point (tca >= 0).
    k = rng.integers(0, n_sph, 2 * m)
    d = _unit(rng.normal(size=(2 * m, 3)))
    perp = _unit(np.cross(d, rng.normal(size=(2 * m, 3))))
    off = radii[k] * (1.0 + rng.uniform(-2e-7, 2e-7, 2 * m))
    o = centres[k] + perp * off[:, None] - d * rng.uniform(0.0, 0.3,
                                                          (2 * m, 1))
    groups.append((o, d, np.full(2 * m, NO_SUPPRESS)))
    # 2. tca at +-0: along -x from a point of the centre's x plane, the
    #    other components' products signed so that tca is +0 or -0 (d =
    #    (+-1, +-0, +-0)); half the origins inside the sphere.
    k = rng.integers(0, N_BASE, m)
    yz = _unit(rng.normal(size=(m, 2))) * (radii[k] * rng.uniform(
        0.2, 1.3, m))[:, None]
    o = centres[k] + np.stack([np.zeros(m), yz[:, 0], yz[:, 1]], 1)
    sx = rng.choice([-1.0, 1.0], m)
    d = np.stack([sx, -0.0 * np.sign(yz[:, 0]) * sx,
                  -0.0 * np.sign(yz[:, 1]) * sx], 1)
    d[m // 2:, 1:] = 0.0 * np.sign(yz[m // 2:])           # some +0, +0
    groups.append((o, d, np.full(m, NO_SUPPRESS)))
    # 3. tca a +-subnormal: d = (1, +-1e-40, 0) through a point of the
    #    centre's x plane at y = -+0.5..1.5 units, inside or outside.
    k = rng.integers(0, N_BASE, m)
    y = rng.uniform(0.5, 1.5, m) * rng.choice([-1.0, 1.0], m)
    z = rng.uniform(-0.5, 0.5, m)
    o = centres[k] + np.stack([np.zeros(m), y, z], 1)
    d = np.stack([np.ones(m), rng.choice([-SUBNORMAL, SUBNORMAL], m),
                  np.zeros(m)], 1)
    groups.append((o, d, np.full(m, NO_SUPPRESS)))
    # 4. Equal metrics: at a duplicated sphere from 3-8 units out, half
    #    with the first copy's id suppressed.
    k = rng.choice(DUPLICATES, m)
    d = _unit(rng.normal(size=(m, 3)))
    o = centres[k] - d * rng.uniform(3.0, 8.0, (m, 1)) + rng.normal(
        size=(m, 3)) * (0.3 * radii[k])[:, None]
    sup = np.where(rng.random(m) < 0.5, ids[k], NO_SUPPRESS)
    groups.append((o, d, sup))
    # 5. The nearest sphere suppressed: toward a random sphere; the
    #    suppressed id is set below from the unsuppressed nearest hit.
    k = rng.integers(0, n_sph, m)
    o = rng.uniform(-8.0, 8.0, (m, 3))
    d = _unit(centres[k] + rng.normal(size=(m, 3)) - o)
    groups.append((o, d, np.full(m, NO_SUPPRESS)))
    # 6. Origins inside a sphere, every direction.
    k = rng.integers(0, n_sph, m)
    o = centres[k] + _unit(rng.normal(size=(m, 3))) * (
        radii[k] * rng.uniform(0.0, 0.99, m))[:, None]
    d = _unit(rng.normal(size=(m, 3)))
    groups.append((o, d, np.full(m, NO_SUPPRESS)))
    # 7. A NaN or infinite component in the origin or the direction.
    rest = n_rays // 8 * 8 - 7 * m
    o = rng.uniform(-6.0, 6.0, (rest, 3))
    d = _unit(rng.normal(size=(rest, 3)))
    bad = rng.choice([np.nan, np.inf, -np.inf], rest)
    comp = rng.integers(0, 6, rest)
    rows = np.arange(rest)
    o[rows[comp < 3], comp[comp < 3]] = bad[comp < 3]
    d[rows[comp >= 3], comp[comp >= 3] - 3] = bad[comp >= 3]
    groups.append((o, d, np.where(rng.random(rest) < 0.3,
                                  ids[rng.integers(0, n_sph, rest)],
                                  NO_SUPPRESS)))

    o = torch.from_numpy(np.concatenate([g[0] for g in groups])
                         .astype(np.float32))
    d = torch.from_numpy(np.concatenate([g[1] for g in groups])
                         .astype(np.float32))
    sup = torch.from_numpy(np.concatenate([g[2] for g in groups])
                           .astype(np.int32))
    lo = 5 * m                   # group 5: after 2m grazes and 3m rays
    nearest = nearest_hit_c(*o[lo:lo + m].unbind(1), *d[lo:lo + m].unbind(1),
                            table.spec, by_abs=False)
    sup[lo:lo + m] = torch.where(nearest.found, table.ids[nearest.idx],
                                 NO_SUPPRESS)
    dev = torch.device(device) if device is not None else scene.device
    table = cuda_intersect.SphereTable(
        table.spec, table.mirror, table.glass, table.spheres.to(dev),
        table.ids.to(dev))
    return table, o.to(dev), d.to(dev), sup.to(dev)


def shadow_rays(res, point_lights, table: cuda_intersect.SphereTable):
    """The shadow sweep toward the first point light, as
    ``trace/shade.py::terminal_rgb`` sweeps it: ``(origins, unit dirs,
    suppress_id)`` from a Whitted trace result's termini, the shaded
    sphere's id suppressed; trace by signed ``t``."""
    to_light = torch.nn.functional.normalize(point_lights.position[0]
                                             - res.point, dim=1)
    return res.point, to_light.contiguous(), table.ids[res.idx]


def level_rays(device, seed: int, width: int = 800, height: int = 600,
               spp: int = 8):
    """The stepwise path level's sweep at level 0
    (``raytracer_tpu/trace/path.py:711-713``): ``(table, origins, unit
    dirs)``, the chandelier's camera rays at ``width`` x ``height`` x
    ``spp``, jittered by a ``torch.Generator`` seeded with ``seed``, the
    directions normalised as the tracer normalises them; trace by ``|t|``,
    nothing suppressed."""
    scene, _, _, p = chandelier_scene(device=device)
    dev = scene.device
    jitter = torch.rand((spp, height, width, 2), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    o, d = perspective_rays(width, height, fov=p["fov"],
                            origin=p["camera_position"], sample_xy=jitter)
    dn = torch.stack(vec.normalise_safe_c(*d.unbind(1)), 1)
    return cuda_intersect.sphere_table(scene), o.contiguous(), dn


def _tca_d2(row, o, d):
    lx, ly, lz = row[0] - o[:, 0], row[1] - o[:, 1], row[2] - o[:, 2]
    tca = lx * d[:, 0] + ly * d[:, 1] + lz * d[:, 2]
    return tca, torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)


def edge_counts(o: torch.Tensor, d: torch.Tensor,
                sup: Optional[torch.Tensor],
                table: cuda_intersect.SphereTable) -> dict:
    """How many sphere tests or rays sit on each edge of the rewrites, in
    the plain formulas' float32 arithmetic.  Sphere tests with ``tca >=
    0``: ``d2`` in ``(fl(r*r), T(r)]`` (inside by the exact test, outside
    by the fast one), at ``T(r)``, and one float above it.  Sphere tests
    with ``d2 <= T(r)`` (where the sign of ``tca`` decides) whose ``tca``
    is +0, -0, or a positive or negative subnormal.  Rays: two valid
    spheres share the nearest signed ``t``; the suppressed id is that of
    the nearest sphere without suppression; the nearest hit by ``|t|`` has
    ``t < 0``; a component is not finite."""
    f32 = torch.float32
    tiny = float(np.finfo(np.float32).tiny)
    c = {k: 0 for k in ("d2_in_window", "d2_at_threshold",
                        "d2_one_float_above_threshold", "tca_plus_zero",
                        "tca_minus_zero", "tca_positive_subnormal",
                        "tca_negative_subnormal")}
    thresholds = table.spheres[:, 7].cpu().numpy()
    for row, thr in zip(table.spec, thresholds):
        tca, d2 = _tca_d2(row, o, d)
        rr = float(np.float32(row[3]) * np.float32(row[3]))
        above = float(np.nextafter(thr, np.float32(np.inf)))
        ahead = tca >= 0.0
        thr = float(thr)
        c["d2_in_window"] += int((ahead & (d2 > rr) & (d2 <= thr)).sum())
        c["d2_at_threshold"] += int((ahead & (d2 == thr)).sum())
        c["d2_one_float_above_threshold"] += int((ahead & (d2 == above))
                                                 .sum())
        near = d2 <= thr
        zero = near & (tca == 0.0)
        sub = near & (tca != 0.0) & (tca.abs() < tiny)
        c["tca_plus_zero"] += int((zero & ~torch.signbit(tca)).sum())
        c["tca_minus_zero"] += int((zero & torch.signbit(tca)).sum())
        c["tca_positive_subnormal"] += int((sub & (tca > 0)).sum())
        c["tca_negative_subnormal"] += int((sub & (tca < 0)).sum())
    rows = table.spec
    h = nearest_hit_c(*o.unbind(1), *d.unbind(1), rows, by_abs=False,
                      suppress_id=sup)
    ties = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    for s, row in enumerate(rows):
        tca, d2 = _tca_d2(row, o, d)
        t = tca - vec.sqrt(torch.clamp_min(row[3] * row[3] - d2, 0.0))
        valid = (tca >= 0.0) & (vec.sqrt(d2) <= row[3])
        if sup is not None:
            valid = valid & (sup != row[-1])
        ties += (valid & h.found & (t == h.t)).to(torch.int32)
    c["equal_metrics"] = int((ties >= 2).sum())
    free = nearest_hit_c(*o.unbind(1), *d.unbind(1), rows, by_abs=False)
    c["nearest_suppressed"] = 0 if sup is None else int(
        (free.found & (table.ids.to(o.device)[free.idx] == sup)).sum())
    by_abs = nearest_hit_c(*o.unbind(1), *d.unbind(1), rows, by_abs=True,
                           suppress_id=sup)
    c["inside_negative_t"] = int((by_abs.found & (by_abs.t < 0)).sum())
    fin = torch.isfinite(o.to(f32)).all(1) & torch.isfinite(d.to(f32)).all(1)
    c["non_finite"] = int((~fin).sum())
    return c


def sweep_model(o: torch.Tensor, d: torch.Tensor,
                sup: Optional[torch.Tensor],
                table: cuda_intersect.SphereTable, *, by_abs: bool,
                fast: bool, threshold=None):
    """``csrc/sphere.cuh``'s staging and sweep in float32 PyTorch, op for op:
    per sphere, ``tca`` on every ray, ``d2`` only where ``tca >= 0``, the
    inside test ``d2 <= c.w`` (``c.w``: ``threshold[s]`` if given, else
    column 7, ``T(r)``; ``fl(r*r)`` when ``fast``) and the id only there,
    and ``thc``, ``t`` and the metric only for a valid sphere.  Returns
    ``(t, idx, found)`` as ``nearest_hit_plain`` does."""
    R, dev = o.shape[0], o.device
    big = float(np.finfo(np.float32).max)
    best_m = torch.full((R,), big, device=dev)
    best_t = torch.full((R,), big, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    found = torch.zeros((R,), dtype=torch.bool, device=dev)
    spheres = table.spheres.cpu()
    for s, row in enumerate(table.spec):
        cx, cy, cz, r = (spheres[s, j] for j in range(4))
        rr = r * r
        if fast:
            w = rr
        elif threshold is None:
            w = spheres[s, 7]
        else:
            w = torch.tensor(threshold[s], dtype=torch.float32)
        lx, ly, lz = cx - o[:, 0], cy - o[:, 1], cz - o[:, 2]
        tca = lx * d[:, 0] + ly * d[:, 1] + lz * d[:, 2]
        ahead = torch.nonzero(tca >= 0.0).squeeze(1)
        la, lb, lc, ta = lx[ahead], ly[ahead], lz[ahead], tca[ahead]
        d2 = torch.clamp_min(la * la + lb * lb + lc * lc - ta * ta, 0.0)
        keep = d2 <= w
        if sup is not None:
            keep = keep & (sup[ahead] != row[-1])
        v = ahead[keep]
        t = ta[keep] - vec.sqrt(torch.clamp_min(rr - d2[keep], 0.0))
        m = t.abs() if by_abs else t
        better = m < best_m[v]
        bv = v[better]
        best_m[bv] = m[better]
        best_t[bv] = t[better]
        best_i[bv] = s
        found[v] = True
    return best_t, best_i, found
