"""Seeded scenes and rays on the edges of the path level's exact rewrites.

``csrc/path_common.cuh`` takes the sweep's inside test as ``d2 <= T(r)``
without its square root, and skips a light whose direct-light term is
provably zero (far past its cut, or back-facing).  ``edge_scene`` builds a
scene and rays that cross both: radii whose ``T(r)`` is not ``fl(r*r)``,
rays that graze those spheres' silhouettes, lights whose cut distance
passes through the hit points (some placed so that the nearest point of
their receiver sits at the cut, where the term steps from 1 to 0), and
hit points on the terminator of a light (grazing normals).  Non-emissive
spheres are reflective in (0.05, 1): all mirrors at ``mirror_threshold``
0, some diffuse at 0.9.  ``edge_counts`` says how many of a level's tests
sit on those edges.  ``chip_smoke.py`` (phase ``level_edges``) and the
tests hold the kernels against their plain versions on these scenes.

``culled`` is direct light's skip test in float32 PyTorch, op for op as
the kernels evaluate it, and ``level_work`` counts a level's work on its
data as the kernels do it (``chip_smoke.py`` bounds them by it), with the
square roots and divides before and after the rewrites.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import cuda_path, vec
from ..scene.types import SceneBuilder

N_RECEIVERS, N_LIGHTS = 8, 16
F32_MAX = float(np.finfo(np.float32).max)


def _radius(rng, lo, hi):
    """A float32 radius in [lo, hi) whose T(r) is not fl(r*r)."""
    while True:
        r = np.float32(rng.uniform(lo, hi))
        if cuda_path.inside_threshold(r) != r * r:
            return float(r)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _at_points(rng, pts, normals):
    """Rays that meet ``pts`` from outside: origins 0.5-2 units out along
    unit vectors within ~70 degrees of each normal."""
    v = _unit(normals + 0.6 * _unit(rng.normal(size=normals.shape)))
    v = np.where((v * normals).sum(-1, keepdims=True) > 0.3, v, normals)
    return pts + v * rng.uniform(0.5, 2.0, (len(pts), 1)), -v


def _on_receiver(rng, centre, radius, light, cos):
    """Points of the receivers (``centre``, ``radius``) whose normal makes
    the cosine ``cos`` with the direction to ``light``, at a random
    azimuth, and those normals."""
    u = _unit(light - centre)
    w = _unit(np.cross(u, rng.normal(size=u.shape)))
    cos = np.clip(cos, -1.0, 1.0)[:, None]
    n = u * cos + w * np.sqrt(1.0 - cos * cos)
    return centre + radius[:, None] * n, n


def edge_scene(seed: int, n_rays: int, device=None):
    """``(scene, origins [n_rays, 3], dirs [n_rays, 3])`` float32 on
    ``device``: 8 receivers and 16 lights, and four equal groups of rays
    (silhouette grazes, terminator points, points at a light's cut
    distance on the circle where its cut sphere meets the receiver, points
    next to the nearest receiver point of a light placed at its cut)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    centres, radii = [], []

    def add(c, r, col, **kw):
        b.add_sphere(tuple(c), r, tuple(col), id=len(radii), **kw)
        centres.append(np.float32(c).astype(np.float64))
        radii.append(r)

    for _ in range(N_RECEIVERS):
        add(rng.uniform(-6.0, 6.0, 3), _radius(rng, 0.5, 2.5),
            rng.uniform(30, 255, 3), reflective=rng.uniform(0.05, 1.0))
    receiver = np.arange(N_LIGHTS) % N_RECEIVERS
    cut_dist = np.empty(N_LIGHTS)
    for j, k in enumerate(receiver):
        if j < N_LIGHTS // 2:      # the nearest receiver point at the cut
            cut_dist[j] = rng.uniform(1.0, 6.0)
            gap = cut_dist[j] * (1.0 + rng.uniform(-2e-4, 2e-4))
        else:                      # the cut sphere through the receiver
            gap = rng.uniform(0.1, 1.5)
            cut_dist[j] = rng.uniform(gap + 0.05, gap + 2 * radii[k] - 0.05)
        top = cut_dist[j] ** 2 / 0.3          # 0.3 * max colour = cut^2
        col = rng.permutation([top, rng.uniform(0, top),
                               rng.uniform(0, top)])
        add(centres[k] + _unit(rng.normal(size=3)) * (radii[k] + gap),
            _radius(rng, 0.03, 0.08), col, emitive=1.0)
    scene, _, _ = b.build(device=device)
    centres, radii = np.array(centres), np.array(radii, np.float64)
    light_pos = centres[N_RECEIVERS:]

    m = n_rays // 4
    groups = []
    # 1. Silhouette grazes: the ray passes a centre at r (1 +- 2e-7), from
    #    close by (d2's rounding then spans a few ulps of r*r).
    k = rng.integers(0, N_RECEIVERS + N_LIGHTS, m)
    d = _unit(rng.normal(size=(m, 3)))
    perp = _unit(np.cross(d, rng.normal(size=(m, 3))))
    off = radii[k] * (1.0 + rng.uniform(-2e-7, 2e-7, m))
    groups.append((centres[k] + perp * off[:, None]
                   - d * rng.uniform(0.2, 1.0, (m, 1)), d))
    # 2. Terminator points: (light - p) . n = 0, the normal turned by up
    #    to +-1e-6 rad.
    j = rng.integers(0, N_LIGHTS, m)
    c, r = centres[receiver[j]], radii[receiver[j]]
    a = np.linalg.norm(light_pos[j] - c, axis=1)
    groups.append(_at_points(rng, *_on_receiver(
        rng, c, r, light_pos[j], r / a + rng.uniform(-1e-6, 1e-6, m))))
    # 3. Crossing lights: points at the cut distance (1 +- 1e-6).
    j = rng.integers(N_LIGHTS // 2, N_LIGHTS, m)
    c, r = centres[receiver[j]], radii[receiver[j]]
    a = np.linalg.norm(light_pos[j] - c, axis=1)
    dd = cut_dist[j] * (1.0 + rng.uniform(-1e-6, 1e-6, m))
    groups.append(_at_points(rng, *_on_receiver(
        rng, c, r, light_pos[j], (a * a + r * r - dd * dd) / (2 * a * r))))
    # 4. Lights at the cut: points next to the receiver's nearest point.
    j = rng.integers(0, N_LIGHTS // 2, m)
    c, r = centres[receiver[j]], radii[receiver[j]]
    groups.append(_at_points(rng, *_on_receiver(
        rng, c, r, light_pos[j], 1.0 - rng.uniform(0.0, 1e-6, m))))
    o = np.concatenate([g[0] for g in groups]).astype(np.float32)
    d = np.concatenate([g[1] for g in groups]).astype(np.float32)
    dev = scene.device
    return scene, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def edge_counts(o: torch.Tensor, d: torch.Tensor,
                table: cuda_path.PathTable, hit: torch.Tensor,
                cont: torch.Tensor) -> dict:
    """How many of one level's tests sit on the rewrites' edges, in the
    plain formulas' float32 arithmetic: sphere tests with ``tca >= 0``
    whose ``d2`` lies in ``(fl(r*r), T(r)]`` (inside by the exact test,
    outside by the fast one); continuing (lane, light) pairs whose ``d2``
    is within 1e-3 of the light's cut, and whose cosine is within 1e-5 of
    0.  ``d``: unit directions; ``hit [R, 11]`` and ``cont [R]`` from
    ``path_level``."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    window = 0
    for row, t in zip(table.spec, table.inside.tolist()):
        lx, ly, lz = row[0] - ox, row[1] - oy, row[2] - oz
        tca = lx * dx + ly * dy + lz * dz
        d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)
        rr = float(np.float32(row[3]) * np.float32(row[3]))
        window += int(((tca >= 0) & (d2 > rr) & (d2 <= t)).sum())
    px, py, pz, nx, ny, nz = hit[:, :6].unbind(1)
    at_cut = grazing = 0
    for s, cut in zip(table.emissive_idx, table.light_cut.tolist()):
        row = table.spec[s]
        tx, ty, tz = row[0] - px, row[1] - py, row[2] - pz
        d2 = tx * tx + ty * ty + tz * tz
        cos = (tx * nx + ty * ny + tz * nz) / vec.sqrt(d2)
        at_cut += int((cont & ((d2 / cut - 1).abs() < 1e-3)).sum())
        grazing += int((cont & (cos.abs() < 1e-5)).sum())
    return {"sphere_tests_in_sqrt_window": window,
            "light_pairs_at_cut": at_cut, "light_pairs_grazing": grazing}


def culled(cx, cy, cz, cut, px, py, pz, nx, ny, nz) -> torch.Tensor:
    """``csrc/path_common.cuh::direct_light``'s skip test for the light at
    ``(cx, cy, cz)`` with far cut ``cut`` (Python floats), in float32 op
    for op: True where the kernels skip it as provably zero."""
    tx, ty, tz = cx - px, cy - py, cz - pz
    d2 = tx * tx + ty * ty + tz * tz
    ldotn = tx * nx + ty * ny + tz * nz
    nn = nx * nx + ny * ny + nz * nz
    # fmaxf(2^-40 * nn, 2^-60); a NaN nn fails the finite-normal test.
    kh = torch.clamp_min(nn * 2.0 ** -40, 2.0 ** -60)
    far = d2 > cut
    back = (ldotn < 0.0) & (ldotn * ldotn > kh * d2) & (cut <= F32_MAX)
    return ((nn <= F32_MAX) & (d2 > cuda_path.CULL_MIN_D2) & (d2 <= F32_MAX)
            & (far | back))


def level_work(o: torch.Tensor, d: torch.Tensor, running: torch.Tensor,
               u, table: cuda_path.PathTable, lv=None) -> dict:
    """The work of one exact level on its data, counted as the kernels do it
    (``csrc/path_common.cuh``): sphere tests, those in front of the ray
    (``tca >= 0``, where ``d2`` is needed), the valid ones (where ``thc``
    and ``t`` are), light terms of continuing lanes and the ones not
    skipped, continuing lanes and those that keep the mirror reflection.
    Also the square roots and divides: ``before`` as the plain version
    computes them (and the kernels did before the rewrites), ``after`` as
    the kernels do now; counted: the sweep (2 square roots a sphere test
    before, 1 a valid test after) and its normal (1 and 3 a running lane),
    direct light (1 and 4 a light on a continuing lane before, a light not
    skipped after), the reflection (3 and 9) and a diffuse lane's cosine
    bounce (4 and 9).  ``lv``: the level's ``level_plain`` result with its
    hit plane, if the caller has it."""
    if lv is None:
        lv = cuda_path.level_plain(o, d, running, u, table, want_hit=True)
    st = lv.state.to(torch.int32)
    cont = (st & cuda_path.ST_CONT) != 0
    n_run, n_cont = int(running.sum()), int(cont.sum())
    n_diffuse = 0 if u is None else int(
        (cont & ((st & cuda_path.ST_MIRROR) == 0)).sum())
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    front = valid = 0
    for row, t in zip(table.spec, table.inside.tolist()):
        lx, ly, lz = row[0] - ox, row[1] - oy, row[2] - oz
        tca = lx * dx + ly * dy + lz * dz
        d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)
        ahead = running & (tca >= 0.0)
        front += int(ahead.sum())
        valid += int((ahead & (d2 <= t)).sum())
    hit = lv.hit[:, :6].unbind(1)
    lights = 0
    for s, cut in zip(table.emissive_idx, table.light_cut.tolist()):
        lights += int((cont & ~culled(*table.spec[s][:3], cut, *hit)).sum())
    n_sph, n_em = len(table.spec), len(table.emissive_idx)
    rest_sqrt = n_run + 3 * n_cont + 4 * n_diffuse
    rest_div = 3 * n_run + 9 * n_cont + 9 * n_diffuse
    return {"ray_levels": n_run, "continuing": n_cont,
            "reflections": n_cont - n_diffuse, "diffuse": n_diffuse,
            "sphere_tests": n_sph * n_run, "front_sphere_tests": front,
            "valid_sphere_tests": valid, "light_terms": n_em * n_cont,
            "lights_computed": lights,
            "before": {"sqrt": 2 * n_sph * n_run + n_em * n_cont + rest_sqrt,
                       "div": 4 * n_em * n_cont + rest_div},
            "after": {"sqrt": valid + lights + rest_sqrt,
                      "div": 4 * lights + rest_div}}
