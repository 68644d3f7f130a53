"""The plain path tracer: camera, level, fold, frame.

A frozen copy, in plain PyTorch, of the chandelier renderers' recursive
tracer as the port states it (``render/camera.py::perspective_rays``,
``core/intersect.py::nearest_hit_c``, ``core/cuda_path.py::level_plain``,
``trace_levels`` and ``fold_levels``, ``trace/path.py``'s direct light and
observation, ``trace/sampling.py``'s tangent frame, ``render/
path_renderer.py``'s ``//spp`` fold), kept here so that no later change to
the program moves the yardstick.  It imports nothing of the program.

Every function takes its dtype from its inputs: float32 is the reference,
bfloat16 is the traditional cell's control (``tests/`` and ``tools/
readings.py``).  One rounding per operation, sums left to right.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# Level state bits.
ST_RUNNING, ST_FOUND, ST_EMISSIVE, ST_SMALL, ST_MIRROR, ST_CONT = (
    1, 2, 4, 8, 16, 32)
SMALL_LIGHT_RADIUS = 0.5
TANGENT_THRESHOLD = 0.9
OFFSET = 0.001
DIRECT_SCALE = 0.3


# -- vector helpers ----------------------------------------------------------

def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's CPU ``sqrt`` is not (about
    0.6% of float32 results one ulp off), so CPU tensors take numpy's;
    bfloat16 goes through float32."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    if x.dtype == torch.bfloat16:
        return torch.from_numpy(np.sqrt(x.float().numpy())).bfloat16()
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def div_scalar(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once (a CUDA divide by a Python scalar is a
    multiply by its reciprocal, two roundings)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def dot_c(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalise_c(x, y, z, eps: float = 1e-20):
    m = torch.clamp_min(sqrt(dot_c(x, y, z, x, y, z)), eps)
    return x / m, y / m, z / m


def reflect_c(vx, vy, vz, nx, ny, nz):
    vx, vy, vz = normalise_c(vx, vy, vz)
    nx, ny, nz = normalise_c(nx, ny, nz)
    s = 2.0 * dot_c(vx, vy, vz, nx, ny, nz)
    return normalise_c(vx - nx * s, vy - ny * s, vz - nz * s)


def local_to_world_c(theta, phi, nx, ny, nz):
    """Direction at polar ``theta`` and azimuth ``phi`` about ``n``: the
    renderers' tangent (``(1, 0, 0)`` where ``|n.z| > 0.9``, else
    ``(-ny, nx, 0)``), bitangent ``normalise(n x t)``."""
    zero = torch.zeros_like(nx)
    above = torch.abs(nz) > TANGENT_THRESHOLD
    tx, ty, tz = normalise_c(torch.where(above, torch.ones_like(nx), -ny),
                             torch.where(above, zero, nx),
                             torch.where(above, zero, zero))
    bx, by, bz = normalise_c(ny * tz - nz * ty, nz * tx - nx * tz,
                             nx * ty - ny * tx)
    st = torch.sin(theta)
    lx, ly, lz = st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)
    return normalise_c(lx * tx + ly * bx + lz * nx,
                       lx * ty + ly * by + lz * ny,
                       lx * tz + ly * bz + lz * nz)


def action_to_direction_c(a0, a1, nx, ny, nz):
    """A guide's action in [-1, 1]^2 as a direction: theta = (a0+1)pi/4,
    phi = a1 pi."""
    theta = div_scalar((a0 + 1.0) * math.pi, 4.0)
    return local_to_world_c(theta, a1 * math.pi, nx, ny, nz)


# -- scene -------------------------------------------------------------------

class Sphere(NamedTuple):
    """One sphere as Python floats that are exact float32 values."""
    cx: float
    cy: float
    cz: float
    r: float
    colr: float
    colg: float
    colb: float
    refl: float
    transp: float
    emit: float
    ior: float
    id: int


def scene_rows(spheres: Sequence[dict]) -> List[Sphere]:
    """The configuration's spheres rounded once from float64 to float32."""
    f = lambda v: float(np.float32(np.float64(v)))  # noqa: E731
    return [Sphere(f(s["centre"][0]), f(s["centre"][1]), f(s["centre"][2]),
                   f(s["radius"]), f(s["colour"][0]), f(s["colour"][1]),
                   f(s["colour"][2]), f(s.get("reflective", 0.0)),
                   f(s.get("transparent", 0.0)), f(s.get("emitive", 0.0)),
                   f(s.get("ior", 1.0)), int(s["id"])) for s in spheres]


def emissive_of(rows) -> List[int]:
    return [i for i, s in enumerate(rows) if s.emit > 0]


def no_diffuse_possible(rows, mirror_threshold: float) -> bool:
    """Every real sphere emits or mirrors: no uniform is ever read."""
    return all(s.emit > 0 or s.refl > mirror_threshold
               for s in rows if s.r > 0)


# -- camera ------------------------------------------------------------------

def camera_rays(jitter: torch.Tensor, width: int, height: int, fov: float,
                origin, dtype=torch.float32):
    """The FB renderers' pinhole (the aspect applied twice, a reference
    quirk kept): ``(origins, dirs)`` ``[spp*H*W, 3]``, samples outermost;
    ``jitter [spp, H, W, 2]`` sub-pixel offsets."""
    dev = jitter.device
    aspect = width / height
    fov_rad = np.radians(fov)
    half_height = float(np.float32(np.tan(fov_rad / 2)))
    half_width = float(np.float32(np.tan(fov_rad / 2) * aspect))
    px = torch.arange(width, dtype=dtype, device=dev)[None, :]
    py = torch.arange(height, dtype=dtype, device=dev)[:, None]
    sx, sy = jitter[..., 0].to(dtype), jitter[..., 1].to(dtype)
    screen_x = (2.0 * div_scalar(px + sx, width) - 1.0) * aspect * half_width
    screen_y = (1.0 - 2.0 * div_scalar(py + sy, height)) * half_height
    screen_x, screen_y = torch.broadcast_tensors(screen_x, screen_y)
    dirs = torch.stack([screen_x, screen_y, torch.full_like(screen_x, -1.0)],
                       dim=-1).reshape(-1, 3)
    origins = torch.tensor(origin, dtype=dtype, device=dev).expand_as(dirs)
    return origins, dirs


# -- one level ---------------------------------------------------------------

class Level(NamedTuple):
    state: torch.Tensor       # [R] uint8, ST_* bits
    rec: torch.Tensor         # [R, 6] albedo (found), direct (continuing)
    o_next: torch.Tensor
    d_next: torch.Tensor
    hit: torch.Tensor         # [R, 11] p, n, refl, transp, emit, ior, id


def level(o, d, running, u, rows, mirror_threshold: float) -> Level:
    """One bounce of every lane: nearest hit by ``|t|`` with nothing
    suppressed (the sphere's values chosen in the sweep), direct light of
    every emissive sphere but the hit one (no shadow test), the mirror
    reflection or, from ``u [R, 2]`` (None: none possible), the cosine
    bounce, and the offset origin.  ``d``: unit directions."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    dev, dtype = ox.device, ox.dtype
    big = torch.finfo(dtype).max
    best_m = torch.full_like(ox, big)
    best_t = torch.full_like(ox, big)
    best_i = torch.zeros(ox.shape, dtype=torch.int32, device=dev)
    zf = lambda: torch.zeros_like(ox)  # noqa: E731
    zb = lambda: torch.zeros(ox.shape, dtype=torch.bool, device=dev)  # noqa
    bc = [zf(), zf(), zf()]
    col = [zf(), zf(), zf()]
    em, sm, mr = zb(), zb(), zb()
    mat = [zf() for _ in range(5)]
    found = zb()
    for s, row in enumerate(rows):
        lx, ly, lz = row.cx - ox, row.cy - oy, row.cz - oz
        tca = lx * dx + ly * dy + lz * dz
        d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca, 0.0)
        thc = sqrt(torch.clamp_min(row.r * row.r - d2, 0.0))
        t = tca - thc
        valid = (tca >= 0.0) & (sqrt(d2) <= row.r)
        m = torch.abs(t)
        better = valid & (m < best_m)
        best_m = torch.where(better, m, best_m)
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, s, best_i)
        bc = [torch.where(better, v, b) for v, b in
              zip((row.cx, row.cy, row.cz), bc)]
        col = [torch.where(better, v, c) for v, c in
               zip((row.colr, row.colg, row.colb), col)]
        is_em = row.emit > 0
        em = torch.where(better, is_em, em)
        sm = torch.where(better, is_em and row.r < SMALL_LIGHT_RADIUS, sm)
        mr = torch.where(better, row.refl > mirror_threshold, mr)
        mat = [torch.where(better, float(v), c) for v, c in
               zip((row.refl, row.transp, row.emit, row.ior, row.id), mat)]
        found = found | valid
    px, py, pz = ox + dx * best_t, oy + dy * best_t, oz + dz * best_t
    nx, ny, nz = normalise_c(px - bc[0], py - bc[1], pz - bc[2])

    found = running & found
    emis = found & em
    mirror = found & ~emis & mr
    cont = mirror | (found & ~emis & ~mirror)

    direct = [zf(), zf(), zf()]
    for s in emissive_of(rows):
        row = rows[s]
        tx, ty, tz = row.cx - px, row.cy - py, row.cz - pz
        dist = sqrt(tx * tx + ty * ty + tz * tz)
        den = torch.clamp_min(dist, 1e-20)
        cosang = (tx / den) * nx + (ty / den) * ny + (tz / den) * nz
        w = (torch.clamp_min(cosang, 0.0)
             / torch.clamp_min(dist * dist, 1e-30) * DIRECT_SCALE)
        w = torch.where(best_i != s, w, 0.0)
        direct = [dl + torch.trunc(w * c) for dl, c in
                  zip(direct, (row.colr, row.colg, row.colb))]
    rlx, rly, rlz = reflect_c(dx, dy, dz, nx, ny, nz)
    if u is None:
        dfx, dfy, dfz = rlx, rly, rlz
    else:
        u = u.to(dtype)
        theta = torch.acos(sqrt(u[:, 0]))
        phi = 2.0 * math.pi * u[:, 1]
        dfx, dfy, dfz = local_to_world_c(theta, phi, nx, ny, nz)
    o_next = torch.stack([torch.where(cont, p + n * OFFSET, c) for p, n, c in
                          ((px, nx, ox), (py, ny, oy), (pz, nz, oz))], -1)
    d_next = torch.stack([torch.where(cont, torch.where(mirror, r, f), c)
                          for r, f, c in ((rlx, dfx, dx), (rly, dfy, dy),
                                          (rlz, dfz, dz))], -1)
    state = (running * ST_RUNNING + found * ST_FOUND + emis * ST_EMISSIVE
             + (found & sm) * ST_SMALL + mirror * ST_MIRROR
             + cont * ST_CONT).to(torch.uint8)
    rec = torch.stack([torch.where(found, c, 0.0) for c in col]
                      + [torch.where(cont, c, 0.0) for c in direct], -1)
    hit = torch.stack([torch.where(cont, c, 0.0) for c in
                       (px, py, pz, nx, ny, nz, *mat)], -1)
    return Level(state, rec, o_next, d_next, hit)


def observation(hit: torch.Tensor, d: torch.Tensor, lvl: int,
                max_bounces: int) -> torch.Tensor:
    """The 22-D FB observation the tracers build: point, incoming
    direction, normal, material, colour 0, bounce ``lvl / max_bounces``,
    through 0, id/100, pad 0.5."""
    px, py, pz, nx, ny, nz, refl, transp, emit, ior, sid = hit.unbind(1)
    zero = torch.zeros_like(px)
    half = torch.full_like(px, 0.5)
    frac = div_scalar(torch.full_like(px, float(lvl)), float(max_bounces))
    return torch.stack([px, py, pz, *d.unbind(1), nx, ny, nz, refl, transp,
                        emit, ior, zero, zero, zero, frac, zero,
                        div_scalar(sid, 100.0), half, half, half], dim=-1)


def fold(levels, background) -> torch.Tensor:
    """The reverse fold, deepest level first: ``trunc(albedo · min(255,
    direct + child) / 255)`` on continuing lanes, the light's colour on
    emissive ones, the background on a miss."""
    state, rec0 = levels[0]
    v = [torch.full(state.shape, float(b), dtype=rec0.dtype,
                    device=state.device) for b in background]
    for st, rec in reversed(levels):
        emis = (st & ST_EMISSIVE) != 0
        cont = (st & ST_CONT) != 0
        miss = ((st & ST_RUNNING) != 0) & ~emis & ~cont
        for c in range(3):
            a, dl = rec[:, c], rec[:, 3 + c]
            comb = torch.trunc(div_scalar(
                a * torch.clamp_max(dl + v[c], 255.0), 255.0))
            v[c] = torch.where(cont, comb, v[c])
            v[c] = torch.where(emis, a, v[c])
            v[c] = torch.where(miss, float(background[c]), v[c])
    return torch.stack(v, dim=-1)


# -- the trace and the frame -------------------------------------------------

LevelHook = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                      Optional[torch.Tensor], Level], None]


def trace(o, d, rows, *, max_bounces: int, mirror_threshold: float,
          background, uniforms=None, fb_uniforms=None, guide=None,
          fb_prob: float = 1.0, guide_max_level: Optional[int] = None,
          on_level: Optional[LevelHook] = None):
    """Trace ``[R]`` rays to integer-valued sample colours ``[R, 3]`` and
    per-ray counts ``[R, 6]`` int32 (levels running plus one for a ray
    still running after the last, hits, emissive hits, small-light hits,
    guided bounces, guided bounces of rays that ended on a light).

    ``guide``: ``obs [R, 22] -> action [R, 2]``, run on every lane's
    observation of a guided level and taken where the lane is diffuse and
    its fb uniform is below ``fb_prob``; ``guide_max_level=K``: levels from
    ``K`` on are not guided.  ``on_level(o, d, running, u, level)`` sees
    each level (the work counters)."""
    R, dev = o.shape[0], o.device
    if no_diffuse_possible(rows, mirror_threshold):
        uniforms = fb_uniforms = guide = None
    d = torch.stack(normalise_c(*d.unbind(1)), dim=-1)
    running = torch.ones(R, dtype=torch.bool, device=dev)
    counts = torch.zeros((R, 6), dtype=torch.int32, device=dev)
    term_emis = torch.zeros(R, dtype=torch.bool, device=dev)
    levels = []
    for lvl in range(max_bounces):
        u = None if uniforms is None else uniforms[lvl]
        lv = level(o, d, running, u, rows, mirror_threshold)
        if on_level is not None:
            on_level(o, d, running, u, lv)
        st = lv.state
        emis = (st & ST_EMISSIVE) != 0
        cont = (st & ST_CONT) != 0
        d_next = lv.d_next
        if guide is not None and (guide_max_level is None
                                  or lvl < guide_max_level):
            use = cont & ((st & ST_MIRROR) == 0) & (fb_uniforms[lvl]
                                                    < fb_prob)
            h = lv.hit
            act = torch.clamp(guide(observation(h, d, lvl, max_bounces)),
                              -1.0, 1.0).to(h.dtype)
            g = action_to_direction_c(act[:, 0], act[:, 1], h[:, 3],
                                      h[:, 4], h[:, 5])
            d_next = torch.where(use[:, None], torch.stack(g, dim=-1),
                                 d_next)
            counts[:, 4] += use
        counts[:, 0] += running
        counts[:, 1] += (st & ST_FOUND) != 0
        counts[:, 2] += emis
        counts[:, 3] += (st & ST_SMALL) != 0
        term_emis |= emis
        levels.append((st, lv.rec))
        o, d, running = lv.o_next, d_next, cont
    counts[:, 0] += running
    counts[:, 5] = torch.where(term_emis, counts[:, 4], 0)
    return fold(levels, background), counts


COUNTERS = ("total_rays", "total_intersections", "light_hits",
            "small_light_hits", "fb_used", "fb_success")


def frame(planes: dict, rows, *, width: int, height: int, spp: int,
          max_bounces: int, fov: float, camera, mirror_threshold: float,
          background, guide=None, fb_prob: float = 1.0,
          guide_max_level: Optional[int] = None, dtype=torch.float32,
          on_level: Optional[LevelHook] = None):
    """One frame: ``(image [H, W, 3] float32 in [0, 1], counters [6]
    int64)``; ``planes``: ``jitter [spp, H, W, 2]`` and, where drawn,
    ``uniforms [L, R, 2]`` and ``fb_uniforms [L, R]``."""
    o, d = camera_rays(planes["jitter"], width, height, fov, camera, dtype)
    rgb, counts = trace(o, d, rows, max_bounces=max_bounces,
                        mirror_threshold=mirror_threshold,
                        background=background,
                        uniforms=planes.get("uniforms"),
                        fb_uniforms=planes.get("fb_uniforms"), guide=guide,
                        fb_prob=fb_prob, guide_max_level=guide_max_level,
                        on_level=on_level)
    total = rgb.float().reshape(spp, height, width, 3).sum(dim=0)
    pixel = torch.floor(div_scalar(total, float(spp)))
    image = torch.clamp_max(div_scalar(pixel, 255.0), 1.0)
    return image, counts.sum(dim=0, dtype=torch.int64)
