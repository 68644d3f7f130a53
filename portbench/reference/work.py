"""The work a frame needs, counted on the reference's own trace.

Frozen copies of the port's work counters (``tools/level_edges.py::
level_work`` and ``culled``, ``core/intersect.py::inside_threshold``,
``core/cuda_path.py::light_cut``) and of the f32 operation counts that
``chip_smoke.py`` reads off ``csrc/path_common.cuh``, with the flops of the
two guides.  The rooflines divide these by the card's peaks
(``portbench/peaks.py``).  An operation is one f32 add, multiply, compare,
square root or divide: a fused multiply-add would count two.
"""
from __future__ import annotations

import numpy as np
import torch

from . import plain

# f32 operations of the path level on its data: per sphere test (l, tca
# and its test), per test in front of the ray (d2 and its test), per valid
# test (r^2, thc, t, |t|, the nearest test); per light term of a
# continuing lane (t, d2, t.n, the cull test), per term not culled (the
# square root, three divides, cos, the weight, trunc and sum); per
# continuing lane (hit point, normal, offset, fold) and per mirror kept
# (the reflection); per ray the first normalisation.
OPS_SPHERE = 9
OPS_SPHERE_FRONT = 9
OPS_SPHERE_VALID = 7
OPS_LIGHT = 14
OPS_LIGHT_COMPUTED = 24
OPS_CONTINUE = 40
OPS_REFLECT = 42
OPS_PER_RAY = 10
# Per camera sample (the pinhole: two divides, five multiplies, four
# adds) and per pixel channel beyond the spp - 1 sums (the divide, floor,
# /255 and clamp).
OPS_CAMERA = 11
OPS_FOLD_CHANNEL = 4
# Bytes: the path kernels' rays in and rgb and counts out (4 counts, or 6
# guided), a diffuse ray-level's fb uniform (guided) and cosine uniforms;
# the level kernel's per-lane traffic (o, d, running in; state, rec,
# o_next, d_next out), its hit plane when asked, a diffuse lane's
# uniforms.
RAY_IN, RGB_OUT, COUNT = 24, 12, 4
UNIFORMS, FB_UNIFORM = 8, 4
LEVEL_LANE = 12 + 12 + 1 + 1 + 24 + 12 + 12
LEVEL_HIT = 44
CULL_MIN_D2 = 2.0 ** -60
LIGHT_CUT_MARGIN = 2.0 ** -10
F32_MAX = float(np.finfo(np.float32).max)


def student_row_flops(widths) -> int:
    """``widths``: (22, 128, 128, 2)."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def agent_row_flops(z: int, e: int, b: int, obs: int = 22,
                    action: int = 2) -> int:
    """The guide's products a row: the encoder's input, three residual
    blocks, the attention's value and out, Dense_1, Dense_2 to 2z; the
    backward model's input, two residual blocks and the mean head."""
    enc = obs * e + 3 * 2 * e * e + 2 * e * e + e * e + e * 2 * z
    bwd = 2 * z * b + 2 * 2 * b * b + b * action
    return 2 * (enc + bwd)


def inside_threshold(radius) -> np.ndarray:
    """The largest float32 ``x`` with ``sqrt(x) <= r``: the kernels' exact
    inside test without its square root."""
    r = np.asarray(radius, dtype=np.float32)
    inf = np.float32(np.inf)
    with np.errstate(over="ignore", invalid="ignore"):
        t = np.where(r > 0, r * r, np.float32(0.0)).astype(np.float32)
        step = (r > 0) & (r < inf)
        while True:
            down = step & (np.sqrt(t) > r)
            if not down.any():
                break
            t = np.where(down, np.nextafter(t, np.float32(0.0)), t)
        while True:
            nxt = np.nextafter(t, inf)
            up = step & (np.sqrt(nxt) <= r)
            if not up.any():
                break
            t = np.where(up, nxt, t)
    t = np.where(r == inf, inf, t)
    t = np.where(r < 0, -inf, t)
    return np.where(np.isnan(r), np.float32(np.nan), t).astype(np.float32)


def light_cut(colour) -> float:
    """A light's far cut on ``d2``: ``0.3 * max |colour| * (1 + 2^-10)``,
    at least ``2^-60``, float32."""
    c = np.abs(np.asarray(colour, dtype=np.float64))
    if not np.isfinite(c).all():
        return float("inf")
    return float(np.float32(max(0.3 * c.max() * (1.0 + LIGHT_CUT_MARGIN),
                                CULL_MIN_D2)))


def culled(cx, cy, cz, cut, px, py, pz, nx, ny, nz) -> torch.Tensor:
    """True where the kernels skip the light at ``(cx, cy, cz)`` as
    provably zero: past its cut, or behind the surface."""
    tx, ty, tz = cx - px, cy - py, cz - pz
    d2 = tx * tx + ty * ty + tz * tz
    ldotn = tx * nx + ty * ny + tz * nz
    nn = nx * nx + ny * ny + nz * nz
    kh = torch.clamp_min(nn * 2.0 ** -40, 2.0 ** -60)
    far = d2 > cut
    back = (ldotn < 0.0) & (ldotn * ldotn > kh * d2) & (cut <= F32_MAX)
    return ((nn <= F32_MAX) & (d2 > CULL_MIN_D2) & (d2 <= F32_MAX)
            & (far | back))


class Work:
    """Counts the levels of a trace as ``plain.trace`` hands them over
    (its ``on_level``), summed over every level and frame it sees."""

    KEYS = ("ray_levels", "continuing", "reflections", "diffuse",
            "sphere_tests", "front_sphere_tests", "valid_sphere_tests",
            "light_terms", "lights_computed", "levels")

    def __init__(self, rows):
        self.rows = rows
        self.emissive = plain.emissive_of(rows)
        self.inside = inside_threshold([s.r for s in rows]).tolist()
        self.cuts = [light_cut((rows[s].colr, rows[s].colg, rows[s].colb))
                     for s in self.emissive]
        self.totals = dict.fromkeys(self.KEYS, 0)

    def __call__(self, o, d, running, u, lv: plain.Level) -> None:
        st = lv.state.to(torch.int32)
        cont = (st & plain.ST_CONT) != 0
        n_run, n_cont = int(running.sum()), int(cont.sum())
        n_diffuse = 0 if u is None else int(
            (cont & ((st & plain.ST_MIRROR) == 0)).sum())
        ox, oy, oz = o.unbind(1)
        dx, dy, dz = d.unbind(1)
        front = valid = 0
        for row, t in zip(self.rows, self.inside):
            lx, ly, lz = row.cx - ox, row.cy - oy, row.cz - oz
            tca = lx * dx + ly * dy + lz * dz
            d2 = torch.clamp_min(lx * lx + ly * ly + lz * lz - tca * tca,
                                 0.0)
            ahead = running & (tca >= 0.0)
            front += int(ahead.sum())
            valid += int((ahead & (d2 <= t)).sum())
        hit = lv.hit[:, :6].unbind(1)
        lights = 0
        for s, cut in zip(self.emissive, self.cuts):
            row = self.rows[s]
            lights += int((cont & ~culled(row.cx, row.cy, row.cz, cut,
                                          *hit)).sum())
        t = self.totals
        t["levels"] += 1
        t["ray_levels"] += n_run
        t["continuing"] += n_cont
        t["reflections"] += n_cont - n_diffuse
        t["diffuse"] += n_diffuse
        t["sphere_tests"] += len(self.rows) * n_run
        t["front_sphere_tests"] += front
        t["valid_sphere_tests"] += valid
        t["light_terms"] += len(self.emissive) * n_cont
        t["lights_computed"] += lights


def level_ops(t: dict) -> int:
    """f32 operations the levels of ``t`` (``Work.totals``) need."""
    return (OPS_SPHERE * t["sphere_tests"]
            + OPS_SPHERE_FRONT * t["front_sphere_tests"]
            + OPS_SPHERE_VALID * t["valid_sphere_tests"]
            + OPS_LIGHT * t["light_terms"]
            + OPS_LIGHT_COMPUTED * t["lights_computed"]
            + OPS_CONTINUE * t["continuing"]
            + OPS_REFLECT * t["reflections"])
