"""Batched trajectory generation for FB training.

Counterpart of ``raytracer_tpu/fb/trajectory.py::generate_trajectories``
(``RayTracedComplexTrainer.generate_trajectory``,
FB/train_complex_only.py:254-348): ``W`` walkers each start at a surface
point of a non-light sphere and take up to ``max_steps`` random-walk steps,
recording ``(obs, action, next_obs, reward ∈ {0, 1}, hit_light)``
transitions until a light is hit, the ray escapes or the budget runs out.

The details are JAX's: the pole-biased (θ ~ U[0, 2π], φ ~ U[0, π]) surface
draw, cosine-weighted steps in the "trainer" tangent frame,
``direction_to_action``'s hemisphere clamp, the 0.001 normal offset, the
current sphere suppressed by id, ``|t|`` ordering, and the colour features
that stay black but on the terminal light hit.  ``jax.lax.scan`` becomes a
loop over the steps; each step's sweep is
``core/cuda_intersect.py::nearest_hit`` (``by_abs=True``, the current
sphere's id suppressed): the nearest-hit kernel on the card, its plain
version on the CPU.  A walker that leaves an open template near +z finds a
pad dummy (``scene/templates.py::pad_scene``) at ``t`` ≈ 1e9, as JAX's does.

Randomness comes in as planes (``WalkDraws``), in JAX's key schedule
(:101-160): ``jax.random.categorical`` is ``argmax(logits + gumbel)``, so
the start spheres take a Gumbel plane ``[W, N]``.  ``draw_walk`` draws
them with a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..core import cuda_intersect, vec
from ..scene.types import Scene
from ..trace import sampling
from ..trace.path import make_observation

WALL_R = 5.0
START_BIASES = ("uniform", "small", "mixed")


class TrajectoryBatch(NamedTuple):
    obs: torch.Tensor          # [T, W, 22]
    action: torch.Tensor       # [T, W, 2]
    next_obs: torch.Tensor     # [T, W, 22]
    reward: torch.Tensor       # [T, W]
    hit_light: torch.Tensor    # [T, W] bool
    hit_small: torch.Tensor    # [T, W] bool: the light has radius < 0.5
    valid: torch.Tensor        # [T, W] bool
    episode_hit: torch.Tensor  # [W] bool: the walker reached a light


@dataclasses.dataclass(frozen=True)
class WalkDraws:
    """Every draw of one ``generate_trajectories`` call, as JAX's key
    schedule takes them from ``k_start, k_point, k_dir, k_walk =
    split(key, 4)``:

    * ``start_gumbel [W, N]`` (``k_start``: the start spheres);
    * ``point_u [W, 2]`` (``k_point``: ``uniform_on_sphere``);
    * ``dir_u [W, 2]`` (``k_dir``: the first incoming direction);
    * ``step_u [T, W, 2]`` (each step's ``k1``: the cosine step);
    * "mixed" only, from ``split(k_point, 4)[1:]``: ``wall_gumbel [W, N]``,
      ``mix_u [W]``, ``target_u [W, 3]``;
    * guided only, from each step's ``split(k2, 3)[1:]``: ``guide_normal
      [T, W, 2]`` (standard normal) and ``guide_u [T, W]``."""

    start_gumbel: torch.Tensor
    point_u: torch.Tensor
    dir_u: torch.Tensor
    step_u: torch.Tensor
    wall_gumbel: Optional[torch.Tensor] = None
    mix_u: Optional[torch.Tensor] = None
    target_u: Optional[torch.Tensor] = None
    guide_normal: Optional[torch.Tensor] = None
    guide_u: Optional[torch.Tensor] = None


def _gumbel(shape, generator, device):
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def draw_walk(num_walkers: int, num_spheres: int, max_steps: int, *,
              start_bias: str = "uniform", guided: bool = False,
              generator: torch.Generator, device) -> WalkDraws:
    """The planes of one walk drawn by ``generator`` on ``device``."""
    W, N, T = num_walkers, num_spheres, max_steps

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    kw = {}
    if start_bias == "mixed":
        kw = dict(wall_gumbel=_gumbel((W, N), generator, device),
                  mix_u=rand(W), target_u=rand(W, 3))
    if guided:
        kw.update(guide_normal=torch.randn((T, W, 2), generator=generator,
                                           device=device),
                  guide_u=rand(T, W))
    return WalkDraws(start_gumbel=_gumbel((W, N), generator, device),
                     point_u=rand(W, 2), dir_u=rand(W, 2),
                     step_u=rand(T, W, 2), **kw)


def _start(scene: Scene, draws: WalkDraws, start_bias: str,
           wall_frac: float):
    """Start spheres, points, normals (JAX :101-146)."""
    emissive = scene.emitive > 0
    real = scene.radius > 0
    ninf = torch.tensor(float("-inf"), dtype=scene.radius.dtype,
                        device=scene.device)
    if start_bias in ("small", "mixed"):
        logits = torch.where(emissive | ~real, ninf,
                             -torch.log1p(scene.radius))
        if start_bias == "mixed":
            logits = torch.where(scene.radius >= WALL_R, ninf, logits)
    else:
        logits = torch.where(emissive | ~real, ninf, 0.0)
    idx0 = torch.argmax(draws.start_gumbel + logits, dim=-1)
    point0, normal0 = sampling.uniform_on_sphere(
        draws.point_u, scene.centre[idx0], scene.radius[idx0])
    if start_bias == "mixed":
        wall = real & ~emissive & (scene.radius >= WALL_R)
        core = real & (scene.radius < WALL_R)
        big = torch.tensor(1e30, dtype=scene.centre.dtype,
                           device=scene.device)
        lo = torch.where(core[:, None], scene.centre, big).amin(0)
        hi = torch.where(core[:, None], scene.centre, -big).amax(0)
        mid, half = (lo + hi) * 0.5, (hi - lo) * 0.5 + 1.0
        target = mid + (draws.target_u * 2.0 - 1.0) * half * 2.5
        wall_logits = torch.where(wall, 0.0, ninf)
        idx_w = torch.argmax(draws.wall_gumbel + wall_logits, dim=-1)
        wc = scene.centre[idx_w]
        delta = target - wc
        dx, dy, dz = delta.unbind(-1)
        n = torch.clamp_min(vec.sqrt(dx * dx + dy * dy + dz * dz), 1e-9)
        nrm = delta / n[:, None]
        frac = torch.tensor(wall_frac, dtype=scene.centre.dtype)
        use_wall = ((draws.mix_u < frac) & wall.any() & core.any())
        idx0 = torch.where(use_wall, idx_w, idx0)
        point0 = torch.where(use_wall[:, None],
                             wc + nrm * scene.radius[idx_w][:, None], point0)
        normal0 = torch.where(use_wall[:, None], nrm, normal0)
    return idx0, point0, normal0


def generate_trajectories(scene: Scene, draws: WalkDraws, *,
                          max_steps: int = 8, start_bias: str = "uniform",
                          guide: Optional[Callable] = None,
                          guide_prob: float = 0.0, guide_noise: float = 0.1,
                          wall_frac: float = 0.35,
                          table: Optional[cuda_intersect.SphereTable] = None
                          ) -> TrajectoryBatch:
    """The walk of ``W`` walkers (JAX ``generate_trajectories`` :47) on the
    scene's device.  ``start_bias``: "uniform" (the reference's
    ``random.choice(non_light)``), "small" (start spheres weighted by
    1/(1+r)) or "mixed" ("small", but ``wall_frac`` of the walkers start on
    a wall sphere, r ≥ 5, facing the scene core).  ``guide(obs [W, 22]) ->
    mean [W, 2]``: the live policy, followed with probability
    ``guide_prob`` a step with ``guide_noise`` Gaussian noise on its
    action.  ``table``: the scene's ``sphere_table`` (built when None)."""
    if start_bias not in START_BIASES:
        raise ValueError(f"unknown start_bias {start_bias!r}")
    if guide is not None and draws.guide_u is None:
        raise ValueError("a guided walk needs guide_normal and guide_u")
    if table is None:
        table = cuda_intersect.sphere_table(scene)
    dtype = scene.centre.dtype
    W = draws.point_u.shape[0]
    emissive = scene.emitive > 0
    idx, point, normal = _start(scene, draws, start_bias, wall_frac)
    incoming0 = sampling.cosine_weighted(draws.dir_u, normal, "trainer")
    bounce0 = torch.zeros((W,), dtype=dtype, device=scene.device)
    obs = make_observation(point, normal, incoming0, bounce0,
                           torch.zeros((W, 3), dtype=dtype,
                                       device=scene.device),
                           scene, idx, max_steps)
    active = torch.ones((W,), dtype=torch.bool, device=scene.device)
    recs = []
    for t in range(max_steps):
        next_dir = sampling.cosine_weighted(draws.step_u[t], normal,
                                            "trainer")
        action = sampling.direction_to_action(next_dir, normal, "trainer")
        if guide is not None:
            g_mean = guide(obs)
            g_action = torch.clamp(
                g_mean + guide_noise * draws.guide_normal[t], -1.0, 1.0)
            g_dir = sampling.fb_action_to_direction(g_action, normal,
                                                    "trainer")
            use_g = (draws.guide_u[t] < guide_prob)[:, None]
            action = torch.where(use_g, g_action, action)
            next_dir = torch.where(use_g, g_dir, next_dir)
        o = (point + normal * 0.001).contiguous()
        next_dir = next_dir.contiguous()
        hit_t, hit_idx, found = cuda_intersect.nearest_hit(
            o, next_dir, scene.id[idx].contiguous(), table, by_abs=True)
        hit_idx = hit_idx.long()
        # JAX nearest_hit_c: the point at t (float32 max on a miss), the
        # normal against the hit centre (0 where nothing was found).
        h_point = o + next_dir * hit_t[:, None]
        centre = torch.where(found[:, None], scene.centre[hit_idx], 0.0)
        h_normal = torch.stack(vec.normalise_safe_c(
            *(h_point - centre).unbind(-1)), dim=-1)
        hit_light = found & emissive[hit_idx]
        hit_small = hit_light & (scene.radius[hit_idx] < 0.5)
        reward = torch.where(hit_light, 1.0, 0.0).to(dtype)
        colour = torch.where(hit_light[:, None],
                             scene.colour[hit_idx].to(dtype), 0.0)
        next_obs = make_observation(h_point, h_normal, next_dir, bounce0,
                                    colour, scene, hit_idx, max_steps)
        # The bounce feature of next_obs is (t + 1) / max_steps.
        next_obs[:, 16] = vec.div_scalar(
            torch.full((), t + 1.0, dtype=dtype, device=scene.device),
            float(max_steps))
        valid = active & found
        recs.append((obs, action, next_obs, reward, hit_light & valid,
                     hit_small & valid, valid))
        cont = valid & ~hit_light
        point = torch.where(cont[:, None], h_point, point)
        normal = torch.where(cont[:, None], h_normal, normal)
        idx = torch.where(cont, hit_idx, idx)
        obs = torch.where(cont[:, None], next_obs, obs)
        active = cont
    fields = [torch.stack(f) for f in zip(*recs)]
    return TrajectoryBatch(*fields, episode_hit=fields[4].any(dim=0))
