"""Batched ray-tracing RL environment on tensors.

Counterpart of ``raytracer_tpu/env/raytracer_env.py``, both variants:

* ``variant="rl"`` (RL/ray_tracer_env.py:21-425): action (θ, φ) ∈
  [0, π/2] × [0, 2π]; reward = shading brightness at the *pre-move*
  intersection − 0.01·bounces; miss penalties −0.1 / −1.0.
* ``variant="fb"`` (FB/ray_tracer_env.py:21-538): action ∈ [-1, 1]² with
  θ = (a₀+1)π/4, φ = a₁π; +10 for being on or hitting the sun sphere
  (``sun_id``), else an ambient + cosine lighting reward with a one-sweep
  shadow test (0.3 … 1.0).

An episode is one pixel's light path.  ``reset`` traces the camera ray to
its Whitted terminus; each ``step`` resumes the chain from the current
hit with its id suppressed and the running bounce budget.  ``B`` episodes
advance together; lanes already done pass through with zero reward.

``impl="kernel"`` (the default): ``reset`` traces through the Whitted
kernel (``csrc/whitted_trace.cu``) and ``step`` through the plain level
loop with the nearest-hit kernel (``csrc/nearest_hit.cu``) once a level,
since the Whitted kernel traces from the camera entry only; shading runs
the shading kernel (``csrc/whitted_shade.cu``), its shadow sweeps
inside.  On CPU tensors every
kernel call runs its plain version.  ``impl="plain"`` keeps every trace
and sweep in plain PyTorch (the kernels' reference on the card).

Randomness comes in from outside: ``reset`` takes the pixels, or draws
them from a ``torch.Generator`` (JAX draws ``randint`` from its key).  The
camera's ``tan(fov/2)`` is the correctly rounded float32 value of the
float32 half-angle; XLA's float32 ``tan`` is not correctly rounded (one
ulp above it at fov 60 on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import vec
from ..scene.types import (GlobalLights, PointLights, Scene,
                           empty_global_lights, empty_point_lights)
from ..trace import sampling
from ..trace.shade import terminal_rgb
from ..trace.whitted import TraceResult, trace_whitted

OBS_DIM = 18


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Per-episode state, batched ``[B, ...]``."""

    pixel: torch.Tensor        # [B, 2] i64 (x, y)
    ray_o: torch.Tensor        # [B, 3]
    ray_d: torch.Tensor        # [B, 3]
    hit: torch.Tensor          # [B] bool: current intersection valid
    idx: torch.Tensor          # [B] i32
    point: torch.Tensor        # [B, 3]
    normal: torch.Tensor       # [B, 3]
    acc_colour: torch.Tensor   # [B, 3]
    bounce: torch.Tensor       # [B] i32
    through: torch.Tensor      # [B] i32
    total_reward: torch.Tensor # [B] f32
    done: torch.Tensor         # [B] bool


def _tensor(x, dtype, device) -> torch.Tensor:
    """A tensor, a numpy array or a nested sequence as a tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, dtype)


class RayTracerEnv:
    """Batched environment over a scene on one device (the scene's)."""

    def __init__(self, scene: Scene, *, image_width: int = 800,
                 image_height: int = 600, camera_position=(0.0, 0.0, 0.0),
                 camera_angle=(0.0, 0.0, 0.0), fov: float = 90.0,
                 max_bounces: int = 5, background=(0.0, 0.0, 0.0),
                 global_lights: Optional[GlobalLights] = None,
                 point_lights: Optional[PointLights] = None,
                 variant: str = "rl", sun_id: int = 7,
                 impl: str = "kernel"):
        if variant not in ("rl", "fb"):
            raise ValueError(f"unknown variant {variant!r}")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl {impl!r}")
        self.scene = scene
        self.device = dev = scene.device
        self.glights = (global_lights if global_lights is not None
                        else empty_global_lights(dev))
        self.plights = (point_lights if point_lights is not None
                        else empty_point_lights(dev))
        self.image_width = int(image_width)
        self.image_height = int(image_height)
        self.camera_position = torch.tensor(camera_position,
                                            dtype=torch.float32, device=dev)
        self.camera_angle = tuple(float(a) for a in camera_angle)
        self.fov = float(fov)
        self.max_bounces = int(max_bounces)
        self.background = tuple(float(b) for b in background)
        self.variant = variant
        self.sun_id = int(sun_id)
        self.impl = impl
        half_angle = np.float32(self.fov * math.pi / 180.0 / 2.0)
        self._half = float(np.float32(np.tan(np.float64(half_angle))))
        ids = scene.id.tolist()
        self._has_sun = self.sun_id in ids
        self._sun_i = ids.index(self.sun_id) if self._has_sun else 0
        self._sun_mask = scene.id == self.sun_id

    # -- camera (RL/ray_tracer_env.py:121-142; aspect applied once) --------
    def _initial_rays(self, pixel: torch.Tensor):
        f32 = torch.float32
        aspect = self.image_width / self.image_height
        x = pixel[:, 0].to(f32)
        y = pixel[:, 1].to(f32)
        px = (vec.div_scalar(2.0 * (x + 0.5), self.image_width) - 1.0) \
            * aspect * self._half
        py = (1.0 - vec.div_scalar(2.0 * (y + 0.5), self.image_height)) \
            * self._half
        d = vec.normalise_safe(torch.stack([px, py, -torch.ones_like(px)], -1))
        if any(a != 0.0 for a in self.camera_angle):
            d = vec.rotate_euler(d, *self.camera_angle)
        o = self.camera_position.expand_as(d).contiguous()
        return o, d

    # -- observation (RL/ray_tracer_env.py:184-222) ------------------------
    def _observation(self, s: EnvState) -> torch.Tensor:
        sc = self.scene
        f32 = torch.float32
        obs = torch.cat([
            s.point, s.ray_d, s.normal,
            sc.reflective[s.idx][:, None], sc.transparent[s.idx][:, None],
            sc.emitive[s.idx][:, None], sc.ior[s.idx][:, None],
            vec.div_scalar(s.acc_colour, 255.0),
            s.bounce[:, None].to(f32), s.through[:, None].to(f32)], dim=-1)
        return torch.where(s.hit[:, None], obs, 0.0)

    def _shade(self, res: TraceResult) -> torch.Tensor:
        """terminalRGB with max_bounces=0 (reward and colour)."""
        return terminal_rgb(self.scene, self.glights, self.plights, res,
                            self.background, shadow_max_bounces=0,
                            impl=self.impl)

    def _brightness(self, s: EnvState) -> torch.Tensor:
        """The RL variant's shading brightness at the current hit
        (RL/ray_tracer_env.py:224-252, before the bounce penalty)."""
        res = TraceResult(hit=s.hit, idx=s.idx, point=s.point,
                          normal=s.normal, t=torch.zeros_like(s.point[:, 0]),
                          bounces=s.bounce, through=s.through)
        rgb = self._shade(res)
        return vec.div_scalar(rgb[:, 0] + rgb[:, 1] + rgb[:, 2], 3.0 * 255.0)

    def _lighting_reward(self, hit, idx, point, normal) -> torch.Tensor:
        """The FB variant's ``_calculate_lighting_reward``
        (FB/ray_tracer_env.py:280-336): 0.3 ambient + 0.7·cos to the sun
        unless some sphere but the hit one and the sun lies between, by the
        near root's distance from the unoffset point; 0 on lights and
        misses, 0.1 with no sun.  An any-hit test over ``[B, N]``, not a
        nearest hit, so tensor ops."""
        sc = self.scene
        sun_c = sc.centre[self._sun_i]
        to_sun = sun_c[None, :] - point
        sun_dist = vec.magnitude(to_sun)
        to_sun_n = vec.normalise_safe(to_sun)
        cos = torch.clamp_min(vec.dot(normal, to_sun_n), 0.0)

        o = point + normal * 0.001
        L = sc.centre[None] - o[:, None, :]                      # [B, N, 3]
        dn = to_sun_n[:, None, :].expand_as(L)
        tca = vec.dot(L, dn)
        d2 = torch.clamp_min(vec.dot(L, L) - tca * tca, 0.0)
        r = sc.radius[None]
        thc = vec.sqrt(torch.clamp_min(r * r - d2, 0.0))
        t = tca - thc
        valid = (tca >= 0.0) & (vec.sqrt(d2) <= r)
        n = sc.num_spheres
        excl = ((torch.arange(n, device=o.device)[None, :] == idx[:, None])
                | self._sun_mask[None, :])
        valid = valid & ~excl
        hitp = o[:, None, :] + dn * t[..., None]
        sdist = vec.magnitude(hitp - point[:, None, :])
        in_shadow = (valid & (sdist < sun_dist[:, None])).any(dim=-1)

        reward = torch.where(in_shadow, 0.3, 0.3 + 0.7 * cos)
        if not self._has_sun:
            reward = torch.full_like(reward, 0.1)
        reward = torch.where(sc.emitive[idx] > 0, 0.0, reward)
        return torch.where(hit, reward, 0.0)

    # -- API ---------------------------------------------------------------
    def draw_pixels(self, batch: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """``[B, 2]`` uniform pixels ``(x, y)`` from ``generator`` (JAX
        draws them with ``randint`` from its reset key)."""
        kw = dict(device=self.device, generator=generator)
        px = torch.randint(0, self.image_width, (batch,), **kw)
        py = torch.randint(0, self.image_height, (batch,), **kw)
        return torch.stack([px, py], dim=-1)

    def reset(self, batch: int = 1, pixel=None, *,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[EnvState, torch.Tensor]:
        """``batch`` episodes at ``pixel`` (``[2]`` or ``[B, 2]``), or at
        pixels drawn from ``generator``."""
        B = batch
        dev = self.device
        if pixel is None:
            pixel = self.draw_pixels(B, generator)
        else:
            pixel = _tensor(pixel, torch.int64, dev).expand(B, 2)
            pixel = pixel.contiguous()
        o, d = self._initial_rays(pixel)
        res = trace_whitted(self.scene, o, d, max_bounces=self.max_bounces,
                            impl=self.impl)
        zf = torch.zeros((B,), dtype=torch.float32, device=dev)
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        state = EnvState(pixel=pixel, ray_o=o, ray_d=d, hit=res.hit,
                         idx=res.idx, point=res.point, normal=res.normal,
                         acc_colour=torch.zeros((B, 3), dtype=torch.float32,
                                                device=dev),
                         bounce=zi, through=zi, total_reward=zf,
                         done=torch.zeros((B,), dtype=torch.bool,
                                          device=dev))
        return state, self._observation(state)

    def step(self, state: EnvState, action):
        """Advance every episode one bounce.  Returns ``(state, obs,
        reward, terminated, info)``, ``info`` holding ``truncated``,
        ``bounce`` and ``total_reward``."""
        s = state
        sc = self.scene
        mb = self.max_bounces
        action = _tensor(action, torch.float32, self.device)
        missed = ~s.hit
        budget = s.hit & (s.bounce >= mb)
        sid = sc.id[s.idx]
        if self.variant == "fb":
            on_sun = s.hit & ~budget & (sid == self.sun_id)
        else:
            on_sun = torch.zeros_like(s.hit)
        moving = s.hit & ~budget & ~on_sun

        if self.variant == "rl":
            new_d = sampling.env_action_to_direction(action, s.normal, "env")
        else:
            new_d = sampling.fb_action_to_direction(action, s.normal, "env")
        new_bounce = torch.where(moving, s.bounce + 1, s.bounce)
        # A step resumes the chain, which the Whitted kernel does not: the
        # level loop, its sweep the nearest-hit kernel on impl="kernel".
        nxt = trace_whitted(sc, s.point, new_d, max_bounces=mb,
                            suppress_id=sid, bounces0=new_bounce,
                            through0=s.through, impl="plain",
                            sweep=self.impl)

        if self.variant == "rl":
            # Pre-move brightness (a reference quirk: the state is updated
            # only after the reward, RL/ray_tracer_env.py:361-369).
            brightness = self._brightness(s)
            move_reward = brightness - 0.01 * new_bounce.to(torch.float32)
            budget_reward = brightness - 0.01 * s.bounce.to(torch.float32)
            move_reward = torch.where(s.hit, move_reward, -0.1)
            budget_reward = torch.where(s.hit, budget_reward, -0.1)
            reward = torch.where(missed, -1.0,
                                 torch.where(budget, budget_reward,
                                             move_reward))
            terminated = missed | budget | (moving & ~nxt.hit)
            truncated = budget | (moving & nxt.hit & (new_bounce >= mb))
            terminated = terminated | truncated
        else:
            hit_sun_next = moving & nxt.hit & (sc.id[nxt.idx] == self.sun_id)
            lighting_next = self._lighting_reward(nxt.hit, nxt.idx,
                                                  nxt.point, nxt.normal)
            lighting_cur = self._lighting_reward(s.hit, s.idx, s.point,
                                                 s.normal)
            reward = torch.where(
                missed, -1.0, torch.where(
                    budget, lighting_cur, torch.where(
                        on_sun, 10.0, torch.where(
                            hit_sun_next, 10.0, torch.where(
                                moving & ~nxt.hit, -0.1, lighting_next)))))
            terminated = (missed | budget | on_sun | hit_sun_next
                          | (moving & ~nxt.hit)
                          | (moving & (new_bounce >= mb)))
            truncated = budget | (moving & nxt.hit & ~hit_sun_next
                                  & (new_bounce >= mb))

        # Colour from the new intersection (max_bounces=0 shade).
        step_rgb = self._shade(nxt)
        acc = torch.where((moving & nxt.hit)[:, None],
                          s.acc_colour + step_rgb, s.acc_colour)

        # Lanes already done: frozen, zero reward.
        reward = torch.where(s.done, 0.0, reward)
        terminated = torch.where(s.done, True, terminated)
        truncated = torch.where(s.done, False, truncated)

        # total_reward skips the miss branches and the FB already-on-sun
        # branch (RL/ray_tracer_env.py:313-323, FB/ray_tracer_env.py:
        # 420-430).
        accum = reward * (~missed & ~on_sun).to(reward.dtype)

        upd = moving & ~s.done
        u3 = upd[:, None]
        new_state = EnvState(
            pixel=s.pixel,
            ray_o=torch.where(u3, s.point, s.ray_o),
            ray_d=torch.where(u3, new_d, s.ray_d),
            hit=torch.where(upd, nxt.hit, s.hit),
            idx=torch.where(upd, nxt.idx, s.idx),
            point=torch.where(u3, nxt.point, s.point),
            normal=torch.where(u3, nxt.normal, s.normal),
            acc_colour=torch.where(u3, acc, s.acc_colour),
            bounce=torch.where(upd, new_bounce, s.bounce),
            through=torch.where(upd, nxt.through, s.through),
            total_reward=s.total_reward + accum,
            done=s.done | terminated,
        )
        obs = self._observation(new_state)
        info = {"truncated": truncated, "bounce": new_state.bounce,
                "total_reward": new_state.total_reward}
        return new_state, obs, reward, terminated, info
