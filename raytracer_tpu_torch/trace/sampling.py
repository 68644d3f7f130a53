"""Hemisphere sampling and tangent frames.

Counterpart of ``raytracer_tpu/trace/sampling.py`` with its three tangent
conventions, same op order as the JAX code:

* ``renderer`` (FB/fb_vs_traditional_complex.py:355-360), the path
  tracers': ``|n.z| > 0.9`` gives the tangent ``(1, 0, 0)`` directly,
  else ``cross((0, 0, 1), n) = (-ny, nx, 0)``;
* ``trainer`` (FB/train_complex_only.py:82-90), the FB learner's walk:
  ``|n.z| > 0.999`` gives ``cross((1, 0, 0), n) = (0, -nz, ny)``, else
  ``cross((0, 0, 1), n)``;
* ``env`` (RL/ray_tracer_env.py:166-173), the output5 experiment's rl and
  fb methods: ``trainer``'s rule at ``|n.z| > 0.9``.

The bitangent is ``normalise(cross(n, t))`` in all three.

RL env actions are ``(θ, φ) ∈ [0, π/2] × [0, 2π]`` already
(``env_action_to_direction``, RL/ray_tracer_env.py:113-119).  FB actions
are ``(a₀, a₁) ∈ [-1, 1]²`` with θ = (a₀+1)π/4, φ = a₁π
(``fb_action_to_direction``); ``direction_to_action`` is the inverse with
the hemisphere clamp (FB/train_complex_only.py:98-125).  Every function
that draws takes its uniforms as an input plane (``u [..., 2]`` in
``[0, 1)``, JAX ``random.uniform``'s layout), never a generator of its own.
"""
from __future__ import annotations

import math

import torch

from ..core import vec

_THRESHOLD = {"renderer": 0.9, "trainer": 0.999, "env": 0.9}


def _cross_c(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def tangent_frame_c(nx, ny, nz, convention: str = "renderer"):
    """Returns ``(tx, ty, tz, bx, by, bz)``."""
    if convention not in _THRESHOLD:
        raise ValueError(f"unknown tangent convention {convention!r}")
    zero = torch.zeros_like(nx)
    above = torch.abs(nz) > _THRESHOLD[convention]
    if convention == "renderer":
        ax_, ay_, az_ = torch.ones_like(nx), zero, zero
    else:
        ax_, ay_, az_ = zero, -nz, ny
    tx = torch.where(above, ax_, -ny)
    ty = torch.where(above, ay_, nx)
    tz = torch.where(above, az_, zero)
    tx, ty, tz = vec.normalise_safe_c(tx, ty, tz)
    cx, cy, cz = _cross_c(nx, ny, nz, tx, ty, tz)
    bx, by, bz = vec.normalise_safe_c(cx, cy, cz)
    return tx, ty, tz, bx, by, bz


def local_to_world_c(theta, phi, nx, ny, nz, convention: str = "renderer"):
    """Direction at polar ``theta`` / azimuth ``phi`` about ``n``, in world
    space.  Returns ``(wx, wy, wz)``."""
    tx, ty, tz, bx, by, bz = tangent_frame_c(nx, ny, nz, convention)
    st = torch.sin(theta)
    lx = st * torch.cos(phi)
    ly = st * torch.sin(phi)
    lz = torch.cos(theta)
    return vec.normalise_safe_c(lx * tx + ly * bx + lz * nx,
                                lx * ty + ly * by + lz * ny,
                                lx * tz + ly * bz + lz * nz)


def fb_action_to_direction_c(a0, a1, nx, ny, nz,
                             convention: str = "renderer"):
    """A guide's action (clipped to [-1, 1]) as a direction about ``n``:
    θ = (a₀+1)π/4, φ = a₁π.  Returns ``(wx, wy, wz)``."""
    theta = vec.div_scalar((a0 + 1.0) * math.pi, 4.0)
    phi = a1 * math.pi
    return local_to_world_c(theta, phi, nx, ny, nz, convention)


def _stack(c):
    return torch.stack(c, dim=-1)


def local_to_world(theta, phi, normal, convention: str = "renderer"):
    """``[...]`` polar and azimuth angles about ``[..., 3]`` normals,
    ``[..., 3]`` world directions out."""
    return _stack(local_to_world_c(theta, phi, *normal.unbind(-1),
                                   convention))


def env_action_to_direction(action, normal, convention: str = "env"):
    """The RL env's action, ``(θ, φ)`` ``[..., 2]``, as a direction about
    ``[..., 3]`` normals (JAX ``env_action_to_direction`` :145)."""
    return local_to_world(action[..., 0], action[..., 1], normal, convention)


def fb_action_to_direction(action, normal, convention: str = "renderer"):
    """``[..., 2]`` actions about ``[..., 3]`` normals, ``[..., 3]`` out."""
    return _stack(fb_action_to_direction_c(
        action[..., 0], action[..., 1], *normal.unbind(-1), convention))


def cosine_weighted(u, normal, convention: str = "renderer"):
    """Cosine-weighted hemisphere sample about ``normal [..., 3]`` from the
    uniforms ``u [..., 2]``: θ = arccos(√u₀), φ = 2π u₁ (JAX
    ``cosine_weighted`` :63 with its ``random.uniform`` draw as ``u``)."""
    theta = torch.acos(vec.sqrt(u[..., 0]))
    phi = 2.0 * math.pi * u[..., 1]
    return _stack(local_to_world_c(theta, phi, *normal.unbind(-1),
                                   convention))


def direction_to_action(direction, normal, convention: str = "trainer"):
    """World direction to an FB action in [-1, 1]² with the hemisphere
    clamp (JAX ``direction_to_action`` :150)."""
    tx, ty, tz, bx, by, bz = tangent_frame_c(*normal.unbind(-1), convention)
    dx, dy, dz = direction.unbind(-1)
    nx, ny, nz = normal.unbind(-1)
    lx = vec.dot_c(dx, dy, dz, tx, ty, tz)
    ly = vec.dot_c(dx, dy, dz, bx, by, bz)
    lz = vec.dot_c(dx, dy, dz, nx, ny, nz)
    theta = torch.acos(torch.clamp(lz, -1.0, 1.0))
    theta = torch.clamp_max(theta, math.pi / 2)
    phi = torch.atan2(ly, lx)
    a0 = vec.div_scalar(theta, math.pi / 2) * 2.0 - 1.0
    a1 = vec.div_scalar(phi, math.pi)
    return torch.stack([a0, a1], dim=-1)


def uniform_on_sphere(u, centre, radius):
    """Surface point and outward normal from the uniforms ``u [..., 2]``:
    the reference's pole-biased (θ ~ U[0, 2π], φ ~ U[0, π])
    parameterisation (FB/train_complex_only.py:54-65; JAX
    ``uniform_on_sphere`` :165).  Returns ``(point, offset)``, each
    ``[..., 3]``."""
    theta = 2.0 * math.pi * u[..., 0]
    phi = math.pi * u[..., 1]
    sp = torch.sin(phi)
    offset = torch.stack([sp * torch.cos(theta), sp * torch.sin(theta),
                          torch.cos(phi)], dim=-1)
    return centre + offset * radius[..., None], offset
