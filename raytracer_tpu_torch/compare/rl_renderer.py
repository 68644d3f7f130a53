"""RL-guided renderer: the reference's ``RayTracerRL``
(RL/ray_tracer_rl_test.py:10-366).

Counterpart of ``raytracer_tpu/compare/rl_renderer.py``.  Renders the fixed
six-sphere test scene with a trained policy choosing each bounce's
direction, or uniform hemisphere directions as the control.  Each bounce
re-traces with the full Whitted tracer (a fresh bounce budget); shading is
ambient 0.1 plus two hard-coded lights' diffuse terms (0.4 and 0.3), each
gated by a shadow trace whose terminus's own segment distance is compared
with the light's; emissive surfaces shade at 1.0; colours accumulate with
the reference's rounding a bounce.

All three traces of a bounce start at a camera entry (no resumed chain), so
``impl="kernel"`` sends them through the Whitted kernel
(``csrc/whitted_trace.cu``); ``impl="plain"`` keeps them in plain PyTorch.
The uniform control's draws come in as ``uniforms [spp, max_bounces, R,
2]`` or from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..core import vec
from ..core.device import resolve_device
from ..scene.types import Scene, SceneBuilder
from ..trace import sampling
from ..trace.whitted import trace_whitted

LIGHT1 = (0.0, 6.0, -8.0)
LIGHT2 = (-4.0, 5.0, -8.0)


def create_test_scene(device=None) -> Scene:
    """The fixed test scene (RL/ray_tracer_rl_test.py:24-43)."""
    b = SceneBuilder()
    b.add_sphere((0, -5, -15), 10, (180, 180, 180), emitive=0.1, id=1)
    b.add_sphere((0, 0, -10), 1.5, (255, 255, 255), reflective=1.0, id=2)
    b.add_sphere((-3, 0.5, -10), 1.2, (180, 180, 255), reflective=1.0, id=3)
    b.add_sphere((3, -0.3, -10), 1.2, (255, 180, 180), reflective=1.0, id=4)
    b.add_sphere((0, 6, -8), 1.0, (255, 255, 200), emitive=1.0, id=99)
    b.add_sphere((-4, 5, -8), 0.8, (200, 255, 200), emitive=1.0, id=100)
    scene, _, _ = b.build(device)
    return scene


def bounce(scene: Scene, o, d, running, acc, *, max_bounces: int,
           impl: str = "kernel"):
    """One guided-render bounce: the Whitted trace, the two lights' shadow
    traces (``max_bounces=1``, the hit sphere suppressed) and the
    simplified shading.  Returns ``(res, hit, acc)``."""
    res = trace_whitted(scene, o, d, max_bounces=max_bounces, impl=impl)
    hit = running & res.hit
    point = res.point.contiguous()
    shadow_o = (res.point + res.normal * 0.001).contiguous()
    sid = scene.id[res.idx]

    def light_vis(lpos):
        to_l = torch.tensor(lpos, dtype=o.dtype, device=o.device)[None] \
            - point
        dist = vec.magnitude(to_l)
        to_l_n = vec.normalise_safe(to_l)
        sres = trace_whitted(scene, shadow_o, to_l_n.contiguous(),
                             max_bounces=1, suppress_id=sid, impl=impl)
        blocked = sres.hit & (sres.t < dist)
        cos = torch.clamp_min(vec.dot(res.normal, to_l_n), 0.0)
        return ~blocked, cos

    v1, c1 = light_vis(LIGHT1)
    v2, c2 = light_vis(LIGHT2)
    diffuse = torch.where(v1, 0.4 * c1, 0.0) + torch.where(v2, 0.3 * c2, 0.0)
    emis = scene.emitive[res.idx] > 0
    brightness = torch.where(emis, 1.0, 0.1 + diffuse)
    shade = torch.round(scene.colour[res.idx] * brightness[:, None])
    acc = torch.where(hit[:, None], acc + shade, acc)
    return res, hit, acc


def draw_uniforms(spp: int, max_bounces: int, rays: int,
                  generator: torch.Generator, device) -> torch.Tensor:
    """The uniform control's draws ``[spp, max_bounces, R, 2]``."""
    return torch.rand((spp, max_bounces, rays, 2), generator=generator,
                      device=device)


def render_guided(scene: Scene, policy: Optional[Callable],
                  uniforms: Optional[torch.Tensor] = None, *,
                  width: int = 400, height: int = 300, fov: float = 90.0,
                  max_bounces: int = 5, spp: int = 1,
                  generator: Optional[torch.Generator] = None,
                  impl: str = "kernel") -> torch.Tensor:
    """Render with the policy choosing each bounce (``policy`` None: the
    uniform control, on ``uniforms`` or draws from ``generator``).
    ``policy(obs [R, 18]) -> [R, 2]`` in the env's action convention.
    Returns the ``[H, W, 3]`` float32 image, 0..255, on the scene's
    device."""
    from ..render.camera import perspective_rays

    dev = scene.device
    R = width * height
    if policy is None and uniforms is None:
        uniforms = draw_uniforms(spp, max_bounces, R, generator, dev)
    total = None
    for s in range(spp):
        o, d = perspective_rays(width, height, fov=fov, origin=(0, 0, 0),
                                variant="env", device=dev)
        o = o.contiguous()
        d = vec.normalise_safe(d)
        running = torch.ones((R,), dtype=torch.bool, device=dev)
        acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        for b in range(max_bounces):
            res, hit, acc = bounce(scene, o, d, running, acc,
                                   max_bounces=max_bounces, impl=impl)
            running = hit
            if not bool(running.any()):
                break
            if policy is not None:
                obs = torch.cat([
                    res.point, d, res.normal,
                    scene.reflective[res.idx][:, None],
                    scene.transparent[res.idx][:, None],
                    scene.emitive[res.idx][:, None],
                    scene.ior[res.idx][:, None],
                    torch.zeros((R, 3), device=dev),
                    torch.full((R, 1), float(b), device=dev),
                    torch.zeros((R, 1), device=dev)], dim=-1)
                action = torch.as_tensor(policy(obs), dtype=torch.float32,
                                         device=dev)
                new_d = sampling.env_action_to_direction(action, res.normal,
                                                         "env")
            else:
                u = uniforms[s, b]
                theta = vec.div_scalar(u[:, 0] * math.pi, 2.0)
                phi = u[:, 1] * 2 * math.pi
                new_d = sampling.local_to_world(theta, phi, res.normal,
                                                "env")
            run3 = running[:, None]
            o = torch.where(run3, res.point + res.normal * 0.001, o)
            d = torch.where(run3, new_d, d)
        total = acc if total is None else total + acc
    img = total
    if spp > 1:
        img = torch.trunc(vec.div_scalar(img, float(spp)))
    return torch.clamp(img, 0, 255).reshape(height, width, 3)


class RayTracerRL:
    """The reference class: a policy if its checkpoint loads, uniform
    sampling otherwise (:12-19), and the two render entry points."""

    def __init__(self, model_path: Optional[str] = "raytracer_final",
                 algo: str = "sac", seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.scene = create_test_scene(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.rl_model = None
        self.use_rl = False
        if model_path and Path(str(model_path)).exists():
            try:
                self.rl_model = self._load_policy(model_path, algo)
                self.use_rl = True
            except (OSError, ValueError, KeyError, RuntimeError) as e:
                print(f"RL model load failed ({e!r}); "
                      "using traditional sampling")
        else:
            print("RL model not found, using traditional sampling")

    def _load_policy(self, path, algo):
        from ..env.raytracer_env import RayTracerEnv
        env = RayTracerEnv(self.scene, image_width=400, image_height=300,
                           fov=90, max_bounces=5, variant="rl")
        if algo == "sac":
            from ..agents.sac import SACTrainer
            tr = SACTrainer(env, seed=0)
        else:
            from ..agents.ppo import PPOTrainer
            tr = PPOTrainer(env, seed=0)
        tr.load(path)
        return lambda obs: tr.predict(obs, deterministic=True)

    def render_single_view(self, width=400, height=300, use_rl=True):
        policy = self.rl_model if (use_rl and self.use_rl) else None
        img = render_guided(self.scene, policy, width=width, height=height,
                            generator=self.generator)
        return img.cpu().numpy()

    def render_comparison(self, width=400, height=300,
                          out_path="rl_vs_traditional_comparison.png"):
        """The guided and the uniform image as JAX's titled two-panel
        matplotlib figure; without matplotlib the two images side by side
        in one PNG, and a printed line saying the figure was not drawn."""
        from ..utils.figures import figure_or_note
        rl_img = self.render_single_view(width, height, use_rl=True)
        trad_img = self.render_single_view(width, height, use_rl=False)
        if not figure_or_note(self.comparison_figure, rl_img, trad_img,
                              out_path, name=str(out_path)):
            from ..utils.io import save_image
            save_image(out_path, np.concatenate([rl_img, trad_img],
                                                axis=1).astype(np.uint8))
        return rl_img, trad_img

    def comparison_figure(self, rl_img, trad_img, out_path):
        """The two renders, titled, 12x5 in at 120 dpi."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
        a1.imshow(rl_img.astype(np.uint8))
        a1.set_title("RL-guided" if self.use_rl else "RL (fallback)")
        a1.axis("off")
        a2.imshow(trad_img.astype(np.uint8))
        a2.set_title("Traditional")
        a2.axis("off")
        plt.tight_layout()
        plt.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
