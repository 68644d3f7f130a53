"""Episodes that fire every term of the shaped RL env.

``agents/adaptive.py::AdaptiveRewardRayTracerEnv`` adds a light bonus, a
streak bonus, a reflective bonus and a short-path penalty to the base
env's reward, and rewrites a −0.1 miss to −0.5; its counters go on
advancing on a finished lane that rests on a light.  Random actions land
on the scenes' small lights too rarely for the streak and the finished
lanes to show within an episode, so ``light_seeking_actions`` picks, lane
by lane, the first action of a fixed ``(θ, φ)`` grid whose next hit is a
light (through the base env's own step on the grid's lanes).

``shaping_terms`` counts, for one shaped step, the lanes on which each
term fired.  ``chip_smoke.py`` (phase ``rl_shaped``) and
``tests/test_torch_rl_curriculum.py`` use both.  The −0.5 rewrite cannot
fire on the RL variant: its base step rewards a pre-move miss with −1.0
(0.0 once done), never −0.1; its count stays 0.
"""
from __future__ import annotations

import dataclasses
import math

import torch

TERMS = ("light_bonus", "streak_bonus", "reflective_bonus",
         "short_path_penalty", "miss_rewrite", "done_lane_count")


def action_grid(device=None) -> torch.Tensor:
    """``[128, 2]``: the centres of an 8 x 16 grid over the RL variant's
    action box ``[0, π/2] × [0, 2π]``."""
    th = (torch.arange(8, device=device) + 0.5) / 8 * (math.pi / 2)
    ph = (torch.arange(16, device=device) + 0.5) / 16 * (2 * math.pi)
    return torch.stack(torch.meshgrid(th, ph, indexing="ij"),
                       -1).reshape(-1, 2).to(torch.float32)


def light_seeking_actions(shaped, state, fallback: torch.Tensor):
    """``(actions [B, 2], found [B])``: for each lane of the shaped env's
    ``state`` the first grid action whose next hit is one of its light
    ids (the base env's step on the grid's lanes), else ``fallback``'s."""
    env, s = shaped.env, state.env
    grid = action_grid(env.device)
    K = grid.shape[0]
    B = s.hit.shape[0]
    rep = dataclasses.replace(s, **{
        f.name: getattr(s, f.name).repeat_interleave(K, 0)
        for f in dataclasses.fields(s)})
    nxt, _, _, _, _ = env.step(rep, grid.repeat(B, 1))
    lid = env.scene.id[nxt.idx]
    on = torch.zeros_like(nxt.hit)
    for l in shaped.light_ids:
        on = on | (lid == l)
    ok = (nxt.hit & on).reshape(B, K)
    found = ok.any(1)
    first = torch.argmax(ok.to(torch.int32), 1)
    return torch.where(found[:, None], grid[first], fallback), found


def shaping_terms(shaped, state, action, new_state) -> dict:
    """Lanes on which each of ``TERMS`` fired in the shaped step
    ``state --action--> new_state`` (the base step runs again for its
    reward).  Counts are ints."""
    s = state.env
    sc = shaped.env.scene
    _, _, base, _, _ = shaped.env.step(s, action)
    lid = sc.id[s.idx]
    is_light = torch.zeros_like(s.hit)
    for l in shaped.light_ids:
        is_light = is_light | (lid == l)
    is_light = is_light & s.hit
    live = ~s.done
    masks = {
        "light_bonus": is_light & live,
        "streak_bonus": is_light & live
        & (new_state.consecutive_light_hits > 1),
        "reflective_bonus": s.hit & (sc.reflective[s.idx] > 0.5) & live,
        "short_path_penalty": (s.bounce < 2) & (base > 0) & live,
        "miss_rewrite": ~s.hit & (base == -0.1) & live,
        "done_lane_count": is_light & s.done,
    }
    return {k: int(m.sum()) for k, m in masks.items()}
