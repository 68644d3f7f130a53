"""Training-state checkpoints of the PPO and SAC trainers: resume where a
run stopped (the reference's "continue training" flow,
RL/train_raytracer_improved.py:397-409).

Counterpart of ``raytracer_tpu/utils/train_ckpt.py``, which saves with
orbax.  The port saves the modules' and optimisers' state dicts and the
counters with ``torch.save`` and reads them back with ``torch.load``
(``weights_only``): the file is the port's own and the JAX package cannot
read it.  The ``.npz`` policy files (``save``/``load`` of the trainers)
stay readable both ways.
"""
from __future__ import annotations

from pathlib import Path

import torch


def save_train_state(path, state: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)


def restore_train_state(path, device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def ppo_state(trainer) -> dict:
    return {"params": trainer.net.state_dict(),
            "opt_state": trainer.opt.state_dict(),
            "episode_rewards": list(trainer.episode_rewards)}


def resume_ppo(trainer, path) -> None:
    state = restore_train_state(path, trainer.device)
    trainer.load_state(state["params"])
    trainer.opt.load_state_dict(state["opt_state"])
    trainer.episode_rewards = list(state["episode_rewards"])


def sac_state(trainer) -> dict:
    return {"actor": trainer.actor.state_dict(),
            "critic": trainer.critic.state_dict(),
            "target": trainer.target_critic.state_dict(),
            "log_alpha": trainer.log_alpha.detach().clone(),
            "opts": [trainer.actor_opt.state_dict(),
                     trainer.critic_opt.state_dict(),
                     trainer.alpha_opt.state_dict()],
            "total_steps": trainer.total_steps,
            "episode_rewards": list(trainer.episode_rewards)}


def resume_sac(trainer, path) -> None:
    state = restore_train_state(path, trainer.device)
    trainer.load_states(state["actor"], state["critic"], state["target"])
    with torch.no_grad():
        trainer.log_alpha.copy_(state["log_alpha"])
    for opt, sd in zip((trainer.actor_opt, trainer.critic_opt,
                        trainer.alpha_opt), state["opts"]):
        opt.load_state_dict(sd)
    trainer.total_steps = int(state["total_steps"])
    trainer.episode_rewards = list(state["episode_rewards"])
