"""stable-baselines3 ``.zip`` checkpoints to the port's RL modules.

Counterpart of ``raytracer_tpu/utils/sb3_import.py``: reads the archive
(``zipfile`` and ``torch.load`` of its ``policy.pth``, without
stable-baselines3) and renames the state dict onto ``agents/networks.py``'s
modules.  SB3's ``nn.Linear`` weights are ``[out, in]`` like the port's, so
nothing is transposed.

Actions at predict time (the JAX package's tests/test_sb3_import.py
oracle):

* SAC (squashed Gaussian): ``unscale(tanh(mu(latent_pi(obs))))``,
  ``unscale(a) = low + 0.5 (a + 1) (high - low)``, which is
  ``SACTrainer.predict``'s ``mid + scale * tanh(u)``;
* PPO (diagonal Gaussian, no squash): ``clip(action_net(policy_net(obs)),
  low, high)``, which is ``PPOTrainer.predict``.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch


def load_sb3_zip(path: str) -> Dict:
    """An SB3 save archive: ``{"policy": {name: float32 tensor}, "data":
    dict, "version": str}`` (``data`` is the hyperparameter JSON)."""
    out = {"policy": {}, "data": {}, "version": ""}
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if "policy.pth" not in names:
            raise ValueError(f"{path}: not an SB3 archive (no policy.pth)")
        sd = torch.load(io.BytesIO(z.read("policy.pth")),
                        map_location="cpu", weights_only=True)
        out["policy"] = {k: v.detach().to(torch.float32)
                         for k, v in sd.items()}
        if "data" in names:
            out["data"] = json.loads(z.read("data").decode())
        if "_stable_baselines3_version" in names:
            out["version"] = z.read("_stable_baselines3_version").decode()
    return out


def action_bounds(data: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Action-space low/high from the archive's metadata JSON (the reprs
    SB3 stores beside the pickled space)."""
    space = data.get("action_space", {})

    def parse(key):
        v = space.get(key)
        if not isinstance(v, str):
            return None
        return np.array(v.strip("[]").split(), dtype=np.float32)

    low, high = parse("low"), parse("high")
    if low is None or high is None or low.size == 0 or high.size == 0:
        raise ValueError("SB3 archive metadata has no parseable action "
                         "space bounds")
    return low, high


def _linear(sd: Dict, src: str, dst: str) -> Dict:
    return {f"{dst}.weight": sd[f"{src}.weight"],
            f"{dst}.bias": sd[f"{src}.bias"]}


def _trunk(sd: Dict, prefix: str, dst: str) -> Dict:
    layers = sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in sd
                     if k.startswith(prefix + ".") and k.endswith(".weight")})
    out = {}
    for i, layer in enumerate(layers):
        out.update(_linear(sd, f"{prefix}.{layer}", f"{dst}.Dense_{i}"))
    return out


def import_sac_policy(sd: Dict) -> Dict:
    """SB3 SAC ``policy.pth`` to ``{"actor", "critic", "target_critic"}``
    state dicts of ``SACActor`` / ``SACCritic`` (``MLP_0`` the latent_pi
    trunk, ``Dense_0`` μ, ``Dense_1`` log_std; critic ``MLP_q``/``Dense_q``
    the ``qf{q}`` trunk and head)."""
    actor = {**_trunk(sd, "actor.latent_pi", "MLP_0"),
             **_linear(sd, "actor.mu", "Dense_0"),
             **_linear(sd, "actor.log_std", "Dense_1")}

    def critic(prefix: str) -> Dict:
        out = {}
        for q in (0, 1):
            layers = sorted({int(k.split(".")[2]) for k in sd
                             if k.startswith(f"{prefix}.qf{q}.")
                             and k.endswith(".weight")})
            for i, layer in enumerate(layers[:-1]):
                out.update(_linear(sd, f"{prefix}.qf{q}.{layer}",
                                   f"MLP_{q}.Dense_{i}"))
            out.update(_linear(sd, f"{prefix}.qf{q}.{layers[-1]}",
                               f"Dense_{q}"))
        return out

    return {"actor": actor, "critic": critic("critic"),
            "target_critic": critic("critic_target")}


def import_ppo_policy(sd: Dict) -> Dict:
    """SB3 PPO ``policy.pth`` to a ``PPOActorCritic`` state dict
    (``MLP_0`` the policy trunk, ``Dense_0`` the action head, ``MLP_1`` the
    value trunk, ``Dense_1`` the value head, ``log_std``)."""
    return {**_trunk(sd, "mlp_extractor.policy_net", "MLP_0"),
            **_linear(sd, "action_net", "Dense_0"),
            **_trunk(sd, "mlp_extractor.value_net", "MLP_1"),
            **_linear(sd, "value_net", "Dense_1"),
            "log_std": sd["log_std"]}
