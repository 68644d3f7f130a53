"""FBConfig: the FB agent's one typed config.

The port's own copy of ``raytracer_tpu/fb/config.py``: the same fields and
defaults (the canonical trained values, z 64, encoder 512, backward 256),
and ``output6_legacy()`` for the drifted variant FB/output6.py:166-179
constructs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FBConfig:
    obs_dim: int = 22
    action_dim: int = 2
    z_dim: int = 64
    e_hidden_dim: int = 512
    f_hidden_dim: int = 512
    b_hidden_dim: int = 256
    num_forward_heads: int = 3
    num_layers: int = 2
    learning_rate: float = 2e-4
    batch_size: int = 256
    buffer_capacity: int = 200_000
    update_freq: int = 100
    target_update_freq: int = 1000
    fb_weight: float = 1.0
    contrastive_weight: float = 0.6
    predictive_weight: float = 0.4
    norm_weight: float = 0.1
    diversity_weight: float = 0.05
    noise_scale: float = 0.1
    min_noise: float = 0.01
    noise_decay: float = 0.995
    max_bounces: int = 8
    samples_per_pixel: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def output6_legacy() -> "FBConfig":
        """The drifted config FB/output6.py:166-179 constructs."""
        return FBConfig(z_dim=32, e_hidden_dim=256, f_hidden_dim=256,
                        b_hidden_dim=128, num_forward_heads=2, num_layers=2,
                        max_bounces=6)
