"""The RL agents: PPO, SAC and tabular Q on the batched env."""
from pathlib import Path

# Byte-equal copies of the shipped policies under models/, which the card's
# copy of the repository leaves out.
SHIPPED_DIR = Path(__file__).resolve().parent / "shipped"
