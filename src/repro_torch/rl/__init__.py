"""Off-policy actor-critic RL in PyTorch (SAC)."""
from repro_torch.rl.base import AlgoHP, AlgoState, get_algo

__all__ = ["AlgoHP", "AlgoState", "get_algo"]
