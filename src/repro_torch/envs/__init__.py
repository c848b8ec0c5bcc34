"""Batched PyTorch environments; importing the package registers them."""
from repro_torch.envs.base import Env, EnvSpec, env_names, make
from repro_torch.envs import pendulum  # noqa: F401 (register)

__all__ = ["Env", "EnvSpec", "env_names", "make"]
