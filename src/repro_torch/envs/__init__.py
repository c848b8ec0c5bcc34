"""Batched PyTorch environments; importing the package registers them all."""
from repro_torch.envs.base import Env, EnvSpec, env_names, make
from repro_torch.envs import (cartpole, hopper, pendulum,  # noqa: F401
                              reacher)                     # (register)

__all__ = ["Env", "EnvSpec", "env_names", "make"]
