"""Architecture registry: ``get_config(arch_id)`` and ``ARCHS``.

The port registers the architectures whose family it serves: the dense
family (``qwen2-0.5b``, ``smollm-360m``, ``h2o-danube-1.8b``), the SSM
family (``mamba2-130m``) and the hybrid family (``zamba2-1.2b``). The
reference's other configs come with their families (ROADMAP.md, queue 1).
"""
from repro_torch.configs.base import (InputShape, ModelConfig, MoEConfig,
                                      RunConfig, SSMConfig)

from repro_torch.configs import (h2o_danube_1_8b, mamba2_130m, qwen2_0_5b,
                                 smollm_360m, zamba2_1_2b)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (smollm_360m, mamba2_130m, h2o_danube_1_8b, qwen2_0_5b,
              zamba2_1_2b)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "InputShape", "ModelConfig", "MoEConfig", "RunConfig",
           "SSMConfig", "get_config"]
