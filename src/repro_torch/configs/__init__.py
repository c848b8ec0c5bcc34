"""Architecture registry: ``get_config(arch_id)`` and ``ARCHS``, and the
input shapes: ``get_shape(shape_id)`` and ``SHAPES``.

All ten of the reference's architectures, in its order: the dense family
(``smollm-360m``, ``qwen2.5-32b``, ``h2o-danube-1.8b``, ``qwen2-0.5b``),
the MoE family (``mixtral-8x7b``, ``kimi-k2-1t-a32b``), the enc-dec
family (``whisper-medium``), the SSM family (``mamba2-130m``), the VLM
family (``paligemma-3b``) and the hybrid family (``zamba2-1.2b``).

``PORT_ONLY`` holds the configs the port runs that the reference has no
counterpart of (``granite-4.0-h-micro``, the interleaved family);
``get_config`` searches it after ``ARCHS``.
"""
from repro_torch.configs.base import (InputShape, InterleavedConfig,
                                      ModelConfig, MoEConfig, RunConfig,
                                      SSMConfig)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                        SHAPES, TRAIN_4K)

from repro_torch.configs import (
    smollm_360m, qwen2_5_32b, mixtral_8x7b, whisper_medium, mamba2_130m,
    paligemma_3b, h2o_danube_1_8b, qwen2_0_5b, kimi_k2_1t_a32b, zamba2_1_2b,
    granite_4_0_h_micro,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        smollm_360m, qwen2_5_32b, mixtral_8x7b, whisper_medium, mamba2_130m,
        paligemma_3b, h2o_danube_1_8b, qwen2_0_5b, kimi_k2_1t_a32b,
        zamba2_1_2b,
    )
}


PORT_ONLY = {granite_4_0_h_micro.CONFIG.name: granite_4_0_h_micro.CONFIG}


def get_config(arch_id: str) -> ModelConfig:
    known = {**ARCHS, **PORT_ONLY}
    if arch_id not in known:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(known)}")
    return known[arch_id]


def get_shape(shape_id: str) -> InputShape:
    if shape_id not in SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES)}")
    return SHAPES[shape_id]


__all__ = ["ARCHS", "PORT_ONLY", "SHAPES", "InputShape",
           "InterleavedConfig", "ModelConfig", "MoEConfig",
           "RunConfig", "SSMConfig", "get_config", "get_shape", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K"]
