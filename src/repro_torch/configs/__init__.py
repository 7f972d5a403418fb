"""Arch registry: importing this package registers all assigned configs."""
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    shape_is_applicable,
)

# Registration side effects — one module per assigned architecture.
from repro_torch.configs import (  # noqa: F401
    codeqwen1_5_7b,
    deepseek_moe_16b,
    falcon_mamba_7b,
    gemma2_9b,
    gemma_2b,
    internvl2_26b,
    qwen2_5_14b,
    qwen2_moe_a2p7b,
    recurrentgemma_9b,
    whisper_medium,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "list_archs",
    "shape_is_applicable",
]
