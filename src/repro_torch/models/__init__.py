"""The LM wing's models: dense, MoE, RG-LRU hybrid and Mamba (port of the JAX package's ``repro.models``)."""
from repro_torch.models.model import Model
from repro_torch.models.transformer import (
    Block,
    Transformer,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = [
    "Model",
    "Block",
    "Transformer",
    "forward",
    "prefill",
    "decode_step",
    "init_params",
    "init_decode_cache",
]
