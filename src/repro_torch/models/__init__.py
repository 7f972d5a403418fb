"""The LM wing's models: dense, MoE, RG-LRU hybrid, Mamba, encoder-decoder and vision stub (port of the JAX package's ``repro.models``)."""
from repro_torch.models.model import Model, input_specs
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
    "input_specs",
    "Block",
    "Transformer",
    "forward",
    "prefill",
    "decode_step",
    "init_params",
    "init_decode_cache",
]
