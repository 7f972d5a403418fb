"""Model facade: one object per config, over the functional transformer.

Port of the JAX package's ``repro.models.model.Model``. ``input_specs``
belongs to the dry run and is not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    Transformer,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = ["Model"]


class Model:
    """Thin facade over the transformer functions, bound to one device.

    ``device=None`` is the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, key: int | torch.Generator = 0) -> Transformer:
        return init_params(self.cfg, key, device=self.device)

    def apply(self, params: Transformer, tokens, **extra):
        return forward(self.cfg, params, tokens, **extra)

    def prefill(self, params: Transformer, tokens, max_len: int):
        return prefill(self.cfg, params, tokens, max_len)

    def decode(self, params: Transformer, cache, token, pos: int):
        return decode_step(self.cfg, params, cache, token, pos)

    def init_cache(self, batch: int, max_len: int):
        return init_decode_cache(self.cfg, batch, max_len, device=self.device)
