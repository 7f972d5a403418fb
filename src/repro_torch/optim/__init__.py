"""Optimizers, schedules, clipping, gradient compression (port of the JAX package's ``repro.optim``)."""
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim.grad_compression import compress_for_sync, decompress_after_sync
from repro_torch.optim.schedules import constant, cosine_with_warmup, linear_warmup

__all__ = [
    "AdamW",
    "Adafactor",
    "clip_by_global_norm",
    "global_norm",
    "compress_for_sync",
    "decompress_after_sync",
    "constant",
    "cosine_with_warmup",
    "linear_warmup",
]
