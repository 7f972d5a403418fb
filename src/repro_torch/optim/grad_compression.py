"""Gradient compression for cross-pod sync (port of ``repro.optim.grad_compression``).

Casting gradients to bfloat16 before a cross-pod reduction halves its
traffic; ``compress_for_sync`` is what the train step's
``grad_sync="compressed_bf16"`` accumulates in.
"""
from __future__ import annotations

import torch

__all__ = ["compress_for_sync", "decompress_after_sync"]


def compress_for_sync(grads: dict, mode: str = "none") -> dict:
    if mode == "none":
        return grads
    if mode == "compressed_bf16":
        return {n: g.to(torch.bfloat16) for n, g in grads.items()}
    raise ValueError(f"unknown grad_sync mode {mode!r}")


def decompress_after_sync(grads: dict, mode: str = "none") -> dict:
    if mode == "none":
        return grads
    return {n: g.to(torch.float32) for n, g in grads.items()}
