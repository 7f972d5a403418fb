"""Global-norm gradient clipping (port of ``repro.optim.clipping``).

The gradients are a mapping of names to tensors (or a list of tensors);
the norm sums the leaves in their order, as the reference sums its tree's.
"""
from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm", "clip_scale"]


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm down to ``max_norm`` (at most 1)."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """``({name: g·scale}, norm)``, new tensors in each gradient's dtype."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return {n: (g * scale).to(g.dtype) for n, g in grads.items()}, norm
