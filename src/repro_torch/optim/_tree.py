"""What the optimizers take as parameters and gradients: a module (its
named parameters) or a mapping of names to tensors."""
from __future__ import annotations

import torch


def named(params) -> dict[str, torch.Tensor]:
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def device_of(params) -> torch.device:
    return next(iter(named(params).values())).device
