"""LR schedules as pure ``count -> lr`` callables on float32 tensors (port of ``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_with_warmup", "linear_warmup"]


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).float()


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32, device=torch.as_tensor(count).device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(count):
        c = _f32(count)
        return lr * torch.clamp(c / max(warmup_steps, 1), max=1.0)
    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(count):
        c = _f32(count)
        warm = torch.clamp(c / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((c - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return f
