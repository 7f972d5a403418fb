"""Shared neural building blocks: initializers, RMSNorm, RoPE, the MLP.

Port of the JAX package's ``repro.models.layers``. The apply functions take
the weights as tensors and compute at the same points in the same dtypes as
the reference: norms and RoPE in float32 and cast back, matrix products in
the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "weight",
    "dense_init",
    "embed_init",
    "rmsnorm",
    "rope",
    "MLP",
    "mlp_init",
    "mlp_apply",
]


def weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter with gradients off (serving); a
    ``Transformer`` built with ``master_weights`` turns them on."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dense_init(
    shape, generator: torch.Generator, fan_in: int | None = None, dtype=torch.float32
) -> torch.Tensor:
    """Truncated normal at ±2σ with σ = 1/sqrt(fan_in) (LeCun normal).

    Drawn in float32 on the generator's device, then cast to ``dtype``.
    """
    if fan_in is None:
        fan_in = shape[0]
    std = fan_in**-0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return t.to(dtype)


def embed_init(vocab: int, d: int, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated at ±2."""
    t = torch.empty((vocab, d), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
    return t.to(dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm, ``y · (1 + scale)``, in float32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding in float32, cast back. x: (..., S, H, Dh), positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """``wi (d, 2·ff)`` holds ``[gate; up]`` for GeGLU/SwiGLU, ``(d, ff)`` for
    the plain GELU MLP; ``wo (ff, d)``."""

    def __init__(self, d: int, ff: int, activation: str, *, dtype, device):
        super().__init__()
        self.wi = weight((d, ff if activation == "gelu_plain" else 2 * ff), dtype, device)
        self.wo = weight((ff, d), dtype, device)


@torch.no_grad()
def mlp_init(mlp: MLP, generator: torch.Generator) -> MLP:
    """Fill ``mlp`` as the reference's ``mlp_init`` draws it: LeCun normal
    ``wi`` over ``d`` inputs and ``wo`` over ``ff``."""
    ff = mlp.wo.shape[0]
    mlp.wi.copy_(dense_init(tuple(mlp.wi.shape), generator))
    mlp.wo.copy_(dense_init(tuple(mlp.wo.shape), generator, fan_in=ff))
    return mlp


def mlp_apply(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor, activation: str) -> torch.Tensor:
    """GeGLU (``gelu``, tanh GELU), SwiGLU (``silu``) or a plain tanh-GELU MLP
    (``gelu_plain``); ``wi`` holds ``[gate; up]`` side by side for the gated
    kinds. Products in x's dtype."""
    wi, wo = wi.to(x.dtype), wo.to(x.dtype)
    if activation == "gelu_plain":
        return F.gelu(x @ wi, approximate="tanh") @ wo
    gate, up = (x @ wi).chunk(2, dim=-1)
    act = F.silu(gate) if activation == "silu" else F.gelu(gate, approximate="tanh")
    return (act * up) @ wo
