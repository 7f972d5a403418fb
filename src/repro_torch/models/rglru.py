"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of the JAX package's ``repro.models.rglru``. Block: x → [branch a:
linear → causal conv(4) → RG-LRU] ⊙ [branch b: linear → GeLU] → out-proj.
The RG-LRU diagonal recurrence

    r_t = σ(Wa x_t + ba)                 (recurrence gate)
    i_t = σ(Wx x_t + bx)                 (input gate)
    a_t = exp(c·softplus(Λ)·(−r_t))      (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)

runs as one associative scan over the whole sequence in prefill
(``models/scan.py``, the reference's fold tree) and as a single update in
decode (O(1) state).

Parameters: :class:`RGLRU` stores the projections and the convolution in
``cfg.dtype`` and ``wa``, ``ba``, ``wx``, ``bx`` and ``lambda`` in
``cfg.param_dtype``, because the reference computes the gates in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, weight
from repro_torch.models.scan import associative_scan
from repro_torch.models.ssm import _causal_conv, _combine

__all__ = ["RGLRU", "rglru_init", "rglru_apply", "rglru_decode", "init_rglru_state"]

C_FACTOR = 8.0


class RGLRU(nn.Module):
    """One recurrent block's parameters, named as in the reference's tree
    (``lambda`` is reached with ``getattr``)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru.lru_width or d
        wd, fd = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.in_x = weight((d, w), wd, device)
        self.in_gate = weight((d, w), wd, device)
        self.conv_w = weight((cfg.rglru.conv_width, w), wd, device)
        self.conv_b = weight((w,), wd, device)
        self.wa = weight((w, w), fd, device)
        self.ba = weight((w,), fd, device)
        self.wx = weight((w, w), fd, device)
        self.bx = weight((w,), fd, device)
        self.register_parameter("lambda", weight((w,), fd, device))
        self.out = weight((w, d), wd, device)


@torch.no_grad()
def rglru_init(rec: RGLRU, cfg: ModelConfig, generator: torch.Generator) -> RGLRU:
    """Draw the reference's initial values: Λ such that ``a`` ∈ [0.9, 0.999]
    at r = 1 (Griffin's appendix), LeCun normal matrices, zero biases."""
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    u = torch.empty((w,), device=generator.device).uniform_(0.9**2, 0.999**2, generator=generator)
    getattr(rec, "lambda").copy_(torch.log(torch.expm1(-torch.log(u) / (2 * C_FACTOR))))
    rec.in_x.copy_(dense_init((d, w), generator))
    rec.in_gate.copy_(dense_init((d, w), generator))
    rec.conv_w.copy_(dense_init((cfg.rglru.conv_width, w), generator, fan_in=cfg.rglru.conv_width))
    rec.conv_b.zero_()
    rec.wa.copy_(dense_init((w, w), generator))
    rec.ba.zero_()
    rec.wx.copy_(dense_init((w, w), generator))
    rec.bx.zero_()
    rec.out.copy_(dense_init((w, d), generator, fan_in=w))
    return rec


def _gates(rec: RGLRU, x):
    """Per-step decay a_t and gated input. x: (..., W) -> float32 terms."""
    xf = x.float()
    r = torch.sigmoid(xf @ rec.wa.float() + rec.ba.float())
    i = torch.sigmoid(xf @ rec.wx.float() + rec.bx.float())
    log_a = -C_FACTOR * F.softplus(getattr(rec, "lambda").float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)
    return a, gated


def rglru_apply(rec: RGLRU, u, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence recurrent block. u: (B, S, D) -> (B, S, D) [, state]."""
    dtype = u.dtype
    x = u @ rec.in_x.to(dtype)
    gate = F.gelu(u @ rec.in_gate.to(dtype), approximate="tanh")
    x, conv_state = _causal_conv(x, rec.conv_w.to(dtype), rec.conv_b.to(dtype))
    a, gated = _gates(rec, x)
    _, h = associative_scan(_combine, (a, gated), axis=1)
    y = h.to(dtype) * gate
    out = y @ rec.out.to(dtype)
    if return_state:
        return out, {"h": h[:, -1], "conv": conv_state}
    return out


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, *, device=None) -> dict:
    """Zero ``{"h": (B, W) float32, "conv": (B, K-1, W) dtype}``; ``device=None`` is the card."""
    w = cfg.rglru.lru_width or cfg.d_model
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w), dtype=dtype, device=dev),
    }


def rglru_decode(rec: RGLRU, u, state: dict, cfg: ModelConfig):
    """One token. u: (B, 1, D) -> ``(y, new_state)``."""
    dtype = u.dtype
    x = u @ rec.in_x.to(dtype)
    gate = F.gelu(u @ rec.in_gate.to(dtype), approximate="tanh")
    x, conv_state = _causal_conv(x, rec.conv_w.to(dtype), rec.conv_b.to(dtype), state=state["conv"])
    a, gated = _gates(rec, x)  # (B, 1, W)
    h = a[:, 0] * state["h"] + gated[:, 0]
    y = h[:, None, :].to(dtype) * gate
    return y @ rec.out.to(dtype), {"h": h, "conv": conv_state}
