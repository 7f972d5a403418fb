"""Mamba-1 block (falcon-mamba): selective SSM with a chunked scan.

Port of the JAX package's ``repro.models.ssm``. Prefill runs a two-level
scan: a loop over sequence chunks of :data:`CHUNK` steps carrying the
``(B, E, N)`` state, with a parallel associative scan inside each chunk
(``models/scan.py``, the reference's fold tree). Each step's decay is kept
as its own factor, never as a product over the chunk: decays as low as
``exp(-1.6)`` a step would underflow float32 over 128 steps in a
cumulative-product form. Decode carries ``(conv, ssm)`` state and is O(1)
per token.

Parameters: :class:`Mamba` stores the matrices, the convolution and
``dt_bias`` in ``cfg.dtype`` (the reference casts them to it at use) and
``A_log`` and ``D`` in ``cfg.param_dtype``, because the reference computes
with them in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, weight
from repro_torch.models.scan import associative_scan

__all__ = ["Mamba", "mamba_init", "mamba_apply", "mamba_decode", "init_mamba_state"]

CHUNK = 128


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    e = s.expand * cfg.d_model
    dtr = s.dt_rank or cfg.d_model // 16
    return e, dtr, s.d_state, s.d_conv


class Mamba(nn.Module):
    """One Mamba block's parameters, named as in the reference's tree."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d = cfg.d_model
        e, dtr, n, k = _dims(cfg)
        wd, fd = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.in_proj = weight((d, 2 * e), wd, device)
        self.conv_w = weight((k, e), wd, device)
        self.conv_b = weight((e,), wd, device)
        self.x_proj = weight((e, dtr + 2 * n), wd, device)
        self.dt_proj = weight((dtr, e), wd, device)
        self.dt_bias = weight((e,), wd, device)
        self.A_log = weight((e, n), fd, device)
        self.D = weight((e,), fd, device)
        self.out_proj = weight((e, d), wd, device)


@torch.no_grad()
def mamba_init(mamba: Mamba, cfg: ModelConfig, generator: torch.Generator) -> Mamba:
    """Draw the reference's initial values: S4D-real ``A = -(1..N)``, ``dt``
    log-uniform in [1e-3, 1e-1] through softplus⁻¹, LeCun normal matrices."""
    d = cfg.d_model
    e, dtr, n, k = _dims(cfg)
    dev = generator.device
    mamba.in_proj.copy_(dense_init((d, 2 * e), generator))
    mamba.conv_w.copy_(dense_init((k, e), generator, fan_in=k))
    mamba.conv_b.zero_()
    mamba.x_proj.copy_(dense_init((e, dtr + 2 * n), generator, fan_in=e))
    mamba.dt_proj.copy_(dense_init((dtr, e), generator, fan_in=dtr))
    u = torch.rand((e,), generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    mamba.dt_bias.copy_(torch.log(torch.expm1(dt)))
    mamba.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).expand(e, n))
    mamba.D.fill_(1.0)
    mamba.out_proj.copy_(dense_init((e, d), generator, fan_in=e))
    return mamba


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv along seq. x: (B, S, E), w: (K, E).

    ``state``: (B, K-1, E) trailing inputs of the previous segment. Returns
    ``(out, new_state)``. Taps are summed in the reference's order."""
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None else state
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, E)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    out = out + b
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return out, new_state


def _ssm_params(mamba: Mamba, x, e, dtr, n):
    """Per-step SSM coefficients from the input. x: (..., E) -> float32 dt, B, C and A."""
    dbc = x @ mamba.x_proj.to(x.dtype)  # (..., dtr+2N)
    dt, b, c = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = F.softplus(dt @ mamba.dt_proj.to(x.dtype) + mamba.dt_bias.to(x.dtype))  # (..., E)
    a = -torch.exp(mamba.A_log.float())  # (E, N)
    return dt.float(), b.float(), c.float(), a


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def mamba_apply(mamba: Mamba, u, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence Mamba block. u: (B, S, D) -> (B, S, D) [, final state].

    ``return_state=True`` also returns the ``{"conv", "ssm"}`` state after
    the last position (prefill's cache)."""
    e, dtr, n, k = _dims(cfg)
    b_, s_, _ = u.shape
    dtype = u.dtype
    xz = u @ mamba.in_proj.to(dtype)
    x, z = xz.chunk(2, dim=-1)  # (B, S, E)
    x, conv_state = _causal_conv(x, mamba.conv_w.to(dtype), mamba.conv_b.to(dtype))
    x = F.silu(x)
    dt, bmat, cmat, a = _ssm_params(mamba, x, e, dtr, n)
    xf = x.float()

    # chunked selective scan; padded steps are scan identities (decay 1,
    # input 0), so the carried state that return_state exposes is exact
    nchunks = -(-s_ // CHUNK)
    pad = nchunks * CHUNK - s_

    def chunks(t):
        t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(b_, nchunks, CHUNK, t.shape[-1]).transpose(0, 1)

    valid = (torch.arange(nchunks * CHUNK, device=u.device) < s_).float()
    dt_c, b_c, c_c, x_c = chunks(dt), chunks(bmat), chunks(cmat), chunks(xf)
    v_c = valid.reshape(nchunks, 1, CHUNK, 1)
    h = torch.zeros((b_, e, n), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(nchunks):
        dt_k, b_k, c_k, x_k, v_k = dt_c[i], b_c[i], c_c[i], x_c[i], v_c[i][..., None]
        decay = torch.exp(dt_k[..., None] * a)  # (B, Lc, E, N)
        decay = decay * v_k + (1.0 - v_k)
        inp = dt_k[..., None] * b_k[:, :, None, :] * x_k[..., None]
        inp = inp * v_k
        acc_a, acc_b = associative_scan(_combine, (decay, inp), axis=1)
        hs = acc_a * h[:, None] + acc_b  # (B, Lc, E, N), running state incl. h
        ys.append(torch.einsum("blen,bln->ble", hs, c_k))
        h = hs[:, -1]
        del decay, inp, acc_a, acc_b, hs
    y = torch.cat(ys, dim=1)[:, :s_]
    y = y + xf * mamba.D
    y = y.to(dtype) * F.silu(z)
    out = y @ mamba.out_proj.to(dtype)
    if return_state:
        return out, {"conv": conv_state, "ssm": h}
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, *, device=None) -> dict:
    """Zero ``{"conv": (B, K-1, E) dtype, "ssm": (B, E, N) float32}``; ``device=None`` is the card."""
    e, _, n, k = _dims(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, k - 1, e), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, e, n), dtype=torch.float32, device=dev),
    }


def mamba_decode(mamba: Mamba, u, state: dict, cfg: ModelConfig):
    """One token. u: (B, 1, D). Returns ``(y, new_state)``: O(1) memory."""
    e, dtr, n, _ = _dims(cfg)
    dtype = u.dtype
    xz = u @ mamba.in_proj.to(dtype)
    x, z = xz.chunk(2, dim=-1)
    x, conv_state = _causal_conv(
        x, mamba.conv_w.to(dtype), mamba.conv_b.to(dtype), state=state["conv"]
    )
    x = F.silu(x)
    dt, bmat, cmat, a = _ssm_params(mamba, x, e, dtr, n)
    xf = x.float()
    decay = torch.exp(dt[:, 0, :, None] * a)  # (B, E, N)
    h = decay * state["ssm"] + dt[:, 0, :, None] * bmat[:, 0, None, :] * xf[:, 0, :, None]
    y = torch.einsum("ben,bn->be", h, cmat[:, 0])[:, None, :] + xf * mamba.D
    y = y.to(dtype) * F.silu(z)
    return y @ mamba.out_proj.to(dtype), {"conv": conv_state, "ssm": h}
