"""Attention layer: GQA/MQA, RoPE, local windows, softcap, KV caches.

Port of the JAX package's ``repro.models.attention``. Three compute paths
for a full sequence, chosen as the reference chooses them (``attn_apply``;
``kv_override`` gives the cross-attention's keys and values):

* ``chunked`` — a plain PyTorch loop over KV chunks with an online
  softmax, for more than 2048 positions or ``attn_impl="chunked"``;
* ``pallas`` — the flash-attention kernel B3 through
  :func:`repro_torch.kernels.ops.attention` (the CUDA kernel on the card,
  its plain version on the CPU);
* ``plain`` — a materialized masked softmax, for anything else.

Decode (one query against a cache, or with ``cross=True`` against the
encoder's keys and values) is a grouped einsum that never repeats the KV
heads. Kernel B3 has no backward: training runs ``"ref"`` or
``"chunked"``, and ``"pallas"`` raises under autograd. The reference's
sharding constraints are left out: each rank of the port computes on
plain local tensors (``repro_torch.sharding``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rope, weight

__all__ = [
    "Attention",
    "attn_init",
    "attn_apply",
    "attn_decode",
    "init_kv_cache",
    "chunked_attention",
]

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections of one attention layer, in the reference's layouts:
    ``wq (d, H, Dh)``, ``wk``/``wv (d, KV, Dh)``, ``wo (H, Dh, d)``, and with
    ``qkv_bias`` ``bq (H, Dh)``, ``bk``/``bv (KV, Dh)``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, d_model: int | None = None):
        super().__init__()
        d = d_model or cfg.d_model
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = weight((d, h, hd), dtype, device)
        self.wk = weight((d, kv, hd), dtype, device)
        self.wv = weight((d, kv, hd), dtype, device)
        self.wo = weight((h, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = weight((h, hd), dtype, device)
            self.bk = weight((kv, hd), dtype, device)
            self.bv = weight((kv, hd), dtype, device)


@torch.no_grad()
def attn_init(attn: Attention, cfg: ModelConfig, generator: torch.Generator) -> Attention:
    """Fill ``attn`` with the reference's initial values (LeCun normal weights,
    zero biases), drawn from ``generator``."""
    d = attn.wq.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn.wq.copy_(dense_init((d, h * hd), generator).reshape(d, h, hd))
    attn.wk.copy_(dense_init((d, kv * hd), generator).reshape(d, kv, hd))
    attn.wv.copy_(dense_init((d, kv * hd), generator).reshape(d, kv, hd))
    attn.wo.copy_(dense_init((h * hd, d), generator, fan_in=h * hd).reshape(h, hd, d))
    if cfg.qkv_bias:
        for b in (attn.bq, attn.bk, attn.bv):
            b.zero_()
    return attn


def _project_qkv(attn: Attention, x, cfg: ModelConfig, positions, use_rope=True):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, attn.wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, attn.wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, attn.wv.to(dtype))
    if cfg.qkv_bias:
        q = q + attn.bq.to(dtype)
        k = k + attn.bk.to(dtype)
        v = v + attn.bv.to(dtype)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(
    q,  # (B, S, H, Dh)
    k,  # (B, Sk, K, Dh)
    v,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    scale: float,
    chunk: int = 1024,
    q_offset: int = 0,
):
    """Online-softmax attention in plain PyTorch: a loop over KV chunks.

    Memory per step is O(S·chunk) instead of O(S·Sk). Same arithmetic as the
    reference's ``lax.scan`` body, one chunk at a time.
    """
    b, s, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    group = h // hkv
    dev = q.device
    qf = (q.float() * scale).transpose(1, 2)  # (B, H, S, D)
    kf = k.float().transpose(1, 2)  # (B, K, Sk, D)
    vf = v.float().transpose(1, 2)
    q_pos = q_offset + torch.arange(s, device=dev)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s, dh), dtype=torch.float32, device=dev)
    for start in range(0, sk, chunk):
        kb = kf[:, :, start:start + chunk].repeat_interleave(group, dim=1)  # (B, H, c, D)
        vb = vf[:, :, start:start + chunk].repeat_interleave(group, dim=1)
        sco = torch.einsum("bhsd,bhcd->bhsc", qf, kb)
        if softcap is not None:
            sco = softcap * torch.tanh(sco / softcap)
        k_pos = start + torch.arange(kb.shape[2], device=dev)
        mask = torch.ones((s, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        sco = torch.where(mask, sco, NEG_INF)
        m_cur = torch.maximum(m, sco.amax(dim=-1))
        dead = m_cur <= NEG_INF / 2
        alpha = torch.where(dead, 1.0, torch.exp(m - m_cur))
        p = torch.exp(sco - torch.where(dead, 0.0, m_cur)[..., None])
        p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bhsc,bhcd->bhsd", p, vb)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, S, H, Dh)


def _plain_attention(q, k, v, *, causal, window, softcap, scale):
    _, s, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    kf = k.repeat_interleave(group, dim=2)
    vf = v.repeat_interleave(group, dim=2)
    sco = torch.einsum("bshd,bthd->bhst", q.float() * scale, kf.float())
    if softcap is not None:
        sco = softcap * torch.tanh(sco / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    sco = torch.where(mask, sco, NEG_INF)
    p = torch.softmax(sco, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, vf.float())
    return out.to(q.dtype)


def attn_apply(
    attn: Attention,
    x,  # (B, S, D)
    cfg: ModelConfig,
    positions,  # (S,) or (B, S)
    *,
    kind: str = "global",  # "global" | "local"
    causal: bool = True,
    kv_override: tuple | None = None,  # cross-attention: (k, v) precomputed
    use_rope: bool = True,
):
    """Full-sequence attention (prefill). Returns ``(out, (k, v))``."""
    window = cfg.window_size if kind == "local" else None
    scale = cfg.head_dim**-0.5
    if kv_override is not None:
        q = torch.einsum("bsd,dhk->bshk", x, attn.wq.to(x.dtype))
        if cfg.qkv_bias:
            q = q + attn.bq.to(x.dtype)
        k, v = kv_override
    else:
        q, k, v = _project_qkv(attn, x, cfg, positions, use_rope=use_rope)
    s, sk = q.shape[1], k.shape[1]
    chunk = cfg.attn_chunk or 1024
    if max(s, sk) > 2048 or cfg.attn_impl == "chunked":
        out = chunked_attention(
            q, k, v, causal=causal, window=window,
            softcap=cfg.attn_softcap, scale=scale, chunk=min(chunk, sk),
        )
    elif cfg.attn_impl == "pallas":
        from repro_torch.kernels.ops import attention as kernel_attention

        out = kernel_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=cfg.attn_softcap,
            scale=scale, use_kernel=True,
        ).transpose(1, 2)
    else:
        out = _plain_attention(
            q, k, v, causal=causal, window=window,
            softcap=cfg.attn_softcap, scale=scale,
        )
    y = torch.einsum("bshk,hkd->bsd", out, attn.wo.to(x.dtype))
    return y, (k, v)


# ---------------------------------------------------------------------------
# Decode path: single new token against a cache.
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, kind: str, dtype, device) -> dict:
    """Cache for one attention layer. Local layers use a ring buffer of the
    window size (O(window) memory)."""
    size = min(max_len, cfg.window_size) if kind == "local" else max_len
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
    }


def attn_decode(
    attn: Attention,
    x,  # (B, 1, D)
    cache: dict,
    cfg: ModelConfig,
    pos: int,  # index of the new token
    *,
    kind: str = "global",
    cross: bool = False,
    cross_len: int | None = None,
    use_rope: bool = True,
):
    """One decode step. Returns ``(out, cache)``.

    Unlike the reference, which returns a new cache, the port writes the new
    key and value into ``cache`` in place (one slot per step) and returns it.
    ``cross=True`` (cross-attention): q only, no RoPE, against the
    precomputed ``cache["k"]``/``cache["v"]`` (their first ``cross_len``
    positions, all by default); the cache is left as it is.
    """
    dtype = x.dtype
    scale = cfg.head_dim**-0.5
    b = x.shape[0]
    if cross:
        q = torch.einsum("bsd,dhk->bshk", x, attn.wq.to(dtype))
        if cfg.qkv_bias:
            q = q + attn.bq.to(dtype)
        k, v = cache["k"], cache["v"]
        valid = torch.arange(k.shape[1], device=x.device) < (cross_len or k.shape[1])
    else:
        positions = torch.full((b, 1), pos, device=x.device)
        q, k_new, v_new = _project_qkv(attn, x, cfg, positions, use_rope=use_rope)
        k, v = cache["k"], cache["v"]
        size = k.shape[1]
        slot = pos % size if kind == "local" else pos
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        idx = torch.arange(size, device=x.device)
        if kind == "local":
            # Ring buffer: slot s holds the key of position pos − ((pos − s) mod
            # size); it is valid iff that position has been written.
            valid = torch.remainder(pos - idx, size) <= pos
        else:
            valid = idx <= pos
    # GQA by a grouped einsum: the KV heads are never repeated.
    group = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, 1, cfg.num_kv_heads, group, cfg.head_dim)
    sco = torch.einsum("bqhgd,bthd->bhgqt", qg.float() * scale, k.float())  # (B, KV, G, 1, S)
    if cfg.attn_softcap is not None:
        sco = cfg.attn_softcap * torch.tanh(sco / cfg.attn_softcap)
    sco = torch.where(valid, sco, NEG_INF)
    m = sco.amax(dim=-1, keepdim=True)
    p = torch.exp(sco - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqt,bthd->bqhgd", p, v.float())
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(dtype)
    y = torch.einsum("bshk,hkd->bsd", out, attn.wo.to(dtype))
    return y, cache
