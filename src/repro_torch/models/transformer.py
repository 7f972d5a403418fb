"""Transformer assembly for the dense family: blocks, forward, prefill, decode.

Port of the JAX package's ``repro.models.transformer``, dense layers only
(``"global"`` and ``"local"`` attention with a gated or plain MLP). The
reference keeps its parameters as a tree whose layers are stacked for
``lax.scan``; the port keeps them as a :class:`Transformer` module whose
``layers`` are one :class:`Block` per layer, in layer order. The
reference's function names stay, as thin functions over these modules.

Weights. The reference stores parameters in ``cfg.param_dtype`` (float32)
and casts each matrix to ``cfg.dtype`` at every use. The port stores the
matrices, biases and embeddings in ``cfg.dtype`` once they are loaded; the
cast rounds to nearest even either way, so the numbers are the same. The
norm scales stay in ``cfg.param_dtype``, because the reference reads them
in float32. Nothing here keeps a gradient: the port serves (training is
ROADMAP A13).

Not ported yet (ROADMAP A13), and refused with ``NotImplementedError``:
recurrent (RG-LRU) and SSM layers, MoE, the encoder-decoder and the vision
stub.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    Attention,
    attn_apply,
    attn_decode,
    attn_init,
    init_kv_cache,
)
from repro_torch.models.layers import dense_init, embed_init, mlp_apply, rmsnorm

__all__ = [
    "Block",
    "Transformer",
    "init_block",
    "apply_block",
    "init_params",
    "forward",
    "prefill",
    "decode_block",
    "decode_step",
    "init_decode_cache",
]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP A13)")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = _weight((d,), dtype, device)  # gemma-style (1 + scale)


class MLP(nn.Module):
    """``wi (d, 2·ff)`` holds ``[gate; up]`` for GeGLU/SwiGLU, ``(d, ff)`` for
    the plain GELU MLP; ``wo (ff, d)``."""

    def __init__(self, d: int, ff: int, activation: str, *, dtype, device):
        super().__init__()
        self.wi = _weight((d, ff if activation == "gelu_plain" else 2 * ff), dtype, device)
        self.wo = _weight((ff, d), dtype, device)


class Block(nn.Module):
    """One dense layer: ``ln1``, ``attn``, (``ln1_post``), ``ln2``, ``mlp``,
    (``ln2_post``), named as in the reference's parameter tree."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device):
        super().__init__()
        if kind in ("recurrent", "ssm"):
            raise _unported(f"the {kind!r} layer kind")
        if kind not in ("global", "local"):
            raise ValueError(f"unknown layer kind {kind!r}")
        self.kind = kind
        d, wd, nd = cfg.d_model, _dtype(cfg), _pdtype(cfg)
        self.ln1 = RMSNorm(d, dtype=nd, device=device)
        self.attn = Attention(cfg, dtype=wd, device=device)
        if cfg.post_norm:
            self.ln1_post = RMSNorm(d, dtype=nd, device=device)
        self.ln2 = RMSNorm(d, dtype=nd, device=device)
        self.mlp = MLP(d, cfg.d_ff, cfg.activation, dtype=wd, device=device)
        if cfg.post_norm:
            self.ln2_post = RMSNorm(d, dtype=nd, device=device)


class Transformer(nn.Module):
    """The parameters of a dense decoder LM. Built with uninitialised weights:
    :func:`init_params` draws them, ``convert.lm_params_from_numpy`` loads
    them. ``device=None`` is the CUDA card and raises without one."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise _unported("MoE (models/moe.py)")
        if cfg.is_enc_dec:
            raise _unported("the encoder-decoder (whisper)")
        if cfg.vision is not None:
            raise _unported("the vision stub (internvl2)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_padded, cfg.d_model), _dtype(cfg), dev)
        self.final_norm = RMSNorm(cfg.d_model, dtype=_pdtype(cfg), device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.vocab_padded, cfg.d_model), _dtype(cfg), dev)
        self.layers = nn.ModuleList(Block(cfg, kind, device=dev) for kind in cfg.layer_kinds())

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------
def _plan(cfg: ModelConfig):
    """(pre_kinds, n_scanned_blocks, pattern, tail_kinds), as the reference
    cuts its layers: pre = leading unscanned layers (deepseek-moe's dense
    layer 0), then ``nb`` whole patterns, then a trailing partial pattern.
    Layer ``b`` of pattern position ``pos`` is layer ``len(pre) + b·len(pattern)
    + pos``."""
    kinds = list(cfg.layer_kinds())
    n_pre = cfg.moe.first_dense_layers if cfg.moe else 0
    pre = kinds[:n_pre]
    rest = kinds[n_pre:]
    pat = cfg.pattern
    nb = len(rest) // len(pat)
    tail = tuple(rest[nb * len(pat):])
    return tuple(pre), nb, pat, tail


@torch.no_grad()
def init_block(block: Block, cfg: ModelConfig, generator: torch.Generator) -> Block:
    """Draw one block's weights as the reference does (zero norm scales)."""
    attn_init(block.attn, cfg, generator)
    d, ff = cfg.d_model, cfg.d_ff
    block.mlp.wi.copy_(dense_init(tuple(block.mlp.wi.shape), generator))
    block.mlp.wo.copy_(dense_init((ff, d), generator, fan_in=ff))
    for name in ("ln1", "ln1_post", "ln2", "ln2_post"):
        if hasattr(block, name):
            getattr(block, name).scale.zero_()
    return block


@torch.no_grad()
def init_params(
    cfg: ModelConfig, key: int | torch.Generator = 0, *, device=None
) -> Transformer:
    """A :class:`Transformer` with random weights drawn from ``key`` (a seed,
    or a ``torch.Generator`` whose device is used when ``device`` is None).
    The draws differ from the reference's ``jax.random`` ones; the
    distributions are the same."""
    if isinstance(key, torch.Generator):
        gen = key
        dev = resolve_device(device if device is not None else gen.device)
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
    params = Transformer(cfg, device=dev)
    params.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model, gen))
    params.final_norm.scale.zero_()
    if not cfg.tie_embeddings:
        params.lm_head.copy_(embed_init(cfg.vocab_padded, cfg.d_model, gen))
    for block in params.layers:
        init_block(block, cfg, gen)
    return params


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------
def _mlp(block: Block, h, cfg: ModelConfig):
    return mlp_apply(block.mlp.wi, block.mlp.wo, h, cfg.activation)


def _run_block(block: Block, x, cfg: ModelConfig, positions, *, causal: bool = True):
    """One layer over a full sequence: ``(x, (k, v))``, the layer's keys and values."""
    h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
    h, kv = attn_apply(block.attn, h, cfg, positions, kind=block.kind, causal=causal)
    if cfg.post_norm:
        h = rmsnorm(block.ln1_post.scale, h, cfg.norm_eps)
    x = x + h
    h = _mlp(block, rmsnorm(block.ln2.scale, x, cfg.norm_eps), cfg)
    if cfg.post_norm:
        h = rmsnorm(block.ln2_post.scale, h, cfg.norm_eps)
    return x + h, kv


def apply_block(block: Block, x, cfg: ModelConfig, kind: str, positions, *, causal: bool = True):
    """Full-sequence block application. Returns ``(x, aux_losses)`` (``{}``
    for dense layers)."""
    if kind != block.kind:
        raise ValueError(f"block is {block.kind!r}, asked to apply it as {kind!r}")
    return _run_block(block, x, cfg, positions, causal=causal)[0], {}


def _embed_tokens(params: Transformer, tokens, cfg: ModelConfig):
    x = params.embed[tokens.long()].to(_dtype(cfg))
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _logits(params: Transformer, x, cfg: ModelConfig):
    head = params.embed if cfg.tie_embeddings else params.lm_head
    logits = torch.einsum("bsd,vd->bsv", x, head.to(x.dtype))
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def forward(cfg: ModelConfig, params: Transformer, tokens, *, return_hidden: bool = False):
    """Full-sequence forward. Returns ``(logits (B, S, Vpad), aux)``, or the
    post-final-norm hidden states with ``return_hidden=True``."""
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for block in params.layers:
        x, _ = _run_block(block, x, cfg, positions)
    x = rmsnorm(params.final_norm.scale, x, cfg.norm_eps)
    if return_hidden:
        return x, {}
    return _logits(params, x, cfg), {}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------
def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> list[dict]:
    """One ``{"kv": {"k", "v"}}`` per layer, in layer order (the reference
    stacks the scanned layers instead). ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    return [
        {"kv": init_kv_cache(cfg, batch, max_len, kind=kind, dtype=_dtype(cfg), device=dev)}
        for kind in cfg.layer_kinds()
    ]


def decode_block(block: Block, x, bcache: dict, cfg: ModelConfig, kind: str, pos: int):
    """One layer of one decode step; updates ``bcache`` in place."""
    h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
    h, _ = attn_decode(block.attn, h, bcache["kv"], cfg, pos, kind=kind)
    if cfg.post_norm:
        h = rmsnorm(block.ln1_post.scale, h, cfg.norm_eps)
    x = x + h
    h = _mlp(block, rmsnorm(block.ln2.scale, x, cfg.norm_eps), cfg)
    if cfg.post_norm:
        h = rmsnorm(block.ln2_post.scale, h, cfg.norm_eps)
    return x + h, bcache


def decode_step(cfg: ModelConfig, params: Transformer, cache: list[dict], token, pos: int):
    """One-token decode against the cache. Returns ``(logits (B, 1, V), cache)``;
    the cache is updated in place."""
    x = _embed_tokens(params, token, cfg)
    for block, bcache in zip(params.layers, cache):
        x, _ = decode_block(block, x, bcache, cfg, block.kind, pos)
    x = rmsnorm(params.final_norm.scale, x, cfg.norm_eps)
    return _logits(params, x, cfg), cache


def _fill_kv(bcache: dict, k, v, kind: str) -> None:
    ck, cv = bcache["kv"]["k"], bcache["kv"]["v"]
    s, size = k.shape[1], ck.shape[1]
    if kind == "local" and s > size:
        # ring layout: position p lives at slot p % size
        ck.copy_(torch.roll(k[:, -size:], s % size, dims=1))
        cv.copy_(torch.roll(v[:, -size:], s % size, dims=1))
    else:
        ck[:, :s] = k
        cv[:, :s] = v


def prefill(cfg: ModelConfig, params: Transformer, tokens, max_len: int):
    """Run the full prompt, building the decode cache. Returns
    ``(last_logits (B, 1, V), cache)``."""
    b, s = tokens.shape
    cache = init_decode_cache(cfg, b, max_len, device=params.device)
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    for block, bcache in zip(params.layers, cache):
        x, (k, v) = _run_block(block, x, cfg, positions)
        _fill_kv(bcache, k, v, block.kind)
    x = rmsnorm(params.final_norm.scale, x[:, -1:, :], cfg.norm_eps)
    return _logits(params, x, cfg), cache
