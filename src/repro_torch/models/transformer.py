"""Transformer assembly: blocks, encoder, forward, prefill, decode.

Port of the JAX package's ``repro.models.transformer``: dense
(``"global"``/``"local"`` attention with a gated or plain MLP), MoE
(``models/moe.py``, with deepseek-moe's leading dense layers),
RecurrentGemma's ``(recurrent, recurrent, local)`` pattern
(``models/rglru.py``), Mamba (``"ssm"`` layers, ``models/ssm.py``, no
MLP), whisper's encoder-decoder (a non-causal encoder over stub frame
embeddings; each decoder layer cross-attends its output) and internvl2's
vision stub (patch embeddings prepended to the token embeddings). The
reference keeps its parameters as a tree whose layers are stacked for
``lax.scan``; the port keeps them as a :class:`Transformer` module whose
``layers`` are one :class:`Block` per layer, in layer order (the
reference's leading, scanned and trailing layers one after another), and
whose ``encoder`` holds the encoder's blocks. The reference's function
names stay, as thin functions over these modules.

Weights. The reference stores parameters in ``cfg.param_dtype`` (float32)
and casts each matrix to ``cfg.dtype`` at every use. For serving, the port
stores the matrices, biases and embeddings in ``cfg.dtype`` once they are
loaded; the cast rounds to nearest even either way, so the numbers are the
same. What the reference reads in float32 stays in ``cfg.param_dtype``:
the norm scales, the MoE router, Mamba's ``A_log`` and ``D``, and the
RG-LRU gates (``wa``, ``ba``, ``wx``, ``bx``, ``lambda``). Serving keeps
no gradient. ``master_weights=True`` builds the reference's own storage
for training instead: every parameter in ``cfg.param_dtype``, with
gradients on (``repro_torch.train`` casts them to ``cfg.dtype`` once a
step). When autograd records a forward, each layer (and each encoder
layer) is recomputed in backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` under its default ``nothing_saveable``
policy; the values are the same.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (
    Attention,
    attn_apply,
    attn_decode,
    attn_init,
    init_kv_cache,
)
from repro_torch.models.layers import MLP, embed_init, mlp_apply, mlp_init, rmsnorm, weight

__all__ = [
    "Block",
    "Encoder",
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


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = weight((d,), dtype, device)  # gemma-style (1 + scale)


class Block(nn.Module):
    """One layer, named as in the reference's parameter tree: ``ln1``, then
    ``attn`` (``"global"``/``"local"``), ``rec`` (``"recurrent"``) or ``ssm``
    (``"ssm"``, which has nothing else); (``ln1_post``), with ``cross`` the
    cross-attention's ``lnx`` and ``cross``, then ``ln2``, ``moe`` or
    ``mlp``, (``ln2_post``). ``dense_ff`` makes a dense layer of that width
    in an MoE model (deepseek-moe's leading layers)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device, dense_ff: int | None = None,
                 cross: bool = False):
        super().__init__()
        if kind not in ("global", "local", "recurrent", "ssm"):
            raise ValueError(f"unknown layer kind {kind!r}")
        self.kind = kind
        d, wd, nd = cfg.d_model, _dtype(cfg), _pdtype(cfg)
        self.ln1 = RMSNorm(d, dtype=nd, device=device)
        if kind == "ssm":
            self.ssm = ssm_lib.Mamba(cfg, device=device)
            return  # the Mamba block subsumes the MLP
        if kind == "recurrent":
            self.rec = rglru_lib.RGLRU(cfg, device=device)
        else:
            self.attn = Attention(cfg, dtype=wd, device=device)
        if cfg.post_norm:
            self.ln1_post = RMSNorm(d, dtype=nd, device=device)
        if cross:
            self.lnx = RMSNorm(d, dtype=nd, device=device)
            self.cross = Attention(cfg, dtype=wd, device=device)
        self.ln2 = RMSNorm(d, dtype=nd, device=device)
        if cfg.moe is not None and dense_ff is None:
            self.moe = moe_lib.MoE(cfg, device=device)
        else:
            self.mlp = MLP(d, dense_ff or cfg.d_ff, cfg.activation, dtype=wd, device=device)
        if cfg.post_norm:
            self.ln2_post = RMSNorm(d, dtype=nd, device=device)


class Encoder(nn.Module):
    """whisper's encoder: ``blocks`` (non-causal ``"global"`` layers, no
    cross-attention) and its ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(cfg, "global", device=device) for _ in range(cfg.encdec.num_encoder_layers)
        )
        self.final_norm = RMSNorm(cfg.d_model, dtype=_pdtype(cfg), device=device)


class Transformer(nn.Module):
    """The parameters of an LM. Built with uninitialised weights:
    :func:`init_params` draws them, ``convert.lm_params_from_numpy`` loads
    them. ``device=None`` is the CUDA card and raises without one.
    ``master_weights=True`` stores every parameter in ``cfg.param_dtype``
    with gradients on (training); otherwise the serving storage (module
    docstring), with no gradient."""

    def __init__(self, cfg: ModelConfig, *, device=None, master_weights: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # The modules read their storage dtype off cfg.dtype.
        store = dataclasses.replace(cfg, dtype=cfg.param_dtype) if master_weights else cfg
        self.embed = weight((cfg.vocab_padded, cfg.d_model), _dtype(store), dev)
        self.final_norm = RMSNorm(cfg.d_model, dtype=_pdtype(cfg), device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.vocab_padded, cfg.d_model), _dtype(store), dev)
        pre, _, _, _ = _plan(cfg)
        dense_ff = cfg.moe.first_dense_ff if cfg.moe else None
        self.layers = nn.ModuleList(
            Block(store, kind, device=dev, dense_ff=dense_ff if i < len(pre) else None,
                  cross=cfg.is_enc_dec)
            for i, kind in enumerate(cfg.layer_kinds())
        )
        if cfg.is_enc_dec:
            self.encoder = Encoder(store, device=dev)
        if master_weights:
            self.requires_grad_(True)

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
    if block.kind == "ssm":
        ssm_lib.mamba_init(block.ssm, cfg, generator)
    elif block.kind == "recurrent":
        rglru_lib.rglru_init(block.rec, cfg, generator)
    else:
        attn_init(block.attn, cfg, generator)
    if hasattr(block, "cross"):
        attn_init(block.cross, cfg, generator)
    if hasattr(block, "moe"):
        moe_lib.moe_init(block.moe, cfg, generator)
    elif hasattr(block, "mlp"):
        mlp_init(block.mlp, generator)
    for name in ("ln1", "ln1_post", "lnx", "ln2", "ln2_post"):
        if hasattr(block, name):
            getattr(block, name).scale.zero_()
    return block


@torch.no_grad()
def init_params(
    cfg: ModelConfig, key: int | torch.Generator = 0, *, device=None, master_weights: bool = False
) -> Transformer:
    """A :class:`Transformer` with random weights drawn from ``key`` (a seed,
    or a ``torch.Generator`` whose device is used when ``device`` is None).
    The draws differ from the reference's ``jax.random`` ones; the
    distributions are the same. ``master_weights``: as :class:`Transformer`."""
    if isinstance(key, torch.Generator):
        gen = key
        dev = resolve_device(device if device is not None else gen.device)
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
    params = Transformer(cfg, device=dev, master_weights=master_weights)
    params.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model, gen))
    params.final_norm.scale.zero_()
    if not cfg.tie_embeddings:
        params.lm_head.copy_(embed_init(cfg.vocab_padded, cfg.d_model, gen))
    for block in params.layers:
        init_block(block, cfg, gen)
    if cfg.is_enc_dec:
        for block in params.encoder.blocks:
            init_block(block, cfg, gen)
        params.encoder.final_norm.scale.zero_()
    return params


# ---------------------------------------------------------------------------
# Forward (scoring and training)
# ---------------------------------------------------------------------------
def _remat(fn, x, *args, **kw):
    """``fn(x, ...)``, recomputed in backward when autograd records it."""
    if torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(fn, x, *args, use_reentrant=False, **kw)
    return fn(x, *args, **kw)


def _cross_step(block: Block, x, enc_out, cfg: ModelConfig, positions):
    """The cross-attention residual step: ``(x, k, v)``, with k and v
    projected from ``enc_out`` (no RoPE, non-causal)."""
    h = rmsnorm(block.lnx.scale, x, cfg.norm_eps)
    dtype = h.dtype
    k = torch.einsum("btd,dhk->bthk", enc_out, block.cross.wk.to(dtype))
    v = torch.einsum("btd,dhk->bthk", enc_out, block.cross.wv.to(dtype))
    h, _ = attn_apply(block.cross, h, cfg, positions, kind="global", causal=False,
                      kv_override=(k, v), use_rope=False)
    return x + h, k, v


def _run_block(block: Block, x, cfg: ModelConfig, positions, *, causal: bool = True,
               enc_out=None, return_state: bool = False, return_aux: bool = True):
    """One layer over a full sequence: ``(x, state, aux)``. ``state`` is the
    layer's keys and values (``{"kv": (k, v)}``, attention) with the
    cross-attention's (``"cross_kv"``) when ``enc_out`` is given, or with
    ``return_state`` its recurrent (``{"rec": {"h", "conv"}}``) or SSM
    (``{"ssm": {"conv", "ssm"}}``) state after the last position; ``aux``
    the MoE's load-balance terms."""
    h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
    state, aux = {}, {}
    if block.kind == "ssm":
        out = ssm_lib.mamba_apply(block.ssm, h, cfg, return_state=return_state)
        h, state["ssm"] = out if return_state else (out, None)
        return x + h, state, aux
    if block.kind == "recurrent":
        out = rglru_lib.rglru_apply(block.rec, h, cfg, return_state=return_state)
        h, state["rec"] = out if return_state else (out, None)
    else:
        h, state["kv"] = attn_apply(block.attn, h, cfg, positions, kind=block.kind, causal=causal)
    if cfg.post_norm:
        h = rmsnorm(block.ln1_post.scale, h, cfg.norm_eps)
    x = x + h
    if enc_out is not None and hasattr(block, "cross"):
        x, *state["cross_kv"] = _cross_step(block, x, enc_out, cfg, positions)
    h, aux = _ffn(block, rmsnorm(block.ln2.scale, x, cfg.norm_eps), cfg, return_aux=return_aux)
    if cfg.post_norm:
        h = rmsnorm(block.ln2_post.scale, h, cfg.norm_eps)
    return x + h, state, aux


def _ffn(block: Block, h, cfg: ModelConfig, *, return_aux: bool):
    if hasattr(block, "moe"):
        return moe_lib.moe_apply(block.moe, h, cfg, return_aux=return_aux)
    return mlp_apply(block.mlp.wi, block.mlp.wo, h, cfg.activation), {}


def apply_block(block: Block, x, cfg: ModelConfig, kind: str, positions, *, causal: bool = True,
                enc_out=None):
    """Full-sequence block application. Returns ``(x, aux_losses)`` (the
    MoE's ``load_balance_loss`` and ``dropped_fraction``; ``{}`` otherwise).
    ``enc_out``: the encoder's output, for a block with cross-attention."""
    if kind != block.kind:
        raise ValueError(f"block is {block.kind!r}, asked to apply it as {kind!r}")
    x, _, aux = _run_block(block, x, cfg, positions, causal=causal, enc_out=enc_out)
    return x, aux


def _run_encoder(params: Transformer, frames, cfg: ModelConfig):
    """whisper's encoder over stub frame embeddings ``(B, T, D)``: a
    sinusoidal position table added in ``cfg.dtype``, the non-causal
    ``"global"`` blocks (with RoPE, as the reference applies them), the
    final norm."""
    x = frames.to(_dtype(cfg))
    t, d = x.shape[1], cfg.d_model
    pos = torch.arange(t, device=x.device)[:, None]
    div = torch.exp(-math.log(10_000.0) * torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    pe = torch.zeros((t, d), device=x.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    x = x + pe.to(x.dtype)
    positions = torch.arange(t, device=x.device)
    for block in params.encoder.blocks:
        x = _remat(lambda h, b=block: _run_block(b, h, cfg, positions, causal=False)[0], x)
    return rmsnorm(params.encoder.final_norm.scale, x, cfg.norm_eps)


def _embed_tokens(params: Transformer, tokens, cfg: ModelConfig):
    x = params.embed[tokens.long()].to(_dtype(cfg))
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _embed_inputs(params: Transformer, tokens, cfg: ModelConfig, patch_embeds, frames):
    """The decoder's input ``(B, Np + S, D)`` (patch embeddings first) and the
    encoder's output (``None`` without frames)."""
    x = _embed_tokens(params, tokens, cfg)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    enc_out = _run_encoder(params, frames, cfg) if frames is not None else None
    return x, enc_out


def _logits(params: Transformer, x, cfg: ModelConfig):
    head = params.embed if cfg.tie_embeddings else params.lm_head
    logits = torch.einsum("bsd,vd->bsv", x, head.to(x.dtype))
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def forward(cfg: ModelConfig, params: Transformer, tokens, *, patch_embeds=None, frames=None,
            return_hidden: bool = False):
    """Full-sequence forward. Returns ``(logits (B, Np + S, Vpad), aux)``, or
    the post-final-norm hidden states with ``return_hidden=True``.
    ``patch_embeds (B, Np, D)`` (vision stub) come before the tokens;
    ``frames (B, T, D)`` (audio stub) feed the encoder, which every decoder
    layer cross-attends. ``aux`` sums each MoE layer's terms (``{}``
    without MoE layers)."""
    x, enc_out = _embed_inputs(params, tokens, cfg, patch_embeds, frames)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total: dict = {}
    for block in params.layers:
        x, aux = _remat(lambda h, b=block: apply_block(b, h, cfg, b.kind, positions, enc_out=enc_out), x)
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v
    x = rmsnorm(params.final_norm.scale, x, cfg.norm_eps)
    if return_hidden:
        return x, aux_total
    return _logits(params, x, cfg), aux_total


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------
def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dev) -> dict:
    dtype = _dtype(cfg)
    if kind == "recurrent":
        c = {"rec": rglru_lib.init_rglru_state(cfg, batch, dtype, device=dev)}
    elif kind == "ssm":
        c = {"ssm": ssm_lib.init_mamba_state(cfg, batch, dtype, device=dev)}
    else:
        c = {"kv": init_kv_cache(cfg, batch, max_len, kind=kind, dtype=dtype, device=dev)}
    if cfg.is_enc_dec:
        shape = (batch, cfg.encdec.encoder_frames, cfg.num_kv_heads, cfg.head_dim)
        c["cross_kv"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                         "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return c


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> list[dict]:
    """One dict per layer, in layer order (the reference stacks the scanned
    layers instead): ``{"kv": {"k", "v"}}`` for attention, ``{"rec": {"h",
    "conv"}}`` for RG-LRU and ``{"ssm": {"conv", "ssm"}}`` for Mamba layers,
    and in an encoder-decoder ``"cross_kv"`` (``(B, encoder_frames, KV,
    Dh)`` zeros, which prefill fills). ``device=None`` is the CUDA card;
    ``"meta"`` gives shapes and dtypes with nothing allocated."""
    dev = resolve_device(device)
    return [_init_block_cache(cfg, kind, batch, max_len, dev) for kind in cfg.layer_kinds()]


def decode_block(block: Block, x, bcache: dict, cfg: ModelConfig, kind: str, pos: int, *,
                 cross: bool = False):
    """One layer of one decode step; updates ``bcache`` in place. ``cross``:
    attend the encoder through ``bcache["cross_kv"]`` (an encoder-decoder)."""
    h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
    if kind == "ssm":
        h, bcache["ssm"] = ssm_lib.mamba_decode(block.ssm, h, bcache["ssm"], cfg)
        return x + h, bcache
    if kind == "recurrent":
        h, bcache["rec"] = rglru_lib.rglru_decode(block.rec, h, bcache["rec"], cfg)
    else:
        h, _ = attn_decode(block.attn, h, bcache["kv"], cfg, pos, kind=kind)
    if cfg.post_norm:
        h = rmsnorm(block.ln1_post.scale, h, cfg.norm_eps)
    x = x + h
    if cross and hasattr(block, "cross"):
        h = rmsnorm(block.lnx.scale, x, cfg.norm_eps)
        h, _ = attn_decode(block.cross, h, bcache["cross_kv"], cfg, pos, cross=True)
        x = x + h
    h, _ = _ffn(block, rmsnorm(block.ln2.scale, x, cfg.norm_eps), cfg, return_aux=False)
    if cfg.post_norm:
        h = rmsnorm(block.ln2_post.scale, h, cfg.norm_eps)
    return x + h, bcache


def decode_step(cfg: ModelConfig, params: Transformer, cache: list[dict], token, pos: int):
    """One-token decode against the cache. Returns ``(logits (B, 1, V), cache)``;
    the cache is updated in place."""
    x = _embed_tokens(params, token, cfg)
    for block, bcache in zip(params.layers, cache):
        x, _ = decode_block(block, x, bcache, cfg, block.kind, pos, cross=cfg.is_enc_dec)
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


def prefill(cfg: ModelConfig, params: Transformer, tokens, max_len: int, *, patch_embeds=None,
            frames=None):
    """Run the full prompt, building the decode cache. Returns
    ``(last_logits (B, 1, V), cache)``. ``patch_embeds`` come before the
    prompt, so ``max_len`` must cover ``Np + S`` and the tokens to decode;
    an encoder-decoder needs ``frames`` (each layer's ``cross_kv`` holds
    the encoder output's keys and values in ``cfg.dtype``)."""
    if cfg.is_enc_dec and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs frames")
    x, enc_out = _embed_inputs(params, tokens, cfg, patch_embeds, frames)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"the prompt holds {s} positions (patches included), max_len is {max_len}")
    cache = init_decode_cache(cfg, b, max_len, device=params.device)
    positions = torch.arange(s, device=x.device)
    for block, bcache in zip(params.layers, cache):
        x, state, _ = _run_block(block, x, cfg, positions, enc_out=enc_out, return_state=True,
                                 return_aux=False)
        for key, val in state.items():
            if key == "kv":
                _fill_kv(bcache, *val, block.kind)
            elif key == "cross_kv":
                bcache[key] = {"k": val[0].to(_dtype(cfg)), "v": val[1].to(_dtype(cfg))}
            else:
                bcache[key] = val
    x = rmsnorm(params.final_norm.scale, x[:, -1:, :], cfg.norm_eps)
    return _logits(params, x, cfg), cache
