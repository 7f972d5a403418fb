"""Mixture-of-Experts layer: shared + routed top-k, sort-based dispatch.

Port of the JAX package's ``repro.models.moe``. Token→expert dispatch is a
bipartite graph update: the (token, expert) assignments are sorted by
expert id, the analogue of the paper's destination-sorted edges, so each
expert's tokens are a contiguous block and its MLP is one dense block
product. A capacity factor bounds the block size.

Experts are padded to a multiple of 16 (qwen2-moe: 60 → 64); the dummy
experts have zero weights and the router never emits them.

:class:`MoE` stores ``wi``/``wo`` and the shared expert in ``cfg.dtype``
and the router in ``cfg.param_dtype``: the reference routes in float32.

The combine does not scatter-add (a float scatter-add on the card folds in
no fixed order): each assignment's weighted output goes back to its
(token, k) position and the k outputs of a token are summed in k order.
The reference's FSDP branch (``_moe_fsdp_local``, a ``shard_map`` under an
active mesh and sharding rules) is ROADMAP A13 item 4.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, dense_init, mlp_apply, mlp_init, weight

__all__ = ["MoE", "moe_init", "moe_apply", "DENSE_PATH_MAX_TOKENS"]

DENSE_PATH_MAX_TOKENS = 256  # at most this many tokens: the exact dropless path


class MoE(nn.Module):
    """``router (d, E)``, routed experts ``wi (E_pad, d, 2·F)`` (``[gate; up]``)
    and ``wo (E_pad, F, d)``, and the ``shared`` expert(s) as one MLP."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        wd = getattr(torch, cfg.dtype)
        self.router = weight((d, m.num_experts), getattr(torch, cfg.param_dtype), device)
        self.wi = weight((m.num_experts_padded, d, 2 * m.expert_ff), wd, device)
        self.wo = weight((m.num_experts_padded, m.expert_ff, d), wd, device)
        if m.shared_ff:
            self.shared = MLP(d, m.shared_ff, cfg.activation, dtype=wd, device=device)


@torch.no_grad()
def moe_init(moe: MoE, cfg: ModelConfig, generator: torch.Generator) -> MoE:
    """Draw the reference's initial values; the dummy experts are zero."""
    m, d = cfg.moe, cfg.d_model
    e_pad = m.num_experts_padded
    moe.router.copy_(dense_init((d, m.num_experts), generator))
    moe.wi.copy_(dense_init((e_pad, d, 2 * m.expert_ff), generator, fan_in=d))
    moe.wo.copy_(dense_init((e_pad, m.expert_ff, d), generator, fan_in=m.expert_ff))
    moe.wi[m.num_experts:] = 0
    moe.wo[m.num_experts:] = 0
    if m.shared_ff:
        mlp_init(moe.shared, generator)
    return moe


def _act(cfg: ModelConfig, g):
    return F.silu(g) if cfg.activation == "silu" else F.gelu(g, approximate="tanh")


def _aux(cfg: ModelConfig, probs, expert_ids, dropped) -> dict:
    """GShard/Switch load-balance loss ``E · Σ_e f_e · p_e`` and the dropped share."""
    m = cfg.moe
    t = probs.shape[0]
    me = probs.mean(dim=0)  # (E,)
    one_hot = F.one_hot(expert_ids.long(), m.num_experts).float()
    ce = one_hot.sum(dim=(0, 1)) / (t * m.top_k)
    return {"load_balance_loss": m.num_experts * torch.sum(me * ce), "dropped_fraction": dropped}


def moe_apply(moe: MoE, x, cfg: ModelConfig, *, return_aux: bool = True):
    """x: (B, S, D) -> ``(y, aux)``; ``aux`` holds ``load_balance_loss`` and
    ``dropped_fraction`` (``{}`` with ``return_aux=False``).

    At most :data:`DENSE_PATH_MAX_TOKENS` tokens (decode, short prefill):
    every expert on every token, combined by the top-k gates, exact and
    dropless. More: the sorted capacity dispatch, which may drop overflow.
    """
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e_pad, k = m.num_experts_padded, m.top_k
    xf = x.reshape(t, d)
    dtype = x.dtype
    # Router in float32, softmax over the real experts only.
    logits = xf.float() @ moe.router.float()
    if m.router_softcap:
        logits = m.router_softcap * torch.tanh(logits / m.router_softcap)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)  # (T, k)

    if t <= DENSE_PATH_MAX_TOKENS:
        y = _dense_path(moe, xf, cfg, gate_vals, expert_ids)
        aux = _aux(cfg, probs, expert_ids, torch.zeros((), device=x.device)) if return_aux else {}
        return y.reshape(b, s, d), aux

    # Destination-sorted dispatch: assignments sorted by expert, slotted into (E_pad, cap).
    cap = int(max(1, min(t, t * k * m.capacity_factor / e_pad)))
    flat_e = expert_ids.reshape(-1)  # (T·k,)
    order = torch.argsort(flat_e, stable=True)  # keeps token order within an expert
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e_pad, device=x.device))
    pos_in_e = torch.arange(t * k, device=x.device) - seg_start[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e_pad * cap)  # drop -> the spare row
    token_of = order // k
    x_disp = xf.new_zeros((e_pad * cap + 1, d))
    x_disp[slot] = xf[token_of]
    x_disp = x_disp[:-1].reshape(e_pad, cap, d)

    # per-expert fused-gated MLP: one dense block product per expert
    h = torch.bmm(x_disp, moe.wi.to(dtype))
    gate, up = h.chunk(2, dim=-1)
    y_disp = torch.bmm(_act(cfg, gate) * up, moe.wo.to(dtype)).reshape(e_pad * cap, d)

    # combine: gather back, weight by the gates (permuted into sorted order:
    # gate_vals is token-major), put each back at its (token, k) position
    gathered = torch.cat([y_disp, y_disp.new_zeros((1, d))])[slot]  # (T·k, d)
    w = (gate_vals.reshape(-1)[order] * keep).to(dtype)
    by_pos = torch.empty_like(gathered)
    by_pos[order] = gathered * w[:, None]
    by_pos = by_pos.reshape(t, k, d)
    y = by_pos[:, 0]
    for j in range(1, k):
        y = y + by_pos[:, j]
    if m.shared_ff:
        y = y + mlp_apply(moe.shared.wi, moe.shared.wo, xf, cfg.activation)
    aux = _aux(cfg, probs, expert_ids, 1.0 - keep.float().mean()) if return_aux else {}
    return y.reshape(b, s, d), aux


def _dense_path(moe: MoE, xf, cfg: ModelConfig, gate_vals, expert_ids):
    """Every expert on every token, combined by the (sparse) top-k gate matrix."""
    m = cfg.moe
    dtype = xf.dtype
    onehot = F.one_hot(expert_ids.long(), m.num_experts_padded).float()  # (T, k, E_pad)
    combine = torch.einsum("tk,tke->te", gate_vals, onehot).to(dtype)
    # expert-major products: (T, d) against each (d, 2F) without copying the weights
    h = torch.matmul(xf, moe.wi.to(dtype))  # (E_pad, T, 2F)
    gate, up = h.chunk(2, dim=-1)
    y_e = torch.matmul(_act(cfg, gate) * up, moe.wo.to(dtype))  # (E_pad, T, d)
    y = torch.einsum("etd,te->td", y_e, combine)
    if m.shared_ff:
        y = y + mlp_apply(moe.shared.wi, moe.shared.wo, xf, cfg.activation)
    return y
