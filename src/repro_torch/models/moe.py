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

FSDP. Under an active mesh whose rules map ``experts`` to ``()``
(``sharding.rules.TRAIN_FSDP_RULES``), ``x`` is this rank's share of a
batch split over the rules' batch axes and the MoE's parameters are this
rank's shards. The branch is chosen by the *global* token count, as the
reference's ``pjit`` sees it. Above :data:`DENSE_PATH_MAX_TOKENS`,
:func:`_moe_fsdp_local` (the reference's ``shard_map`` body) gathers the
router, ``wi``, ``wo`` and the shared expert (cast to the compute dtype
before the gather), routes only this rank's tokens with capacity from
their count, and averages the aux terms over every rank (``pmean``). At or
below it, the dense path runs on the gathered weights and the load-balance
loss takes the global per-expert sums, as the reference's dense path over
global arrays does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, dense_init, mlp_apply, mlp_init, weight
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import active_mesh, active_rules, named_sharding

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
    Under an active FSDP mesh: the module docstring's FSDP branch.
    """
    mesh, rules = active_mesh(), active_rules()
    if mesh is not None and rules.get("experts") == ():
        return _moe_fsdp(moe, x, cfg, mesh, rules, return_aux)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs, gate_vals, expert_ids = _route(xf, moe.router, cfg)
    if t <= DENSE_PATH_MAX_TOKENS:
        shared = (moe.shared.wi, moe.shared.wo) if m.shared_ff else None
        y = _dense_path(moe.wi, moe.wo, shared, xf, cfg, gate_vals, expert_ids)
        aux = _aux(cfg, probs, expert_ids, torch.zeros((), device=x.device)) if return_aux else {}
        return y.reshape(b, s, d), aux
    y, dropped = _sorted_dispatch_compute(xf, probs, gate_vals, expert_ids, moe.wi, moe.wo, cfg)
    if m.shared_ff:
        y = y + mlp_apply(moe.shared.wi, moe.shared.wo, xf, cfg.activation)
    aux = _aux(cfg, probs, expert_ids, dropped) if return_aux else {}
    return y.reshape(b, s, d), aux


def _route(xf, router, cfg: ModelConfig):
    """Router in float32, softmax over the real experts only: ``(probs (T, E),
    gate_vals (T, k), expert_ids (T, k))``."""
    m = cfg.moe
    logits = xf.float() @ router.float()
    if m.router_softcap:
        logits = m.router_softcap * torch.tanh(logits / m.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1)
    return probs, gate_vals, expert_ids


def _sorted_dispatch_compute(xf, probs, gate_vals, expert_ids, wi, wo, cfg: ModelConfig):
    """Destination-sorted dispatch and the expert products on local arrays:
    ``xf (T, d)`` against whole ``(E_pad, ...)`` expert weights. Returns
    ``(y (T, d), dropped_fraction)``; capacity comes from T. The unsharded
    path and the FSDP branch (each rank's own tokens) both run it."""
    m = cfg.moe
    t, d = xf.shape
    e_pad, k = m.num_experts_padded, m.top_k
    dtype = xf.dtype
    order, keep, slot, cap = _placement(expert_ids, cfg)
    token_of = order // k
    x_disp = xf.new_zeros((e_pad * cap + 1, d))
    x_disp[slot] = xf[token_of]
    x_disp = x_disp[:-1].reshape(e_pad, cap, d)

    # per-expert fused-gated MLP: one dense block product per expert
    h = torch.bmm(x_disp, wi.to(dtype))
    gate, up = h.chunk(2, dim=-1)
    y_disp = torch.bmm(_act(cfg, gate) * up, wo.to(dtype)).reshape(e_pad * cap, d)

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
    return y, 1.0 - keep.float().mean()


def _placement(expert_ids, cfg: ModelConfig):
    """Where the sorted dispatch puts the T·k assignments ``expert_ids (T, k)``:
    ``(order, keep, slot, cap)``. ``order`` sorts them by expert, stably
    (token order within an expert); in that order, ``keep`` marks those
    within the capacity ``cap`` (from T) and ``slot`` is each one's row of
    the ``(E_pad·cap)`` dispatch buffer, the spare row past it if dropped."""
    m = cfg.moe
    t, k = expert_ids.shape
    e_pad = m.num_experts_padded
    cap = int(max(1, min(t, t * k * m.capacity_factor / e_pad)))
    flat_e = expert_ids.reshape(-1)  # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e_pad, device=flat_e.device))
    pos_in_e = torch.arange(t * k, device=flat_e.device) - seg_start[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e_pad * cap)
    return order, keep, slot, cap


def _full_shapes(cfg: ModelConfig) -> dict:
    """The whole shapes of the MoE's parameters, and their logical axes."""
    m, d = cfg.moe, cfg.d_model
    out = {"router": ((d, m.num_experts), ("embed", None)),
           "wi": ((m.num_experts_padded, d, 2 * m.expert_ff), ("experts", "embed", "expert_mlp")),
           "wo": ((m.num_experts_padded, m.expert_ff, d), ("experts", "expert_mlp", "embed"))}
    if m.shared_ff:
        wide = m.shared_ff if cfg.activation == "gelu_plain" else 2 * m.shared_ff
        out["shared.wi"] = ((d, wide), ("embed", "mlp"))
        out["shared.wo"] = ((m.shared_ff, d), ("mlp", "embed"))
    return out


def _gathered(moe: MoE, cfg: ModelConfig, mesh, rules, dtype) -> dict:
    """The MoE's whole weights from this rank's shards: ``wi``, ``wo`` and the
    shared expert cast to ``dtype`` before the gather, the router as it is."""
    local = {"router": moe.router, "wi": moe.wi.to(dtype), "wo": moe.wo.to(dtype)}
    if cfg.moe.shared_ff:
        local.update({"shared.wi": moe.shared.wi.to(dtype), "shared.wo": moe.shared.wo.to(dtype)})
    return {name: named_sharding(logical, shape, mesh, rules).gather(local[name])
            for name, (shape, logical) in _full_shapes(cfg).items()}


def _moe_fsdp(moe: MoE, x, cfg: ModelConfig, mesh, rules, return_aux: bool):
    """The FSDP branch: the dense path when the global token count is at most
    :data:`DENSE_PATH_MAX_TOKENS`, else :func:`_moe_fsdp_local`."""
    b, s, d = x.shape
    t = b * s
    ranks = fsdp.batch_ranks(mesh, rules)
    if t * ranks > DENSE_PATH_MAX_TOKENS:
        return _moe_fsdp_local(moe, x, cfg, mesh, rules, return_aux)
    m = cfg.moe
    w = _gathered(moe, cfg, mesh, rules, x.dtype)
    xf = x.reshape(t, d)
    probs, gate_vals, expert_ids = _route(xf, w["router"], cfg)
    shared = (w["shared.wi"], w["shared.wo"]) if m.shared_ff else None
    y = _dense_path(w["wi"], w["wo"], shared, xf, cfg, gate_vals, expert_ids)
    aux = {}
    if return_aux:
        dropped = torch.zeros((), device=x.device)
        if ranks == 1:
            aux = _aux(cfg, probs, expert_ids, dropped)
        else:
            # E · Σ_e me_e · ce_e over the global batch: the per-expert sums
            # are reduced before the product.
            tg = t * ranks
            me = fsdp.sum_over_ranks(probs.sum(dim=0), mesh) / tg
            one_hot = F.one_hot(expert_ids.long(), m.num_experts).float()
            ce = fsdp.sum_over_ranks(one_hot.sum(dim=(0, 1)), mesh) / (tg * m.top_k)
            aux = {"load_balance_loss": m.num_experts * torch.sum(me * ce), "dropped_fraction": dropped}
    return y.reshape(b, s, d), aux


def _moe_fsdp_local(moe: MoE, x, cfg: ModelConfig, mesh, rules, return_aux: bool):
    """The reference's ``shard_map`` body for the FSDP profile: this rank's
    tokens against the gathered weights, with capacity from the local token
    count; the aux terms averaged over every rank."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    w = _gathered(moe, cfg, mesh, rules, x.dtype)
    probs, gate_vals, expert_ids = _route(xf, w["router"], cfg)
    y, dropped = _sorted_dispatch_compute(xf, probs, gate_vals, expert_ids, w["wi"], w["wo"], cfg)
    if m.shared_ff:
        y = y + mlp_apply(w["shared.wi"], w["shared.wo"], xf, cfg.activation)
    aux = {}
    if return_aux:
        local = _aux(cfg, probs, expert_ids, dropped)
        aux = {k: fsdp.mean_over_ranks(v, mesh) for k, v in local.items()}
    return y.reshape(b, s, d), aux


def _dense_path(wi, wo, shared, xf, cfg: ModelConfig, gate_vals, expert_ids):
    """Every expert on every token, combined by the (sparse) top-k gate
    matrix; ``shared`` is the shared expert's ``(wi, wo)`` or ``None``."""
    m = cfg.moe
    dtype = xf.dtype
    onehot = F.one_hot(expert_ids.long(), m.num_experts_padded).float()  # (T, k, E_pad)
    combine = torch.einsum("tk,tke->te", gate_vals, onehot).to(dtype)
    # expert-major products: (T, d) against each (d, 2F) without copying the weights
    h = torch.matmul(xf, wi.to(dtype))  # (E_pad, T, 2F)
    gate, up = h.chunk(2, dim=-1)
    y_e = torch.matmul(_act(cfg, gate) * up, wo.to(dtype))  # (E_pad, T, d)
    y = torch.einsum("etd,te->td", y_e, combine)
    if shared is not None:
        y = y + mlp_apply(shared[0], shared[1], xf, cfg.activation)
    return y
