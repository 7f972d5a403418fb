"""Train step builder: loss (chunked CE + z-loss + MoE aux), gradient
accumulation, clipping, optional bf16 gradient compression, optimizer.

Port of ``repro.train.step``. Mixed precision as the reference's: the
state holds float32 master weights; each step casts every ≥ 2-D float32
parameter (by its shape in the reference's tree, ``convert.lm_tree_ndims``)
to ``cfg.dtype`` once, and the forward runs on that copy, so a tensor used
twice (a tied embedding) sums its two cotangents in ``cfg.dtype`` before
the cast's backward takes them to float32. The step updates the state in
place (under ``torch.no_grad()``) and returns it, where the reference
returns a new one. Attention runs as ``cfg.attn_impl`` says; kernel B3 has
no backward, so ``"pallas"`` raises here.

Under an active mesh (``sharding.rules.activate_mesh(mesh,
TRAIN_FSDP_RULES)``: pure FSDP) the state holds this rank's shard of every
parameter and moment (``make_train_state``), and a step takes the global
batch and keeps this rank's rows. The compute view gathers each parameter
(cast first: bf16 on the wire) when the layer that reads it runs, and again
when the layer is recomputed in backward; the gathers' backward sums every
gradient over every rank and keeps this rank's shard (``sharding/fsdp.py``).
The loss and the metrics are the global ones: the CE's sums and the token
count are summed over the ranks, the MoE's aux terms averaged
(``models/moe.py``), and ``grad_norm`` is the whole gradient's. Clipping
and the optimizer run on the shards. One rank computes exactly what the
unsharded step does.
"""
from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_tree_ndims
from repro_torch.models import forward
from repro_torch.optim.clipping import clip_scale, global_norm
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import active_mesh, active_rules, tree_shardings

__all__ = ["make_loss_fn", "make_train_step", "chunked_cross_entropy", "CE_CHUNK"]

CE_CHUNK = 256  # sequence positions per CE chunk (bounds fp32 softmax memory)


def _chunk_loss(h, head, yy, softcap):
    lg = torch.einsum("bcd,vd->bcv", h, head.to(h.dtype))
    if softcap is not None:
        lg = softcap * torch.tanh(lg / softcap)
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, torch.clamp(yy, min=0).long()[..., None])[..., 0]
    valid = (yy >= 0).float()
    nll = (lse - gold) * valid
    return nll.sum(), (torch.square(lse) * valid).sum(), valid.sum()


def chunked_cross_entropy(hidden, head, labels, *, z_loss: float = 1e-4, softcap: float | None = None):
    """Fused head projection + CE over hidden states ``(B, S, D)``, in chunks
    of :data:`CE_CHUNK` positions (labels padded with -1, which count for
    nothing). Each chunk projects through the ``(V, D)`` head, takes a
    float32 log-softmax and is recomputed in backward, so the ``(B, S, V)``
    logits never exist at once. Returns ``(mean nll + z_loss · mean lse²,
    valid count)``; under an active mesh the means and the count are over
    every rank's tokens."""
    tot, zl, cnt = _ce_sums(hidden, head, labels, softcap)
    if active_mesh() is not None:
        tot, zl, cnt = (fsdp.sum_over_ranks(v) for v in (tot, zl, cnt))
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt + z_loss * zl / cnt, cnt


def _ce_sums(hidden, head, labels, softcap):
    """This rank's CE sums: ``(Σ nll, Σ lse², valid count)``."""
    b, s, _ = hidden.shape
    nchunk = -(-s // CE_CHUNK)
    pad = nchunk * CE_CHUNK - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    remat = torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad)
    tot = zl = cnt = torch.zeros((), device=hidden.device)
    for c in range(nchunk):
        part = slice(c * CE_CHUNK, (c + 1) * CE_CHUNK)
        args = (hidden[:, part], head, labels[:, part], softcap)
        a, b_, n = checkpoint(_chunk_loss, *args, use_reentrant=False) if remat else _chunk_loss(*args)
        tot, zl, cnt = tot + a, zl + b_, cnt + n
    return tot, zl, cnt


def _cast_params_for_compute(params, cfg: ModelConfig):
    """Master-weight mixed precision: a view of ``params`` (the same module
    tree, its parameters as plain attributes) whose ≥ 2-D float32 tensors
    are cast to ``cfg.dtype`` ONCE for the step. The cast's backward takes
    the ``cfg.dtype`` cotangents back to float32 for the masters. Under an
    active mesh the view holds this rank's cast shards and reading one
    gathers it (``sharding.fsdp.gathered_view``)."""
    dtype = getattr(torch, cfg.dtype)
    ndims = lm_tree_ndims(cfg, params)

    def cast(name: str, p):
        return p.to(dtype) if ndims[name] >= 2 and p.dtype == torch.float32 else p

    if active_mesh() is not None:
        return fsdp.gathered_view(params, cfg, cast)

    def view(module, prefix: str):
        out = copy.copy(module)  # shares nothing mutable below
        out.__dict__["_parameters"] = {}
        out.__dict__["_modules"] = {k: view(sub, f"{prefix}{k}.") for k, sub in module._modules.items()}
        for k, p in module._parameters.items():
            out.__dict__[k] = cast(prefix + k, p)
        return out

    return view(params, "")


def make_loss_fn(cfg: ModelConfig, *, z_loss: float = 1e-4, moe_aux_coef: float = 0.01):
    """``loss_fn(params, batch) -> (loss, metrics)``; call ``loss.backward()``
    for the masters' gradients. ``batch``: ``tokens``, ``labels`` and, as the
    config takes them, ``patch_embeds`` (whose positions carry no loss) and
    ``frames``."""
    def loss_fn(params, batch):
        params = _cast_params_for_compute(params, cfg)
        extra = {k: batch[k] for k in ("patch_embeds", "frames") if k in batch}
        hidden, aux = forward(cfg, params, batch["tokens"], return_hidden=True, **extra)
        labels = batch["labels"]
        if cfg.vision is not None:
            # patch positions carry no next-token loss
            hidden = hidden[:, cfg.vision.num_patches:, :]
        head = params.embed if cfg.tie_embeddings else params.lm_head
        loss, tokens = chunked_cross_entropy(hidden, head, labels, z_loss=z_loss, softcap=cfg.final_softcap)
        metrics = {"ce_loss": loss, "tokens": tokens}
        if "load_balance_loss" in aux:
            loss = loss + moe_aux_coef * aux["load_balance_loss"]
            metrics["load_balance_loss"] = aux["load_balance_loss"]
            metrics["dropped_fraction"] = aux.get("dropped_fraction", 0.0)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _detached(metrics: dict) -> dict:
    return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}


def make_train_step(
    cfg: ModelConfig,
    optimizer,
    *,
    clip_norm: float = 1.0,
    accum_steps: int = 1,
    grad_sync: str = "none",  # "none" | "compressed_bf16"
    z_loss: float = 1e-4,
):
    """``train_step(state, batch) -> (state, metrics)``, updating ``state`` in place.
    Under an active mesh ``batch`` is the global batch and ``state`` this
    rank's shards (module docstring).

    ``accum_steps > 1`` runs the microbatches (the batch's leading axis
    split) one after another and sums their gradients, in bfloat16 when
    ``grad_sync == "compressed_bf16"`` (the tensor a cross-pod reduction
    would move), then divides and casts to float32. Then global-norm
    clipping and the optimizer. Metrics: ``ce_loss``, ``tokens``, ``loss``,
    ``grad_norm`` and, with MoE layers, ``load_balance_loss`` and
    ``dropped_fraction`` (means over the microbatches).
    """
    if grad_sync not in ("none", "compressed_bf16"):
        raise ValueError(f"unknown grad_sync mode {grad_sync!r}")
    loss_fn = make_loss_fn(cfg, z_loss=z_loss)
    acc_dtype = torch.bfloat16 if grad_sync == "compressed_bf16" else torch.float32

    def train_step(state, batch):
        params = state["params"]
        mesh, rules = active_mesh(), active_rules()
        if mesh is not None:
            batch = fsdp.shard_batch(batch, mesh, rules)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if accum_steps == 1:
            loss, metrics = loss_fn(params, batch)
            loss.backward()
            grads = {n: p.grad for n, p in named.items()}
            loss, metrics = loss.detach(), _detached(metrics)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])
                     for k, v in batch.items()}
            g_acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for n, p in named.items()}
            loss_sum = torch.zeros((), device=params.device)
            stack = []
            for i in range(accum_steps):
                loss, m = loss_fn(params, {k: v[i] for k, v in micro.items()})
                loss.backward()
                with torch.no_grad():
                    for n, p in named.items():
                        g_acc[n] = g_acc[n] + p.grad.to(acc_dtype)
                        p.grad = None
                loss_sum = loss_sum + loss.detach()
                stack.append(_detached(m))
            grads = {n: (g / accum_steps).to(torch.float32) for n, g in g_acc.items()}
            del g_acc
            loss = loss_sum / accum_steps
            metrics = {k: torch.stack([m[k].to(loss.device) for m in stack]).mean() for k in stack[0]}
        with torch.no_grad():
            if mesh is None:
                gnorm = global_norm(grads)
            else:
                gnorm = fsdp.global_norm(grads, tree_shardings(params, mesh, rules), mesh)
            scale = clip_scale(gnorm, clip_norm)
            for g in grads.values():  # clip_by_global_norm, in place
                g.mul_(scale)
            optimizer.update(grads, state["opt_state"], params)
        for p in named.values():
            p.grad = None
        del grads
        metrics["grad_norm"] = gnorm
        metrics["loss"] = loss
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step
