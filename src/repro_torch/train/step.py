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
    valid count)``."""
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
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt + z_loss * zl / cnt, cnt


def _cast_params_for_compute(params, cfg: ModelConfig):
    """Master-weight mixed precision: a view of ``params`` (the same module
    tree, its parameters as plain attributes) whose ≥ 2-D float32 tensors
    are cast to ``cfg.dtype`` ONCE for the step. The cast's backward takes
    the ``cfg.dtype`` cotangents back to float32 for the masters."""
    dtype = getattr(torch, cfg.dtype)
    ndims = lm_tree_ndims(cfg, params)

    def view(module, prefix: str):
        out = copy.copy(module)  # shares nothing mutable below
        out.__dict__["_parameters"] = {}
        out.__dict__["_modules"] = {k: view(sub, f"{prefix}{k}.") for k, sub in module._modules.items()}
        for k, p in module._parameters.items():
            cast = ndims[prefix + k] >= 2 and p.dtype == torch.float32
            out.__dict__[k] = p.to(dtype) if cast else p
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
            gnorm = global_norm(grads)
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
