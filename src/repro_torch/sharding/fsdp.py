"""FSDP over a ``torch.distributed`` mesh: the collectives of the training
profile (``TRAIN_FSDP_RULES``: the batch split over every mesh axis, every
parameter and moment kept as this rank's shard).

The reference runs one program under ``pjit``, whose partitioner inserts
the gathers and reductions; the port runs one process per rank and makes
them explicit here:

- :func:`gather` — a shard to the whole tensor, gathered over one mesh
  axis at a time with the axes in reverse order (the reference's
  ``_gather_full``), in the dtype it is given (the compute view casts
  before it: bf16 on the wire). Its backward is the reduce-scatter, which
  gloo lacks: one ``all_to_all`` sends each rank its slice of this rank's
  cotangent (in the cotangent's dtype), and the slices received are added
  in float32 in rank order. Float32 adds bf16 values exactly unless their
  exponents lie more than 14 binades apart, so the sum is the same in any
  order; it is rounded once to the shard's dtype.
- Both move through ``all_to_all_single``. On gloo a CUDA tensor goes
  through page-locked host copies, and gloo runs its CPU path: gloo's
  own CUDA path and its ``all_gather``/``all_reduce`` were 1.3–4× slower
  for ranks sharing one H100 (``PERF.md``, PR 25).
- :func:`sum_over_ranks` / :func:`mean_over_ranks` — a replicated value
  from each rank's part (the CE sums, the MoE's statistics); the backward
  passes the cotangent straight to this rank's part, since every rank
  differentiates the same replicated loss and the gathers' backward sums
  the ranks' contributions once.
- :func:`gathered_view` — the train step's compute view of a sharded
  module: reading a parameter gathers it, inside the layer that reads it,
  so a layer's whole weights live only while it runs (and are gathered
  again when the layer is recomputed in backward). The MoE reads its own
  shards: its FSDP branch gathers them (``models/moe.py``).
- :func:`shard_module_`, :func:`shard_batch`, :func:`global_norm`.

With one rank nothing here communicates or wraps a tensor, so a (1, 1)
mesh runs the unsharded arithmetic bit for bit. :data:`gathered_bytes` and
:data:`reduced_bytes` count the parameter traffic of this process: the
bytes of each whole tensor a gather makes and of each cotangent summed.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding.rules import (
    NamedSharding,
    active_mesh,
    active_rules,
    entry_axes,
    mesh_shape,
    spec_for,
    tree_shardings,
)

__all__ = [
    "gather",
    "sum_over_ranks",
    "mean_over_ranks",
    "num_ranks",
    "batch_ranks",
    "check_fsdp_rules",
    "shard_module_",
    "shard_batch",
    "gathered_view",
    "global_norm",
]

gathered_bytes = 0  # bytes of the whole tensors gathered by this process
reduced_bytes = 0  # bytes of the cotangents summed over the ranks by this process


def num_ranks(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def batch_ranks(mesh, rules: dict) -> int:
    """How many ranks a batch is split over under ``rules``: the product of
    the mesh axes its ``batch`` entry names."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in rules.get("batch", ()) if a in shape)


def check_fsdp_rules(mesh, rules: dict) -> None:
    """The sharded train step sums every gradient over every rank, which is
    right only when the batch is split over every mesh axis (the FSDP
    profile); other rules raise."""
    shape = mesh_shape(mesh)
    missing = [a for a, n in shape.items() if n > 1 and a not in rules.get("batch", ())]
    if missing:
        raise ValueError(f"the batch is not split over mesh axes {missing}: the port trains on a mesh "
                         "under TRAIN_FSDP_RULES only")


def _world(mesh):
    n = num_ranks(mesh)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ValueError(f"the mesh holds {n} ranks; its collectives need a default group of exactly those")
    return dist.group.WORLD


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``send``: chunk ``j`` of its leading axis to
    group rank ``j``; returns the chunks received, in group-rank order."""
    if send.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host.copy_(send)
        recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        dist.all_to_all_single(recv, host, group=group)
        return recv.to(send.device, non_blocking=True)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def _axis_gather(w: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate along ``dim`` the pieces of every rank on this rank's line
    along ``axis``, in coordinate order: each rank sends its piece to each."""
    group = mesh.get_group(axis)
    names = list(mesh.mesh_dim_names)
    line = list(mesh.get_coordinate())
    line[names.index(axis)] = slice(None)
    order = [dist.get_group_rank(group, int(r)) for r in mesh.mesh[tuple(line)].tolist()]
    parts = _all_to_all(w.unsqueeze(0).expand(len(order), *w.shape).contiguous(), group)
    return torch.cat([parts[g] for g in order], dim=dim)


def _gather_now(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    global gathered_bytes
    shape = mesh_shape(sharding.mesh)
    w = local
    for d, e in enumerate(sharding.spec):
        for a in reversed(entry_axes(e)):
            if shape[a] > 1:
                w = _axis_gather(w.contiguous(), sharding.mesh, a, d)
    if w is not local:
        gathered_bytes += w.numel() * w.element_size()
    return w


def _reduce_scatter(g: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of the sum over every rank of ``g`` (each rank's
    whole cotangent), added in float32 in rank order."""
    global reduced_bytes
    mesh = sharding.mesh
    where = {int(r): tuple(i) for i, r in np.ndenumerate(mesh.mesh.cpu().numpy())}
    pieces = [sharding.shard(g, coordinate=where[r]) for r in range(num_ranks(mesh))]
    recv = _all_to_all(torch.stack(pieces), _world(mesh))
    reduced_bytes += g.numel() * g.element_size()
    total = recv[0].float()
    for piece in recv[1:]:
        total = total + piece.float()
    return total


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, sharding):
        ctx.sharding, ctx.dtype = sharding, local.dtype
        out = _gather_now(local, sharding)
        return local.view_as(local) if out is local else out

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.sharding).to(ctx.dtype), None


def gather(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole tensor from this rank's shard under ``sharding`` (every rank
    of the mesh calls it). Under autograd, the backward sums the cotangent
    over every rank in float32 and returns this rank's slice."""
    if num_ranks(sharding.mesh) == 1:
        return local
    if torch.is_grad_enabled() and local.requires_grad:
        return _Gather.apply(local, sharding)
    return _gather_now(local, sharding)


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().clone()
        dist.all_reduce(y, group=_world(mesh))
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Σ over every rank of the mesh (the active one by default) of each
    rank's ``x``; the backward keeps this rank's part (see the module
    docstring). One rank: ``x`` itself."""
    mesh = mesh if mesh is not None else active_mesh()
    if num_ranks(mesh) == 1:
        return x
    return _SumRanks.apply(x, mesh)


def mean_over_ranks(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's ``pmean`` over every mesh axis."""
    mesh = mesh if mesh is not None else active_mesh()
    n = num_ranks(mesh)
    return x if n == 1 else sum_over_ranks(x, mesh) / n


@torch.no_grad()
def shard_module_(module: nn.Module, shardings: dict) -> nn.Module:
    """Replace each parameter of ``module`` by this rank's shard of it (a
    copy of its own: the whole tensor is freed), keeping ``requires_grad``."""
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        local = shardings[name].shard(p.detach()).clone()
        owner._parameters[leaf] = nn.Parameter(local, requires_grad=p.requires_grad)
    return module


def shard_batch(batch: dict, mesh, rules: dict) -> dict:
    """This rank's rows of each array of a global ``batch``, split over the
    mesh axes of the rules' ``batch`` entry, which must divide it and cover
    every axis (:func:`check_fsdp_rules`)."""
    check_fsdp_rules(mesh, rules)
    want = {a for a, n in mesh_shape(mesh).items() if n > 1}
    out = {}
    for k, v in batch.items():
        sh = NamedSharding(mesh, spec_for(("batch",) + (None,) * (v.ndim - 1), tuple(v.shape), mesh, rules))
        if not want <= set(entry_axes(sh.spec[0])):
            raise ValueError(f"{k}: a global batch of {v.shape[0]} does not split over mesh axes {sorted(want)}")
        out[k] = sh.shard(v)
    return out


class _View:
    """One module of the compute view: its parameters as the view gives them
    (a tensor, or a sharding to gather the shard with on each read), its
    submodules as views; any other attribute is the module's own."""

    def __init__(self, module, reads: dict, subs: dict):
        self.__dict__.update(_module=module, _reads=reads, _subs=subs)

    def __getattr__(self, name):
        d = self.__dict__
        if name in d["_reads"]:
            local, sharding = d["_reads"][name]
            return local if sharding is None else gather(local, sharding)
        if name in d["_subs"]:
            return d["_subs"][name]
        return getattr(d["_module"], name)


def gathered_view(params: nn.Module, cfg, cast) -> _View:
    """The compute view of ``params`` (a ``Transformer`` holding this rank's
    shards) under the active mesh and rules.
    ``cast(name, p)`` gives the local tensor to compute with (the train
    step's cast to ``cfg.dtype``, done here once); reading a parameter
    gathers it then. An MoE module's parameters read as the local tensors:
    its FSDP branch gathers them itself."""
    from repro_torch.models.moe import MoE

    shardings = tree_shardings(params, active_mesh(), active_rules(), cfg=cfg)

    def build(module, prefix: str, on_read: bool):
        on_read = on_read and not isinstance(module, MoE)
        reads = {k: (cast(prefix + k, p), shardings[prefix + k] if on_read else None)
                 for k, p in module._parameters.items()}
        subs = {}
        for k, sub in module._modules.items():
            if isinstance(sub, nn.ModuleList):
                subs[k] = [build(s, f"{prefix}{k}.{i}.", on_read) for i, s in enumerate(sub)]
            else:
                subs[k] = build(sub, f"{prefix}{k}.", on_read)
        return _View(module, reads, subs)

    return build(params, "", True)


def global_norm(grads: dict, shardings: dict, mesh) -> torch.Tensor:
    """The whole gradient's global norm from this rank's shards: each
    tensor's squared sum counted by the ranks at coordinate 0 on every axis
    it is not split over (so a replicated element counts once), summed over
    the ranks. One rank: ``optim.clipping.global_norm``."""
    from repro_torch.optim.clipping import global_norm as plain_norm

    if num_ranks(mesh) == 1:
        return plain_norm(grads)
    shape = mesh_shape(mesh)
    coord = next(iter(shardings.values())).coordinate()
    total = 0.0
    for n, g in grads.items():
        used = {a for e in shardings[n].spec for a in entry_axes(e)}
        owner = all(coord[a] == 0 for a in shape if a not in used)
        s = torch.sum(torch.square(g.float()))
        total = total + (s if owner else torch.zeros_like(s))
    return torch.sqrt(sum_over_ranks(total, mesh))
