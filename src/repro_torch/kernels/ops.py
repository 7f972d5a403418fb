"""Model- and engine-facing kernel entry points, and operand staging.

Port of the JAX package's ``repro.kernels.ops``. :func:`attention` is the
LM wing's attention entry: the flash-attention kernel B3 or its plain
version. ``prepare_*`` pad a sub-shard's
(or one packed tile's) edge stream to a multiple of :data:`E_BLK` with
⊕-identity weights and compute each block's base hub slot — arrays bitwise
equal to the JAX package's — and put them on ``device`` (``None``: the CUDA
card). :func:`subshard_update` runs the kernel on them
(:mod:`repro_torch.kernels.dsss_spmv`); :func:`prepare_subshard_pass`
stages many sub-shards' operands once for
:func:`~repro_torch.kernels.dsss_spmv.subshard_update_pass`, which runs them
all in one launch per phase.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.identities import padding_identity_value
from repro_torch.device import resolve_device
from repro_torch.kernels.dsss_spmv import E_BLK, SubshardPass, subshard_update
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

__all__ = [
    "attention",
    "subshard_update",
    "prepare_subshard_operands",
    "prepare_subshard_pass",
    "prepare_from_subshard",
    "prepare_from_host_block",
    "prepare_from_packed_tile",
    "E_BLK",
]


def prepare_subshard_operands(
    src_local: np.ndarray,
    hub_inv_global: np.ndarray,
    weights: np.ndarray | None,
    dtype: torch.dtype,
    *,
    gather_op: str,
    reduce: str,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad the edge arrays to E_BLK and compute the block bases.

    Returns ``(src_idx, hub_inv, weights, block_base)``. Padded edges carry
    identity weights so they contribute the ⊕-identity: ``mul``/sum w=0,
    ``add``/min w=+inf, ``add``/max w=-inf; they repeat the last hub slot.
    ``mul`` with min/max has no finite multiplicative padding identity and
    is refused.
    """
    if gather_op == "mul" and reduce != "sum":
        raise ValueError("gather_op='mul' requires reduce='sum'")
    dev = resolve_device(device)
    e = len(src_local)
    e_pad = max(E_BLK, -(-e // E_BLK) * E_BLK)
    pad = e_pad - e
    ident_w = padding_identity_value(reduce, dtype) if gather_op == "add" else 0.0
    src_idx = np.pad(src_local, (0, pad))
    hub_inv = np.pad(
        hub_inv_global, (0, pad), constant_values=hub_inv_global[-1] if e else 0
    )
    # numpy has no bfloat16: stage in float32, round once on conversion
    # (round to nearest even, as the JAX package's numpy bfloat16 does).
    w = np.empty(e_pad, np.float32)
    if weights is None:
        w[:e] = 1.0 if gather_op == "mul" else 0.0
    else:
        w[:e] = np.asarray(weights, np.float32)
    w[e:] = ident_w
    block_base = hub_inv[::E_BLK].astype(np.int32)
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    return (
        as_i32(src_idx),
        as_i32(hub_inv),
        torch.from_numpy(w).to(dtype).to(dev),
        as_i32(block_base),
    )


def prepare_subshard_pass(
    operands,
    src_offsets,
    isizes,
    num_slots,
    *,
    gather_op: str,
    reduce: str,
) -> SubshardPass:
    """Stage many sub-shards' kernel operands for one pass.

    ``operands[k]`` is sub-shard k's ``(src_idx, hub_inv, weights,
    block_base)`` as :func:`prepare_subshard_operands` (or
    ``GraphSession.kernel_operands``) staged it for this semiring, all on
    one device; the pass reads its source values from
    ``src_vals[src_offsets[k]:src_offsets[k] + isizes[k]]`` and writes
    ``num_slots[k]`` hub slots. The edge arrays are concatenated once;
    :class:`SubshardPass` finds each sub-shard's flags on the device and
    reads them back once.
    """
    n = len(operands)
    if n == 0 or not len(src_offsets) == len(isizes) == len(num_slots) == n:
        raise ValueError("give one source offset, interval size and slot count per sub-shard")
    dev = operands[0][0].device
    dtype = operands[0][2].dtype
    for k, ops in enumerate(operands):
        src_idx, hub_inv, w, base = ops
        e_pad = src_idx.shape[0]
        if e_pad == 0 or e_pad % E_BLK or base.shape != (e_pad // E_BLK,):
            raise ValueError(f"sub-shard {k}: operands are not padded to {E_BLK}-edge blocks")
        if any(t.device != dev for t in ops) or w.dtype != dtype:
            raise ValueError(f"sub-shard {k}: operands differ in device or dtype from sub-shard 0")
    slots = np.asarray(num_slots, np.int64)
    blocks = np.array([ops[3].shape[0] for ops in operands], np.int64)
    return SubshardPass(
        *(torch.cat([ops[c] for ops in operands]) for c in range(4)),
        first_block=np.concatenate([[0], np.cumsum(blocks)]),
        meta=np.stack([
            np.asarray(src_offsets, np.int64), np.asarray(isizes, np.int64), slots,
            np.cumsum(slots) - slots,
        ], axis=1),
        gather_op=gather_op, reduce=reduce,
    )


def prepare_from_subshard(ss, dtype, *, gather_op: str, reduce: str, device=None):
    """Stage kernel operands from a :class:`repro_torch.core.dsss.SubShard`."""
    return prepare_subshard_operands(
        ss.src_local, ss.hub_inv, ss.weights, dtype,
        gather_op=gather_op, reduce=reduce, device=device,
    )


def prepare_from_host_block(blk: dict, dtype, *, gather_op: str, reduce: str, device=None):
    """Stage kernel operands from a padded host block (a "shard file").

    The host buffers are bucket-padded; the kernel pads to ``E_BLK`` with
    its own identities, so it gets the unpadded ``e``-edge prefix.
    """
    e = blk["e"]
    return prepare_subshard_operands(
        blk["src_local"][:e],
        blk["hub_inv"][:e],
        None if blk["weights"] is None else blk["weights"][:e],
        dtype,
        gather_op=gather_op,
        reduce=reduce,
        device=device,
    )


def prepare_from_packed_tile(packed, t: int, dtype, *, gather_op: str, reduce: str, device=None):
    """Stage kernel operands from one destination-aligned packed tile.

    Its global hub slots (``base_slot + run_local``) are non-decreasing
    along the tile, so the windowed reduce applies unchanged. Tile source
    ids are global padded vertex ids: pass the flat ``(n_pad,)`` attributes
    as ``src_vals``. A tile whose slots decrease (a ``src_sorted`` layout)
    is refused.
    """
    e = int(packed.e_valid[t])
    hub_inv_global = packed.base_slot[t] + packed.run_local[t, :e].astype(np.int64)
    if e and np.any(np.diff(hub_inv_global) < 0):
        raise ValueError(
            f"tile {t} has decreasing hub slots (src_sorted layout?) — "
            "not a valid windowed kernel stream"
        )
    w = None if packed.weights is None else packed.weights[t, :e]
    return prepare_subshard_operands(
        packed.src[t, :e], hub_inv_global, w, dtype,
        gather_op=gather_op, reduce=reduce, device=device,
    )


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Model-facing attention entry point.

    ``use_kernel=True`` runs :func:`flash_attention`: the CUDA kernel B3 on
    a CUDA tensor (or an error), its plain version on a CPU tensor.
    ``use_kernel=False`` runs the plain materialized softmax.

    B3 has no backward pass (nor has the JAX package's Pallas kernel): with
    ``use_kernel=True``, inputs that autograd would differentiate raise
    :class:`RuntimeError` on every device, never a quiet switch to the plain
    version.
    """
    if use_kernel and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel B3 has no backward pass; train with "
            "attn_impl='ref' or 'chunked', or call it under torch.no_grad()"
        )
    fn = flash_attention if use_kernel else flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
