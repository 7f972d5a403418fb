"""The sub-shard ToHub update: CUDA kernel wrapper and its plain PyTorch version.

Port of the JAX package's Pallas ``repro.kernels.dsss_spmv`` and of the slot
fold in its ``repro.kernels.ops.subshard_update``. A sub-shard's (or a
packed tile's) destination-sorted edge stream, padded to a multiple of
:data:`E_BLK`, is cut into 512-edge blocks. For edge ``e`` of block ``b``:

* ``contrib[e] = src_vals[src_idx[e]] ⊙ w[e]`` (⊙ = ``mul`` or ``add``),
  rounded to the value dtype;
* its window slot is ``hub_inv[e] - block_base[b]``; edges outside
  ``[0, W)`` are dropped (``W = E_BLK``).

:func:`dsss_spmv_block_partials` returns the ``(num_blocks, W)`` windowed
partials: each entry the fold, in edge order, of its edges' contribs from
``padding_identity``. :func:`subshard_update` then folds, for each hub slot
``s < num_slots``, the partials of the blocks whose window covers ``s`` in
ascending block order from ``segment_fill_value``. A bfloat16 sum
accumulates in float32 within a block and rounds once per partial; the slot
fold adds in the value dtype.

On a CPU tensor the wrappers run the plain version
(:func:`dsss_spmv_block_partials_ref`, :func:`subshard_update_ref`); on a
CUDA tensor they launch the hand-written kernel of ``csrc/dsss_spmv.cu`` or
raise. Both fold in the same orders and use no atomics, so they agree bit
for bit and a repeated call gives the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.identities import padding_identity, segment_fill_value

__all__ = [
    "dsss_spmv_block_partials",
    "dsss_spmv_block_partials_ref",
    "subshard_update",
    "subshard_update_ref",
    "launches",
    "E_BLK",
]

E_BLK = 512  # edges per block; also the hub-slot window width W

# Kernel launches of dsss_spmv_block_partials and subshard_update on CUDA
# tensors (one per call that reaches the card). Callers reset it to 0 and
# read it around a run.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GATHER_OPS = {"mul": 0, "add": 1}
_REDUCES = {"sum": 0, "min": 1, "max": 2}


def _validate(src_vals, src_idx, hub_inv, weights, block_base, gather_op, reduce):
    if gather_op not in _GATHER_OPS:
        raise ValueError(f"gather_op must be 'mul' or 'add', got {gather_op!r}")
    if reduce not in _REDUCES:
        raise ValueError(f"reduce must be 'sum', 'min' or 'max', got {reduce!r}")
    if src_vals.dtype not in _DTYPES:
        raise TypeError(f"src_vals must be float32 or bfloat16, got {src_vals.dtype}")
    if src_vals.ndim != 1:
        raise ValueError(f"src_vals must be 1-D, got shape {tuple(src_vals.shape)}")
    e_pad = src_idx.shape[0]
    if src_idx.ndim != 1 or e_pad == 0 or e_pad % E_BLK:
        raise ValueError(f"pad edges to a non-zero multiple of {E_BLK}, got {tuple(src_idx.shape)}")
    want = {
        "src_idx": (src_idx, torch.int32, (e_pad,)),
        "hub_inv": (hub_inv, torch.int32, (e_pad,)),
        "weights": (weights, src_vals.dtype, (e_pad,)),
        "block_base": (block_base, torch.int32, (e_pad // E_BLK,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != src_vals.device:
            raise ValueError(f"{name} is on {t.device}, src_vals on {src_vals.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------
def _combine(reduce: str, acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's ⊕: a rounded add, or a compare that keeps ``acc`` on ties."""
    if reduce == "sum":
        return acc + x
    if reduce == "min":
        return torch.where(x < acc, x, acc)
    return torch.where(x > acc, x, acc)


def _ordered_fold(
    values: torch.Tensor, group: torch.Tensor, out: torch.Tensor, reduce: str
) -> torch.Tensor:
    """Fold ``values`` into ``out[group]`` in ascending position, in place.

    Each group's left fold starts from its entry of ``out``. The loop runs
    over the position inside a group, vectorised across groups; groups are
    ordered longest first so the groups still open at position ``j`` are a
    prefix. Never ``index_add_`` or ``cumsum``, whose order differs.
    """
    if values.numel() == 0:
        return out
    order = torch.sort(group, stable=True).indices
    ids, counts = torch.unique_consecutive(group[order], return_counts=True)
    grouped = values[order]
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.sort(counts, descending=True, stable=True).indices
    open_at = torch.bincount(counts).flip(0).cumsum(0).flip(0).tolist()
    start_by_len = starts[by_len]
    acc = out[ids[by_len]]
    for j in range(len(open_at) - 1):
        c = open_at[j + 1]  # groups with more than j values
        acc[:c] = _combine(reduce, acc[:c], grouped[start_by_len[:c] + j])
    out[ids[by_len]] = acc
    return out


def _contrib(src_vals, src_idx, weights, gather_op) -> torch.Tensor:
    vals = src_vals[src_idx.long()]
    return vals * weights if gather_op == "mul" else vals + weights


def dsss_spmv_block_partials_ref(
    src_vals: torch.Tensor,  # (isize,) float32 | bfloat16
    src_idx: torch.Tensor,  # (E_pad,) int32, E_pad % E_BLK == 0
    hub_inv: torch.Tensor,  # (E_pad,) int32 hub slots (non-decreasing)
    weights: torch.Tensor,  # (E_pad,) src_vals' dtype, identity-padded
    block_base: torch.Tensor,  # (num_blocks,) int32 = hub_inv[b * E_BLK]
    *,
    gather_op: str = "mul",
    reduce: str = "sum",
) -> torch.Tensor:
    """Plain version of the block partials: ``(num_blocks, W)`` in src_vals' dtype."""
    dtype = src_vals.dtype
    nb = block_base.shape[0]
    contrib = _contrib(src_vals, src_idx, weights, gather_op)
    block = torch.arange(src_idx.shape[0], device=src_idx.device) // E_BLK
    slot = hub_inv.long() - block_base.long()[block]
    keep = (slot >= 0) & (slot < E_BLK)
    # A bf16 sum accumulates in float32 and rounds once per partial.
    acc_dtype = torch.float32 if reduce == "sum" else dtype
    out = padding_identity(reduce, acc_dtype).to(src_vals.device).repeat(nb * E_BLK)
    _ordered_fold(contrib[keep].to(acc_dtype), (block * E_BLK + slot)[keep], out, reduce)
    return out.to(dtype).reshape(nb, E_BLK)


def _slot_fold_ref(partials, block_base, num_slots: int, reduce: str) -> torch.Tensor:
    nb = block_base.shape[0]
    dev = partials.device
    slot_ids = (block_base.long()[:, None] + torch.arange(E_BLK, device=dev)).reshape(-1)
    keep = (slot_ids >= 0) & (slot_ids < num_slots)
    fill = segment_fill_value(reduce, partials.dtype).to(dev)
    out = fill.repeat(num_slots)
    return _ordered_fold(partials.reshape(nb * E_BLK)[keep], slot_ids[keep], out, reduce)


def subshard_update_ref(
    src_vals: torch.Tensor,
    src_idx: torch.Tensor,
    hub_inv: torch.Tensor,
    weights: torch.Tensor,
    block_base: torch.Tensor,
    num_slots: int,
    *,
    gather_op: str = "mul",
    reduce: str = "sum",
) -> torch.Tensor:
    """Plain version of the full ToHub update: ``(num_slots,)`` hub values."""
    partials = dsss_spmv_block_partials_ref(
        src_vals, src_idx, hub_inv, weights, block_base,
        gather_op=gather_op, reduce=reduce,
    )
    return _slot_fold_ref(partials, block_base, int(num_slots), reduce)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------
_ARGTYPES = (
    [ctypes.c_int] * 6  # dtype, gather_op, reduce, isize, num_blocks, num_slots
    + [ctypes.c_void_p] * 8  # src_vals, src_idx, hub_inv, w, block_base,
    # partials, out, flag
    + [ctypes.c_void_p]  # stream
)


def _library():
    from repro_torch.kernels import _build

    fn = _build.load("dsss_spmv").dsss_spmv_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(src_vals, src_idx, hub_inv, weights, block_base, num_slots, gather_op, reduce):
    """Launch phase 1 (and, unless ``num_slots`` is None, phase 2) on the card."""
    global launches
    dev = src_vals.device
    nb = block_base.shape[0]
    for name, t in (("src_vals", src_vals), ("src_idx", src_idx), ("hub_inv", hub_inv),
                    ("weights", weights), ("block_base", block_base)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src_vals.shape[0] >= 2**31 or (num_slots or 0) >= 2**31:
        raise ValueError("dsss_spmv indexes with int32: isize and num_slots must be < 2**31")
    partials = torch.empty((nb, E_BLK), dtype=src_vals.dtype, device=dev)
    out = flag = None
    if num_slots is not None:
        out = torch.empty((num_slots,), dtype=src_vals.dtype, device=dev)
        flag = torch.empty((1,), dtype=torch.int32, device=dev)  # phase 1 writes it
    err = _library()(
        _DTYPES[src_vals.dtype], _GATHER_OPS[gather_op], _REDUCES[reduce],
        src_vals.shape[0], nb, -1 if num_slots is None else num_slots,
        src_vals.data_ptr(), src_idx.data_ptr(), hub_inv.data_ptr(),
        weights.data_ptr(), block_base.data_ptr(), partials.data_ptr(),
        None if out is None else out.data_ptr(),
        None if flag is None else flag.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dsss_spmv kernel launch failed: CUDA error {err}")
    launches += 1
    return partials if out is None else out


def _route(src_vals) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (CPU)."""
    if src_vals.device.type == "cpu":
        return False
    if src_vals.device.type != "cuda":
        raise ValueError(f"no dsss_spmv kernel for device {src_vals.device}")
    return True


def dsss_spmv_block_partials(
    src_vals: torch.Tensor,
    src_idx: torch.Tensor,
    hub_inv: torch.Tensor,
    weights: torch.Tensor,
    block_base: torch.Tensor,
    *,
    gather_op: str = "mul",
    reduce: str = "sum",
) -> torch.Tensor:
    """The ``(num_blocks, W)`` windowed hub partials of every edge block."""
    _validate(src_vals, src_idx, hub_inv, weights, block_base, gather_op, reduce)
    if _route(src_vals):
        return _launch(src_vals, src_idx, hub_inv, weights, block_base, None, gather_op, reduce)
    return dsss_spmv_block_partials_ref(
        src_vals, src_idx, hub_inv, weights, block_base, gather_op=gather_op, reduce=reduce
    )


def subshard_update(
    src_vals: torch.Tensor,  # (isize,)
    src_idx: torch.Tensor,  # (E_pad,) from ops.prepare_subshard_operands
    hub_inv: torch.Tensor,
    weights: torch.Tensor,
    block_base: torch.Tensor,
    num_slots: int,
    *,
    gather_op: str = "mul",
    reduce: str = "sum",
) -> torch.Tensor:
    """Full sub-shard ToHub: the ``(num_slots,)`` hub vector."""
    _validate(src_vals, src_idx, hub_inv, weights, block_base, gather_op, reduce)
    num_slots = int(num_slots)
    if num_slots < 0:
        raise ValueError(f"num_slots must be >= 0, got {num_slots}")
    if _route(src_vals):
        return _launch(
            src_vals, src_idx, hub_inv, weights, block_base, num_slots, gather_op, reduce
        )
    return subshard_update_ref(
        src_vals, src_idx, hub_inv, weights, block_base, num_slots,
        gather_op=gather_op, reduce=reduce,
    )
