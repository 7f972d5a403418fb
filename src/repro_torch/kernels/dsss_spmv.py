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

A source index outside ``[0, isize)`` gives a NaN contrib, which poisons
its own slot under a sum and is dropped under min/max (the TPU kernel's
one-hot product spreads it over the block's window instead).

:func:`subshard_update_pass` is the same update for every sub-shard of a
sweep in one launch per phase, over a :class:`SubshardPass` that
:func:`repro_torch.kernels.ops.prepare_subshard_pass` stages once; it
returns the hub vectors concatenated, with their offsets.

On a CPU tensor the wrappers run the plain version
(:func:`dsss_spmv_block_partials_ref`, :func:`subshard_update_ref`,
:func:`subshard_update_pass_ref`); on a CUDA tensor they launch the
hand-written kernel of ``csrc/dsss_spmv.cu`` or raise. Both fold in the
same orders and use no atomics, so they agree bit for bit and a repeated
call gives the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.identities import padding_identity, segment_fill_value

__all__ = [
    "dsss_spmv_block_partials",
    "dsss_spmv_block_partials_ref",
    "subshard_update",
    "subshard_update_ref",
    "subshard_update_pass",
    "subshard_update_pass_ref",
    "SubshardPass",
    "launches",
    "E_BLK",
]

E_BLK = 512  # edges per block; also the hub-slot window width W

# Kernel launches of dsss_spmv_block_partials, subshard_update and
# subshard_update_pass on CUDA tensors (one per call that reaches the card).
# Callers reset it to 0 and read it around a run.
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
    idx = src_idx.long()
    isize = src_vals.shape[0]
    inside = (idx >= 0) & (idx < isize)
    vals = torch.full(idx.shape, float("nan"), dtype=src_vals.dtype, device=src_vals.device)
    if isize:
        vals = torch.where(inside, src_vals[idx.clamp(0, isize - 1)], vals)
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


def _decreases(v: torch.Tensor, bounds: np.ndarray) -> torch.Tensor:
    """(len(bounds) - 1,) bool: does ``v[bounds[k]:bounds[k + 1]]`` decrease somewhere?"""
    down = torch.zeros(v.shape[0] + 1, dtype=torch.int64, device=v.device)
    down[2:] = (v[1:] < v[:-1]).long()
    count = torch.cumsum(down, 0)  # count[j]: decreases at positions 1 .. j-1
    b = torch.from_numpy(bounds.astype(np.int64)).to(v.device)
    return count[b[1:]] - count[b[:-1] + 1] > 0


@dataclasses.dataclass(frozen=True)
class SubshardPass:
    """The kernel operands of many sub-shards, staged for one launch per phase.

    Built by :func:`repro_torch.kernels.ops.prepare_subshard_pass`. The
    sub-shards' edge arrays are concatenated (``src_idx``, ``hub_inv``,
    ``weights``, ``block_base``, all on one device); ``first_block``
    ``(num_ss + 1,)`` bounds each sub-shard's blocks and ``meta[k]`` is
    sub-shard k's ``(src_off, isize, num_slots, out_off)`` (host int arrays).
    Construction checks them and derives the rest once: each sub-shard's
    flags (``flags[0, k]``: its slots decrease somewhere, so it takes the
    general path; ``flags[1, k]``: its ``block_base`` decreases), the
    flagged sub-shards and their slot offsets, and the int32 device copies
    of the tables (``tables``) that the kernel reads. A malformed staging
    raises here.
    """

    src_idx: torch.Tensor
    hub_inv: torch.Tensor
    weights: torch.Tensor
    block_base: torch.Tensor
    first_block: np.ndarray
    meta: np.ndarray
    gather_op: str
    reduce: str

    def __post_init__(self) -> None:
        if self.gather_op not in _GATHER_OPS or self.reduce not in _REDUCES:
            raise ValueError(f"unknown semiring {self.gather_op!r}/{self.reduce!r}")
        if self.weights.dtype not in _DTYPES:
            raise TypeError(f"weights must be float32 or bfloat16, got {self.weights.dtype}")
        e_pad = self.src_idx.shape[0]
        if self.src_idx.ndim != 1 or e_pad == 0 or e_pad % E_BLK:
            raise ValueError(f"pad edges to a non-zero multiple of {E_BLK}, got {tuple(self.src_idx.shape)}")
        if e_pad >= 2**31:
            raise ValueError(f"a pass of {e_pad} padded edges exceeds int32 indexing (2**31)")
        nb = e_pad // E_BLK
        dev = self.weights.device
        for name, t, dtype, shape in (
            ("src_idx", self.src_idx, torch.int32, (e_pad,)),
            ("hub_inv", self.hub_inv, torch.int32, (e_pad,)),
            ("weights", self.weights, self.weights.dtype, (e_pad,)),
            ("block_base", self.block_base, torch.int32, (nb,)),
        ):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, weights on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        fb = np.asarray(self.first_block, np.int64)
        meta = np.asarray(self.meta, np.int64)
        n = fb.shape[0] - 1
        if fb.ndim != 1 or n < 1 or meta.shape != (n, 4):
            raise ValueError(f"pass tables disagree: first_block {fb.shape}, meta {meta.shape}")
        if fb[0] != 0 or fb[-1] != nb or np.any(np.diff(fb) <= 0):
            raise ValueError("first_block must rise from 0 to num_blocks, a block or more a sub-shard")
        src_off, isize, slots, out_off = meta.T
        if np.any(src_off < 0) or np.any(isize < 0) or np.any(src_off + isize >= 2**31):
            raise ValueError("source intervals must lie in [0, 2**31)")
        if np.any(slots < 0):
            raise ValueError("hub slot counts must be >= 0")
        if not np.array_equal(out_off, np.cumsum(slots) - slots):
            raise ValueError("hub vectors must be laid out back to back in sub-shard order")
        if slots.sum() >= 2**31:
            raise ValueError("a pass of 2**31 hub slots or more exceeds int32 indexing")
        flags = torch.stack([
            _decreases(self.hub_inv, fb * E_BLK), _decreases(self.block_base, fb)
        ]).to(torch.int32)
        host_flags = flags.cpu().numpy()
        gen = np.flatnonzero(host_flags[0])
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
        derived = {
            "flags": host_flags,
            "num_gen": int(gen.size),
            "gen_slots": int(slots[gen].sum()),
            "num_slots_total": int(slots.sum()),
            "src_extent": int((src_off + isize).max()),
            "out_offsets": np.concatenate([out_off, [slots.sum()]]),
            "tables": {
                "first_block": as_dev(fb), "meta": as_dev(meta), "flags": flags.contiguous(),
                "gen_ss": as_dev(gen), "gen_start": as_dev(np.concatenate([[0], np.cumsum(slots[gen])])),
            },
        }
        for name, value in derived.items():
            object.__setattr__(self, name, value)


def _validate_pass(src_vals: torch.Tensor, sp: SubshardPass) -> None:
    if not isinstance(sp, SubshardPass):
        raise TypeError(f"expected a SubshardPass, got {type(sp).__name__}")
    if src_vals.dtype != sp.weights.dtype:
        raise TypeError(f"src_vals has dtype {src_vals.dtype}, the staged weights {sp.weights.dtype}")
    if src_vals.ndim != 1 or src_vals.shape[0] < sp.src_extent:
        raise ValueError(
            f"src_vals must be 1-D and hold every source interval ({sp.src_extent} values), "
            f"got shape {tuple(src_vals.shape)}"
        )
    if src_vals.device != sp.weights.device:
        raise ValueError(f"src_vals is on {src_vals.device}, the staging on {sp.weights.device}")


def subshard_update_pass_ref(
    src_vals: torch.Tensor, sp: SubshardPass
) -> tuple[torch.Tensor, np.ndarray]:
    """Plain version of the pass: :func:`subshard_update_ref` per sub-shard, concatenated."""
    fb = sp.first_block
    hubs = []
    for k, (src_off, isize, num_slots, _) in enumerate(np.asarray(sp.meta).tolist()):
        lo, hi = int(fb[k]), int(fb[k + 1])
        edges = slice(lo * E_BLK, hi * E_BLK)
        hubs.append(subshard_update_ref(
            src_vals[src_off:src_off + isize], sp.src_idx[edges], sp.hub_inv[edges],
            sp.weights[edges], sp.block_base[lo:hi], num_slots,
            gather_op=sp.gather_op, reduce=sp.reduce,
        ))
    return torch.cat(hubs), sp.out_offsets


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------
_ARGTYPES = {
    "dsss_spmv_launch": (
        [ctypes.c_int] * 8  # dtype, gather_op, reduce, num_ss, num_blocks,
        # partials_only, num_gen, gen_slots
        + [ctypes.c_void_p] * 14  # first_block, meta, flags, gen_ss, gen_start,
        # src_vals, src_idx, hub_inv, w, block_base, partials, head, tail, out
        + [ctypes.c_void_p]  # stream
    ),
    "dsss_spmv_stage_one": (
        [ctypes.c_int] * 3  # num_blocks, isize, num_slots
        + [ctypes.c_void_p] * 4  # hub_inv, block_base, table, stream
    ),
}
_TABLE_BYTES = 64  # a single sub-shard's table: 11 ints (kOneTable), 16-byte padded


def _library(name: str = "dsss_spmv_launch"):
    from repro_torch.kernels import _build

    fn = getattr(_build.load("dsss_spmv"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _check_edges(**edges: torch.Tensor) -> None:
    """The kernel loads 16 edges a lane, 16 bytes a load."""
    for name, t in edges.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned for the kernel's vector loads")


def _call(src_vals, gather_op, reduce, *ints_and_ptrs) -> None:
    global launches
    err = _library()(
        _DTYPES[src_vals.dtype], _GATHER_OPS[gather_op], _REDUCES[reduce], *ints_and_ptrs,
        torch.cuda.current_stream(src_vals.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dsss_spmv kernel launch failed: CUDA error {err}")
    launches += 1


def _launch(src_vals, src_idx, hub_inv, weights, block_base, num_slots, gather_op, reduce):
    """One sub-shard on the card, as a pass of one: phase 1 alone when ``num_slots`` is None."""
    dev, dtype = src_vals.device, src_vals.dtype
    nb = block_base.shape[0]
    _check_edges(src_idx=src_idx, hub_inv=hub_inv, weights=weights)
    for name, t in (("src_vals", src_vals), ("block_base", block_base)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src_vals.shape[0] >= 2**31 or src_idx.shape[0] >= 2**31 or (num_slots or 0) >= 2**31:
        raise ValueError("dsss_spmv indexes with int32: isize, edges and num_slots must be < 2**31")
    partials_only = num_slots is None
    num_slots = 0 if partials_only else num_slots
    # One scratch allocation: the sub-shard's table (stage_one writes it and
    # classify its flags, on the card), then the head and tail partials,
    # then the window partials: the output of phase 1 alone, and the general
    # path's scratch when the slots turn out to decrease.
    size = src_vals.element_size()
    ends_bytes = -(-2 * nb * size // 16) * 16
    parts = _TABLE_BYTES + ends_bytes
    scratch = torch.empty((parts + nb * E_BLK * size,), dtype=torch.uint8, device=dev)
    table = scratch.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library("dsss_spmv_stage_one")(
        nb, src_vals.shape[0], num_slots, hub_inv.data_ptr(), block_base.data_ptr(), table, stream
    )
    if err != 0:
        raise RuntimeError(f"dsss_spmv staging failed: CUDA error {err}")
    out = None if partials_only else torch.empty((num_slots,), dtype=dtype, device=dev)
    _call(src_vals, gather_op, reduce, 1, nb, int(partials_only), 1, num_slots,
          table, table + 8, table + 24, table + 32, table + 36, src_vals.data_ptr(),
          src_idx.data_ptr(), hub_inv.data_ptr(), weights.data_ptr(), block_base.data_ptr(),
          table + parts, table + _TABLE_BYTES, table + _TABLE_BYTES + nb * size, _ptr(out))
    if partials_only:
        return scratch[parts:].view(dtype).view(nb, E_BLK)
    return out


def _launch_pass(src_vals, sp: SubshardPass) -> torch.Tensor:
    dev, dtype = src_vals.device, src_vals.dtype
    nb = sp.block_base.shape[0]
    _check_edges(src_idx=sp.src_idx, hub_inv=sp.hub_inv, weights=sp.weights)
    if not src_vals.is_contiguous():
        raise ValueError("src_vals must be contiguous")
    out = torch.empty((sp.num_slots_total,), dtype=dtype, device=dev)
    ends = torch.empty((2, nb), dtype=dtype, device=dev)  # head and tail partials
    partials = torch.empty((nb, E_BLK), dtype=dtype, device=dev) if sp.num_gen else None
    t = sp.tables
    _call(src_vals, sp.gather_op, sp.reduce, t["meta"].shape[0], nb, 0, sp.num_gen, sp.gen_slots,
          t["first_block"].data_ptr(), t["meta"].data_ptr(), t["flags"].data_ptr(), _ptr(t["gen_ss"]),
          t["gen_start"].data_ptr(), src_vals.data_ptr(), sp.src_idx.data_ptr(),
          sp.hub_inv.data_ptr(), sp.weights.data_ptr(), sp.block_base.data_ptr(),
          _ptr(partials), ends[0].data_ptr(), ends[1].data_ptr(), _ptr(out))
    return out


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


def subshard_update_pass(
    src_vals: torch.Tensor, sp: SubshardPass
) -> tuple[torch.Tensor, np.ndarray]:
    """Every staged sub-shard's ToHub update: ``(hubs, offsets)``.

    ``src_vals`` holds every source interval (sub-shard k reads
    ``src_vals[src_off:src_off + isize]``); ``hubs[offsets[k]:offsets[k + 1]]``
    is sub-shard k's hub vector, bitwise what :func:`subshard_update` gives.
    """
    _validate_pass(src_vals, sp)
    if _route(src_vals):
        return _launch_pass(src_vals, sp), sp.out_offsets
    return subshard_update_pass_ref(src_vals, sp)
