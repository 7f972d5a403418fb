"""The fused tile sweep: CUDA kernel wrapper, its plain PyTorch version, staging.

One update sweep's gather-reduce over the :class:`repro_torch.core.dsss.
PackedSweep` layout. For each query ``k`` and each (selected) tile:

1. gather ``attrs[k, src]`` and the aux leaves by ``src`` (and ``dst``);
2. apply the program's gather, with the edge weights if present;
3. mask edges whose source interval is inactive to ``reduce_identity``;
4. reduce each run (one ``run_local`` slot) in ascending edge order,
   starting from ``segment_fill_value``;
5. fold the run partials into ``acc[k, run_dst]`` in ascending run order
   (ascending source interval, the schedules' fold order).

:func:`packed_sweep_update` is the entry point. On a CPU tensor it runs
:func:`packed_sweep_update_ref`, the plain version; on a CUDA tensor it
launches the hand-written kernel of ``csrc/packed_sweep.cu`` or raises.
Both give the same bits: float sums are left folds in a pinned order, with
no atomics, so a run repeated gives the same bits too.

The kernel needs a run index that :func:`prepare_packed_tiles` builds once
per layout on the host: each run's edge span, its tile and destination,
a destination → runs CSR in ascending run order, the kernel's chunk table
(run-aligned work items of one tile and one source interval, long runs
first), and, on a ``src_sorted`` layout whose runs are not contiguous, an
edge permutation that makes them so.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.core.identities import reduce_identity, segment_fill_value
from repro_torch.core.vertex_programs import (
    BFS,
    SSSP,
    WCC,
    MaxLabelForward,
    PageRank,
    ReachBackward,
)

__all__ = [
    "packed_sweep_update",
    "packed_sweep_update_select",
    "packed_sweep_update_ref",
    "packed_sweep_range_ref",
    "prepare_packed_tiles",
    "run_index",
    "tile_ranges",
    "range_from_leaves",
    "write_range",
    "range_views",
    "RangeSweep",
    "TileRange",
    "launches",
    "pre_gathers",
    "LONG_RUN",
]

# Kernel launches on CUDA tensors: one per entry call that reaches the card,
# whole-layout (packed_sweep_update) or one tile range (RangeSweep.update).
# Callers reset it to 0 and read it around a run.
launches = 0
# The per-sweep pre_gather entry of the range path (RangeSweep on the card),
# counted apart from the launches above.
pre_gathers = 0
# The counts are bumped under this lock: a graph server launches from
# several executor threads.
_count_lock = threading.Lock()

# A warp stages this many edge positions at a time (kCap in the kernel).
# Runs longer than that are folded window by window by a warp of their own
# (a long chunk); shorter ones are packed into run-aligned chunks of at most
# LONG_RUN positions, one warp each.
LONG_RUN = 512

# Leaves of the tile layout itself, in PackedSweep order.
TILE_LEAVES = ("src", "dst", "run_local", "run_dst", "e_valid")

# The kernel's program table: id in csrc/packed_sweep.cu, dtype, and the
# aux leaves its gather reads (aux0, aux1). Exact types only: a subclass
# may change gather.
_KERNEL_PROGRAMS = {
    PageRank: (0, torch.float32, ("inv_out_degree",)),
    BFS: (1, torch.int32, ()),
    WCC: (2, torch.int32, ()),
    SSSP: (3, torch.float32, ()),
    MaxLabelForward: (4, torch.int32, ("mask",)),
    ReachBackward: (5, torch.int32, ("mask", "color")),
}


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------
def run_index(packed) -> dict[str, np.ndarray]:
    """The kernel's run index for one layout (host numpy, int32 leaves).

    Run ``r`` is slot ``r - run_base[t]`` of tile ``t``, numbered in
    ascending (tile, slot) order. Returns each run's edge span
    ``[run_start, run_end)``, ``run_tile``, ``run_target`` (its
    destination), the destination → runs CSR ``dst_ptr``/``dst_runs``
    (ascending run order within a destination), and ``chunks``, the
    kernel's work list (:func:`chunk_table`).

    Where every run's edges are contiguous (destination-sorted layouts),
    a span is of flat positions ``t·T + e``. Where they are not (subshard
    tiles of a ``src_sorted`` graph), the index also holds ``perm``: the
    valid flat positions stably sorted by run, so run ``r``'s edges are
    ``perm[run_start[r]:run_end[r]]``, still in ascending edge order.

    A run is one hub slot, one (destination, sub-shard): raises if a run's
    edges read more than one source interval.
    """
    NT, T = packed.src.shape
    if NT * T >= 2**31:
        raise ValueError(f"tile layout of {NT}x{T} slots exceeds int32 offsets")
    u = packed.u.astype(np.int64)
    run_base = np.concatenate([[0], np.cumsum(u)])
    R = int(run_base[-1])
    valid = np.arange(T)[None, :] < packed.e_valid[:, None]
    flat = np.flatnonzero(valid)
    gid = (run_base[:-1, None] + packed.run_local)[valid]
    perm = None
    if gid.size and np.any(np.diff(gid) < 0):
        order = np.argsort(gid, kind="stable")
        gid, perm = gid[order], flat[order]
    starts = np.flatnonzero(np.concatenate([[True], gid[1:] != gid[:-1]]))
    if not np.array_equal(gid[starts], np.arange(R)):
        raise ValueError("tile layout has run slots below u with no edges")
    ends = np.concatenate([starts[1:], [gid.size]])
    edges = flat if perm is None else perm  # the edges in run order
    iv_edge = packed.src.reshape(-1)[edges] // packed.interval_size
    run_iv = iv_edge[starts]
    if np.any(iv_edge != run_iv[gid]):
        r = int(gid[np.flatnonzero(iv_edge != run_iv[gid])[0]])
        raise ValueError(f"run {r} reads more than one source interval")
    if perm is None:
        run_start = flat[starts]
        run_end = flat[ends - 1] + 1
    else:
        run_start, run_end = starts, ends
    run_tile = np.repeat(np.arange(NT), u)
    slot = np.arange(R) - run_base[:-1][run_tile]
    run_target = packed.run_dst[run_tile, slot].astype(np.int64)
    dst_runs = np.argsort(run_target, kind="stable")
    dst_ptr = np.searchsorted(
        run_target[dst_runs], np.arange(packed.n_pad + 1), side="left"
    )
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    index = {
        "run_start": as32(run_start),
        "run_end": as32(run_end),
        "run_tile": as32(run_tile),
        "run_target": as32(run_target),
        "dst_ptr": as32(dst_ptr),
        "dst_runs": as32(dst_runs),
        "chunks": chunk_table(run_start, run_end, run_tile, run_iv),
    }
    if perm is not None:
        index["perm"] = as32(perm)
    return index


def chunk_table(run_start, run_end, run_tile, run_iv) -> np.ndarray:
    """The kernel's chunks, one warp each: ``(NC, 8)`` int32 rows
    ``run0, run1, pos0, pos1, interval, tile, 0, 0``.

    A chunk is the runs ``[run0, run1)`` over the positions ``[pos0,
    pos1)`` (contiguous: each run starts where the one before it ends), all
    of one tile and one source interval, so activity and the tile
    selection are one check per chunk. A run longer than :data:`LONG_RUN`
    is a chunk of its own (a long chunk). The other runs of a (tile,
    interval) stretch between long runs are packed greedily, in run order,
    into short chunks of at most ``LONG_RUN`` positions: a chunk takes runs
    while they fit, so the walk is one step per chunk. Long chunks come
    first, longest first, then the short chunks in run order.
    """
    R = run_start.shape[0]
    if R == 0:
        return np.zeros((0, 8), np.int32)
    lens = (run_end - run_start).astype(np.int64)
    is_long = lens > LONG_RUN
    new_seg = np.ones(R, bool)
    new_seg[1:] = (
        (run_tile[1:] != run_tile[:-1]) | (run_iv[1:] != run_iv[:-1])
        | is_long[1:] | is_long[:-1]
    )
    if np.any(~new_seg[1:] & (run_start[1:] != run_end[:-1])):
        raise ValueError("runs of one tile are not contiguous")
    seg_starts = np.flatnonzero(new_seg)
    seg_end = np.concatenate([seg_starts[1:], [R]])[np.cumsum(new_seg) - 1]
    cum = np.concatenate([[0], np.cumsum(lens)])  # edges before each run
    # The first run that no longer fits in a chunk starting at run r.
    nxt = np.searchsorted(cum, cum[:-1] + LONG_RUN, side="right") - 1
    nxt = np.maximum(np.minimum(nxt, seg_end), np.arange(R) + 1)
    starts = []
    r = 0
    while r < R:
        starts.append(r)
        r = int(nxt[r])
    run0 = np.asarray(starts, np.int64)
    run1 = np.concatenate([run0[1:], [R]])
    longs = is_long[run0]
    order = np.concatenate([
        np.flatnonzero(longs)[np.argsort(-lens[run0[longs]], kind="stable")],
        np.flatnonzero(~longs),
    ])
    zero = np.zeros_like(run0)
    table = np.stack(
        [run0, run1, run_start[run0], run_end[run1 - 1], run_iv[run0], run_tile[run0], zero, zero],
        axis=1,
    )[order]
    return np.ascontiguousarray(table, dtype=np.int32)


def _writable(a: np.ndarray) -> np.ndarray:
    """``a`` contiguous, copied where it is read-only (a ``.dsss`` file's mmap view)."""
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def prepare_packed_tiles(packed, *, has_weights: bool, device, index: dict | None = None) -> dict:
    """Upload the tile leaves and the run index.

    The one upload of the layout: ``src``/``dst``/``run_local``/``run_dst``
    ``(NT, T)``, ``e_valid`` ``(NT,)``, ``weights`` when present, plus the
    leaves of :func:`run_index` (with ``perm`` on a ``src_sorted`` layout),
    and ``interval_size``, a Python int the kernel checks ``row_active``
    against. ``index`` is the layout's :func:`run_index` where the caller
    holds it already.
    """
    leaves = {k: getattr(packed, k) for k in TILE_LEAVES}
    if has_weights:
        leaves["weights"] = packed.weights
    leaves.update(run_index(packed) if index is None else index)
    tiles = {k: torch.from_numpy(_writable(v)).to(device) for k, v in leaves.items()}
    tiles["interval_size"] = packed.interval_size
    return tiles


# Sections of a tile range's payload, in buffer order. The chunk table comes
# first: the kernel reads its rows as int4 pairs, so it must start on the
# buffer's 16-byte aligned base. All sections are int32 but weights (float32).
RANGE_SECTIONS = (
    "chunks", "run_start", "fold_ptr", "fold_dst", "fold_runs", "perm", "run_tile",
    "src", "dst", "weights",
)
# The sections in the order packed_sweep_range_launch takes their pointers.
_RANGE_POINTERS = (
    "src", "dst", "weights", "run_start", "run_tile", "chunks", "perm",
    "fold_ptr", "fold_dst", "fold_runs",
)


@dataclasses.dataclass(frozen=True)
class TileRange:
    """Tiles ``[lo, hi)`` of a layout as one self-contained operand of kernel B1.

    The range's payload is one byte buffer (:func:`write_range`) holding,
    at ``sections[name] = (byte offset, elements)``:

    * ``chunks``: the layout's chunk-table rows of these tiles, in table
      order (long chunks first), with runs, positions and tiles rebased to
      the range;
    * ``run_start``: each run's first position, range-local;
    * ``fold_ptr``/``fold_dst``/``fold_runs``: the fold list, each
      destination the range touches (ascending) with its runs in ascending
      order, as a CSR over range-local run ids;
    * ``perm`` (``src_sorted`` layouts): the range's edge permutation,
      range-local flat slots;
    * ``run_tile`` (only when asked for, for a tile selection): each run's
      range-local tile;
    * ``src``, ``dst`` and, on weighted layouts, ``weights``: the tiles'
      padded slots.

    Runs never cross tiles, so any tile range is a valid cut, and folding
    the ranges of a layout in ascending order is the whole sweep's fold.
    """

    lo: int
    hi: int
    tile_edges: int
    interval_size: int
    runs: int
    chunk_rows: int
    touched: int
    sections: dict
    nbytes: int

    @property
    def num_tiles(self) -> int:
        return self.hi - self.lo

    @functools.cached_property
    def offsets(self) -> tuple:
        """Byte offsets of the sections the range entry takes, in its order (None: absent)."""
        return tuple(self.sections[n][0] if n in self.sections else None for n in _RANGE_POINTERS)


def tile_ranges(packed, bounds, *, index=None, run_tile: bool = False) -> list:
    """Build the kernel operands of disjoint ascending tile ranges of a layout.

    ``bounds`` lists ``(lo, hi)`` tile ranges; ``index`` is the layout's
    :func:`run_index` (computed if ``None``). Returns one
    ``(TileRange, arrays)`` pair per range, ``arrays`` the numpy sections
    that :func:`write_range` lays out. Vectorized over the ranges: one
    sort groups every range's runs by destination.
    """
    if index is None:
        index = run_index(packed)
    NT, T = packed.src.shape
    bounds = [(int(lo), int(hi)) for lo, hi in bounds]
    prev = 0
    for lo, hi in bounds:
        if not prev <= lo < hi <= NT:
            raise ValueError(f"tile ranges must be disjoint, ascending and within {NT} tiles: {bounds}")
        prev = hi
    run_base = np.concatenate([[0], np.cumsum(packed.u.astype(np.int64))])
    run_start = index["run_start"].astype(np.int64)
    run_end = index["run_end"].astype(np.int64)
    tile_of_run = index["run_tile"].astype(np.int64)
    target = index["run_target"].astype(np.int64)
    chunks = index["chunks"]
    perm = index.get("perm")
    rid_of_tile = np.full(NT, -1, np.int64)
    for k, (lo, hi) in enumerate(bounds):
        rid_of_tile[lo:hi] = k
    nb = np.arange(len(bounds) + 1)
    # Runs by range, destination, run id (lexsort is stable; runs ascend).
    rid = rid_of_tile[tile_of_run]
    kept = np.flatnonzero(rid >= 0)
    order = kept[np.lexsort((target[kept], rid[kept]))]
    o_rid, o_tgt = rid[order], target[order]
    new_group = np.ones(order.shape[0], bool)
    new_group[1:] = (o_rid[1:] != o_rid[:-1]) | (o_tgt[1:] != o_tgt[:-1])
    group_at = np.flatnonzero(new_group)
    run_pos = np.searchsorted(o_rid, nb)
    group_pos = np.searchsorted(o_rid[group_at], nb)
    # Chunk rows by range, table order kept within a range.
    c_rid = rid_of_tile[chunks[:, 5]]
    c_kept = np.flatnonzero(c_rid >= 0)
    c_order = c_kept[np.argsort(c_rid[c_kept], kind="stable")]
    chunk_pos = np.searchsorted(c_rid[c_order], nb)
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    out = []
    for k, (lo, hi) in enumerate(bounds):
        r0, r1 = int(run_base[lo]), int(run_base[hi])
        if perm is None:
            pos0, pos1 = lo * T, hi * T
        else:
            pos0 = int(run_start[r0]) if r1 > r0 else 0
            pos1 = int(run_end[r1 - 1]) if r1 > r0 else 0
        rows = chunks[c_order[chunk_pos[k]:chunk_pos[k + 1]]].astype(np.int64)
        rows[:, 0:2] -= r0
        rows[:, 2:4] -= pos0
        rows[:, 5] -= lo
        p0, p1 = int(run_pos[k]), int(run_pos[k + 1])
        groups = group_at[group_pos[k]:group_pos[k + 1]]
        arrays = {
            "chunks": as32(rows),
            "run_start": as32(run_start[r0:r1] - pos0),
            "fold_ptr": as32(np.append(groups - p0, p1 - p0)),
            "fold_dst": as32(o_tgt[groups]),
            "fold_runs": as32(order[p0:p1] - r0),
        }
        if perm is not None:
            arrays["perm"] = as32(perm[pos0:pos1].astype(np.int64) - lo * T)
        if run_tile:
            arrays["run_tile"] = as32(tile_of_run[r0:r1] - lo)
        arrays["src"] = packed.src[lo:hi]
        arrays["dst"] = packed.dst[lo:hi]
        if packed.weights is not None:
            arrays["weights"] = packed.weights[lo:hi]
        sections, offset = {}, 0
        for name in RANGE_SECTIONS:
            if name in arrays:
                sections[name] = (offset, int(arrays[name].size))
                offset += arrays[name].nbytes
        rng = TileRange(
            lo=lo, hi=hi, tile_edges=T, interval_size=packed.interval_size,
            runs=r1 - r0, chunk_rows=int(rows.shape[0]), touched=int(groups.shape[0]),
            sections=sections, nbytes=offset,
        )
        out.append((rng, arrays))
    return out


def range_from_leaves(
    leaves: dict, lo: int, *, interval_size: int, permuted: bool, run_tile: bool = False
) -> tuple:
    """Build kernel B1's operands of one tile range from that range's own leaves.

    ``leaves`` holds the tiles' ``src``, ``dst``, ``run_local``, ``run_dst``
    ``(k, T)`` and ``e_valid`` ``(k,)`` (and ``weights``), e.g. slices of a
    ``.dsss`` file's mmap views; ``lo`` is the range's first tile in the
    layout. Nothing of the rest of the layout is read: a tile's runs are its
    ``run_local`` slots, and runs never cross tiles. ``permuted`` says
    whether the layout's :func:`run_index` carries ``perm`` (its runs are
    not contiguous somewhere); the range then ships its edge permutation.
    Returns ``(TileRange, arrays)``, array for array what
    :func:`tile_ranges` gives for ``[(lo, lo + k)]``.
    """
    src = leaves["src"]
    k, T = src.shape
    ev = np.asarray(leaves["e_valid"], dtype=np.int64)
    E = int(ev.sum())

    def valid(name, counts):  # the leaf's first counts[t] slots of each tile, back to back
        return np.concatenate([np.asarray(leaves[name][t, : counts[t]]) for t in range(k)])

    tile_start = np.concatenate([[0], np.cumsum(ev)])
    rl = valid("run_local", ev).astype(np.int64)
    u = np.zeros(k, np.int64)
    if E:
        nz = ev > 0
        u[nz] = np.maximum.reduceat(rl, tile_start[:-1][nz]) + 1
    run_base = np.concatenate([[0], np.cumsum(u)])
    R = int(run_base[-1])
    gid = rl + np.repeat(run_base[:-1], ev)
    flat = np.arange(E) + np.repeat(np.arange(k) * T - tile_start[:-1], ev)
    s_valid = valid("src", ev)
    perm = None
    if permuted:
        order = np.argsort(gid, kind="stable")
        gid, perm, s_valid = gid[order], flat[order], s_valid[order]
    elif E and np.any(gid[1:] < gid[:-1]):
        raise ValueError("the range's runs are not contiguous, but the layout has no perm")
    starts = np.flatnonzero(np.concatenate([[True], gid[1:] != gid[:-1]])) if E else gid
    if not np.array_equal(gid[starts], np.arange(R)):
        raise ValueError("tile layout has run slots below u with no edges")
    ends = np.concatenate([starts[1:], [E]])
    iv_edge = s_valid // interval_size
    run_iv = iv_edge[starts]
    if np.any(iv_edge != np.repeat(run_iv, ends - starts)):
        r = int(gid[np.flatnonzero(iv_edge != np.repeat(run_iv, ends - starts))[0]])
        raise ValueError(f"run {r} of the range reads more than one source interval")
    if perm is None:
        run_start, run_end = flat[starts], flat[ends - 1] + 1
    else:
        run_start, run_end = starts, ends
    tile_of_run = np.repeat(np.arange(k), u)
    target = valid("run_dst", u)
    order = np.argsort(target, kind="stable")
    o_tgt = target[order]
    groups = np.flatnonzero(np.concatenate([[True], o_tgt[1:] != o_tgt[:-1]])) if R else order
    rows = chunk_table(run_start, run_end, tile_of_run, run_iv)
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    arrays = {
        "chunks": rows,
        "run_start": as32(run_start),
        "fold_ptr": as32(np.append(groups, R)),
        "fold_dst": as32(o_tgt[groups]),
        "fold_runs": as32(order),
    }
    if perm is not None:
        arrays["perm"] = as32(perm)
    if run_tile:
        arrays["run_tile"] = as32(tile_of_run)
    arrays["src"] = src
    arrays["dst"] = leaves["dst"]
    if leaves.get("weights") is not None:
        arrays["weights"] = leaves["weights"]
    sections, offset = {}, 0
    for name in RANGE_SECTIONS:
        if name in arrays:
            sections[name] = (offset, int(arrays[name].size))
            offset += arrays[name].nbytes
    rng = TileRange(
        lo=int(lo), hi=int(lo) + k, tile_edges=T, interval_size=interval_size, runs=R,
        chunk_rows=int(rows.shape[0]), touched=int(groups.shape[0]), sections=sections,
        nbytes=offset,
    )
    return rng, arrays


def write_range(buf: np.ndarray, rng: TileRange, arrays: dict) -> None:
    """Lay a range's sections into ``buf``, a uint8 array of ``rng.nbytes`` or more."""
    for name, (offset, _) in rng.sections.items():
        a = np.ascontiguousarray(arrays[name]).reshape(-1)
        buf[offset:offset + a.nbytes] = a.view(np.uint8)


def range_views(buf: torch.Tensor, rng: TileRange) -> dict:
    """The sections of a range's payload in ``buf`` (uint8) as typed 1-D views."""
    views = {}
    for name, (offset, numel) in rng.sections.items():
        dtype = torch.float32 if name == "weights" else torch.int32
        views[name] = buf[offset:offset + 4 * numel].view(dtype)
    return views


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------
def _edge_aux(aux: dict, aux_batched: bool, idx: torch.Tensor) -> dict:
    """Aux leaves seen per edge: vertex leaves gathered by ``idx``.

    Shared vertex leaves ``(n_pad,)`` become ``(E,)``; batched ``(K, n_pad)``
    become ``(K, E)``; scalars stay 0-d, or ``(K, 1)`` when batched.
    """
    out = {}
    for name, v in aux.items():
        if v.ndim == (2 if aux_batched else 1):
            out[name] = v[..., idx]
        elif aux_batched:
            out[name] = v.reshape(-1, 1)
        else:
            out[name] = v
    return out


def _contribs(program, attrs_flat, aux, aux_batched, row_active, e_src, e_dst, e_w, dtype):
    """(K, E) gather contributions of the edges, in ``dtype``; edges of
    inactive source intervals are the ⊕-identity."""
    K, n_pad = attrs_flat.shape
    dev = attrs_flat.device
    vert_active = row_active.to(dev).repeat_interleave(n_pad // row_active.shape[0])
    contrib = program.gather(
        attrs_flat[:, e_src],
        e_w,
        _edge_aux(aux, aux_batched, e_src),
        _edge_aux(aux, aux_batched, e_dst) if program.needs_dst_aux else None,
    ).to(dtype)
    ident = reduce_identity(program.reduce, contrib.dtype).to(dev)
    return torch.where(vert_active[e_src], contrib.expand(K, -1), ident)


def _run_sums(contrib, run_of_edge, counts, fill) -> torch.Tensor:
    """(K, R) float sums of each run's edges: a left fold from ``fill`` in edge order.

    Edges are grouped by run (a stable sort keeps their order), and runs
    are visited longest first, so the runs still open at position j are a
    prefix of ``c_j`` runs: one vectorized add per position. The edges are
    laid out position by position first (position j's ``c_j`` edges
    together), so a step is one add of a split piece into a cached view,
    with no host sync.
    """
    K, R = contrib.shape[0], counts.shape[0]
    partial_by_len = fill.expand(K, R).clone()
    if R == 0:
        return partial_by_len
    dev = contrib.device
    order = torch.sort(run_of_edge, stable=True).indices
    grouped = contrib[:, order]
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.sort(counts, descending=True, stable=True).indices
    lens = counts[by_len]
    open_at = torch.bincount(counts, minlength=1).flip(0).cumsum(0).flip(0)
    c = open_at[1:]  # c[j]: runs with more than j edges
    off = torch.cumsum(c, 0) - c
    rank = torch.repeat_interleave(torch.arange(R, device=dev), lens)
    pos = torch.arange(rank.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    by_pos = torch.empty_like(grouped)
    by_pos[:, off[pos] + rank] = grouped[:, starts[by_len][rank] + pos]
    sizes = c.tolist()
    heads = {}  # partial_by_len[:, :n], one view per distinct n
    for n, step in zip(sizes, by_pos.split(sizes, dim=1)):
        head = heads.get(n)
        if head is None:
            head = heads[n] = partial_by_len[:, :n]
        head += step
    partial = torch.empty_like(partial_by_len)
    partial[:, by_len] = partial_by_len
    return partial


def packed_sweep_update_ref(
    program,
    attrs_flat: torch.Tensor,  # (K, n_pad) previous attributes
    acc_flat: torch.Tensor,  # (K, n_pad) running ⊕ accumulators
    aux: dict,  # run-constant aux; (K,)-leading leaves when aux_batched
    tiles: dict,  # tile leaves, (NT, ...) leading axis
    row_active: torch.Tensor,  # (P,) bool
    has_weights: bool,
    aux_batched: bool = False,
    idx: torch.Tensor | None = None,  # ascending selected tile indices
    a_valid: int | None = None,  # real entries of idx (default: all)
) -> torch.Tensor:
    """Plain PyTorch version of the tile sweep; returns the new accumulator.

    Independent of the kernel's run index: runs are regrouped from the
    tile leaves on every call. Sums are ordered loops — the position
    inside runs, vectorised across runs (:func:`_run_sums`), then the run
    rank inside a destination, vectorised across destinations — never
    ``index_add_`` or ``cumsum``, whose order or precision differ.
    min/max use ``scatter_reduce_``, which is exact in any order.
    """
    K = attrs_flat.shape[0]
    dev = attrs_flat.device
    NT, T = tiles["src"].shape
    if idx is None:
        sel = torch.arange(NT, device=dev)
    else:
        n_sel = idx.shape[0] if a_valid is None else int(a_valid)
        sel = idx[:n_sel].to(device=dev, dtype=torch.long)
    S = sel.shape[0]
    valid = torch.arange(T, device=dev)[None, :] < tiles["e_valid"][sel][:, None]
    slot_id = torch.arange(S, device=dev)[:, None] * T + tiles["run_local"][sel]
    gid = slot_id[valid]  # (E,) run slot of each edge, ascending (tile, edge)
    e_src = tiles["src"][sel][valid].long()
    e_dst = tiles["dst"][sel][valid].long()
    e_w = tiles["weights"][sel][valid] if has_weights else None
    contrib = _contribs(program, attrs_flat, aux, aux_batched, row_active, e_src, e_dst, e_w, acc_flat.dtype)
    fill = segment_fill_value(program.reduce, contrib.dtype).to(dev)

    runs, run_of_edge, counts = torch.unique(
        gid, sorted=True, return_inverse=True, return_counts=True
    )
    R = runs.shape[0]
    run_dst = tiles["run_dst"][sel].reshape(-1)[runs].long()
    out = acc_flat.clone()
    if program.reduce != "sum":
        how = "amin" if program.reduce == "min" else "amax"
        partial = fill.expand(K, R).clone()
        partial.scatter_reduce_(1, run_of_edge.expand(K, -1), contrib, how)
        out.scatter_reduce_(1, run_dst.expand(K, -1), partial, how)
        return out

    # Phase 1: each run's left fold in ascending edge order.
    partial = _run_sums(contrib, run_of_edge, counts, fill)

    # Phase 2: fold each destination's runs in ascending run order.
    d_order = torch.sort(run_dst, stable=True).indices
    dests, d_counts = torch.unique_consecutive(run_dst[d_order], return_counts=True)
    d_starts = torch.cumsum(d_counts, 0) - d_counts
    for j in range(int(d_counts.max()) if R else 0):
        has = d_counts > j
        d = dests[has]
        out[:, d] = out[:, d] + partial[:, d_order[d_starts[has] + j]]
    return out


def packed_sweep_range_ref(
    program,
    attrs_flat: torch.Tensor,  # (K, n_pad) previous attributes
    acc_flat: torch.Tensor,  # (K, n_pad) running ⊕ accumulators, folded in place
    aux: dict,
    ops: dict,  # the range's sections (range_views)
    rng: TileRange,
    row_active: torch.Tensor,  # (P,) bool
    has_weights: bool,
    aux_batched: bool = False,
    tile_sel: torch.Tensor | None = None,  # (num_tiles,) range-local selection
) -> torch.Tensor:
    """Plain PyTorch version of one range launch; folds into ``acc_flat`` in place.

    Works from what the range ships, as the kernel does: a run's edges are
    the positions from its start to the next run's start, or to its
    chunk's end for the last run of a chunk (through ``perm`` where
    present); each run folds its edges in order from
    ``segment_fill_value`` (edges of inactive source intervals are the
    ⊕-identity), then each touched destination folds its runs in
    fold-list order into ``acc_flat``. Runs of tiles that ``tile_sel``
    leaves out are not folded. Returns ``acc_flat``.
    """
    K = attrs_flat.shape[0]
    dev = attrs_flat.device
    R = rng.runs
    if R == 0:
        return acc_flat
    chunks = ops["chunks"].reshape(-1, 8).long()
    run_start = ops["run_start"].long()
    run_end = torch.empty_like(run_start)
    run_end[:-1] = run_start[1:]
    run_end[chunks[:, 1] - 1] = chunks[:, 3]
    counts = run_end - run_start
    run_of_edge = torch.repeat_interleave(torch.arange(R, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = run_start[run_of_edge] + torch.arange(run_of_edge.shape[0], device=dev) - first[run_of_edge]
    e = ops["perm"].long()[pos] if "perm" in ops else pos
    e_src = ops["src"][e].long()
    e_dst = ops["dst"][e].long()
    e_w = ops["weights"][e] if has_weights else None
    contrib = _contribs(program, attrs_flat, aux, aux_batched, row_active, e_src, e_dst, e_w, acc_flat.dtype)
    fill = segment_fill_value(program.reduce, contrib.dtype).to(dev)
    fold_ptr = ops["fold_ptr"].long()
    fold_dst = ops["fold_dst"].long()
    fold_runs = ops["fold_runs"].long()
    d_counts = fold_ptr[1:] - fold_ptr[:-1]
    kept = None
    if tile_sel is not None:
        kept = tile_sel.to(dev).bool()[ops["run_tile"].long()]
    if program.reduce != "sum":
        how = "amin" if program.reduce == "min" else "amax"
        partial = fill.expand(K, R).clone()
        partial.scatter_reduce_(1, run_of_edge.expand(K, -1), contrib, how)
        dest = torch.empty(R, dtype=torch.long, device=dev)
        dest[fold_runs] = torch.repeat_interleave(fold_dst, d_counts)
        if kept is not None:
            partial, dest = partial[:, kept], dest[kept]
        return acc_flat.scatter_reduce_(1, dest.expand(K, -1), partial, how)
    partial = _run_sums(contrib, run_of_edge, counts, fill)
    for j in range(int(d_counts.max())):
        has = d_counts > j
        d = fold_dst[has]
        r = fold_runs[fold_ptr[:-1][has] + j]
        cur = acc_flat[:, d]
        new = cur + partial[:, r]
        acc_flat[:, d] = new if kept is None else torch.where(kept[r], new, cur)
    return acc_flat


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------
_ARGTYPES = (
    [ctypes.c_int] * 5  # prog, K, n_pad, NC, isz
    + [ctypes.c_longlong]  # aux_stride
    + [ctypes.c_void_p] * 18  # tensors (see the C entry point)
    + [ctypes.c_void_p]  # stream
)


# The range path's two entries (see their C definitions).
_PRE_GATHER_ARGTYPES = (
    [ctypes.c_int] * 4  # prog, K, n_pad, isz
    + [ctypes.c_longlong]  # aux_stride
    + [ctypes.c_void_p] * 5  # attrs, y, row_active, aux0, aux1
    + [ctypes.c_void_p]  # stream
)
_RANGE_ARGTYPES = (
    [ctypes.c_int] * 6  # prog, K, n_pad, NC, ND, isz
    + [ctypes.c_longlong]  # aux_stride
    + [ctypes.c_void_p] * 17  # tensors (see the C entry point)
    + [ctypes.c_void_p]  # stream
)
_ENTRIES = {
    "packed_sweep_launch": _ARGTYPES,
    "packed_sweep_pre_gather": _PRE_GATHER_ARGTYPES,
    "packed_sweep_range_launch": _RANGE_ARGTYPES,
}


def _library(entry: str = "packed_sweep_launch"):
    from repro_torch.kernels import _build

    lib = _build.load("packed_sweep")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = _ENTRIES[entry]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _kernel_program(program) -> tuple:
    """(program id, dtype, aux leaf names) of a program the kernel knows."""
    spec = _KERNEL_PROGRAMS.get(type(program))
    if spec is None:
        raise NotImplementedError(
            f"the CUDA tile sweep has no gather for program {type(program).__name__}"
        )
    return spec


def _aux_pointers(aux, aux_names, aux_batched, K, n_pad, dev) -> list:
    """The gather's aux leaves, checked, as two pointers (None where unused)."""
    ptrs = []
    for name in aux_names:
        v = aux[name]
        want = (K, n_pad) if aux_batched else (n_pad,)
        _check(v, f"aux[{name!r}]", v.dtype, dev, want)
        if v.dtype != (torch.float32 if name == "inv_out_degree" else torch.int32):
            raise TypeError(f"aux[{name!r}] has unexpected dtype {v.dtype}")
        ptrs.append(v.data_ptr())
    return ptrs + [None] * (2 - len(ptrs))


def _launch(
    program, attrs_flat, acc_flat, aux, tiles, row_active, has_weights,
    aux_batched, idx, a_valid,
) -> torch.Tensor:
    global launches
    prog_id, dtype, aux_names = _kernel_program(program)
    if "run_start" not in tiles:
        raise ValueError(
            "tiles carry no run index: stage them with prepare_packed_tiles"
        )
    dev = attrs_flat.device
    K, n_pad = attrs_flat.shape
    NT, T = tiles["src"].shape
    P = row_active.shape[0]
    _check(attrs_flat, "attrs_flat", dtype, dev)
    _check(acc_flat, "acc_flat", dtype, dev, (K, n_pad))
    for name in ("src", "dst"):
        _check(tiles[name], name, torch.int32, dev, (NT, T))
    if has_weights:
        _check(tiles["weights"], "weights", torch.float32, dev, (NT, T))
    R = tiles["run_start"].shape[0]
    for name in ("run_start", "run_tile", "dst_runs"):
        _check(tiles[name], name, torch.int32, dev, (R,))
    _check(tiles["dst_ptr"], "dst_ptr", torch.int32, dev, (n_pad + 1,))
    chunks = tiles["chunks"]
    _check(chunks, "chunks", torch.int32, dev)
    if chunks.ndim != 2 or chunks.shape[1] != 8:
        raise ValueError(f"chunks has shape {tuple(chunks.shape)}, expected (NC, 8)")
    perm = tiles.get("perm")
    if perm is not None:
        _check(perm, "perm", torch.int32, dev)
    if n_pad % P or n_pad // P != tiles["interval_size"]:
        raise ValueError(
            f"row_active has {P} intervals; the tiles were staged for intervals "
            f"of {tiles['interval_size']} of n_pad={n_pad}"
        )
    aux_ptrs = _aux_pointers(aux, aux_names, aux_batched, K, n_pad, dev)
    tile_sel = None
    if idx is not None:
        n_sel = idx.shape[0] if a_valid is None else int(a_valid)
        tile_sel = torch.zeros(NT, dtype=torch.uint8, device=dev)
        tile_sel[idx[:n_sel].to(device=dev, dtype=torch.long)] = 1
    active = row_active.to(device=dev, dtype=torch.uint8).contiguous()
    y = torch.empty((n_pad, K), dtype=dtype, device=dev)
    partial = torch.empty((R, K), dtype=dtype, device=dev)
    out = torch.empty_like(acc_flat)
    fn = _library()
    err = fn(
        prog_id, K, n_pad, chunks.shape[0], n_pad // P, n_pad if aux_batched else 0,
        attrs_flat.data_ptr(), acc_flat.data_ptr(), out.data_ptr(), y.data_ptr(),
        partial.data_ptr(), tiles["src"].data_ptr(), tiles["dst"].data_ptr(),
        _ptr(tiles["weights"]) if has_weights else None,
        tiles["run_start"].data_ptr(), tiles["run_tile"].data_ptr(),
        tiles["dst_ptr"].data_ptr(), tiles["dst_runs"].data_ptr(), chunks.data_ptr(),
        _ptr(perm), _ptr(tile_sel), active.data_ptr(), aux_ptrs[0], aux_ptrs[1],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"packed_sweep kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


def packed_sweep_update(
    program,
    attrs_flat: torch.Tensor,
    acc_flat: torch.Tensor,
    aux: dict,
    tiles: dict,
    row_active: torch.Tensor,
    has_weights: bool,
    aux_batched: bool = False,
    idx: torch.Tensor | None = None,
    a_valid: int | None = None,
) -> torch.Tensor:
    """One gather-reduce pass over the (selected) tiles; returns the new acc.

    ``idx`` lists the tiles to sweep, ascending (the first ``a_valid``
    entries count); ``None`` sweeps them all. A CPU ``attrs_flat`` runs
    :func:`packed_sweep_update_ref`; a CUDA one launches the kernel.
    """
    if attrs_flat.device.type == "cpu":
        return packed_sweep_update_ref(
            program, attrs_flat, acc_flat, aux, tiles, row_active,
            has_weights, aux_batched, idx, a_valid,
        )
    if attrs_flat.device.type != "cuda":
        raise ValueError(f"no tile sweep for device {attrs_flat.device}")
    return _launch(
        program, attrs_flat, acc_flat, aux, tiles, row_active, has_weights,
        aux_batched, idx, a_valid,
    )



def packed_sweep_update_select(
    program,
    attrs_flat: torch.Tensor,
    acc_flat: torch.Tensor,
    aux: dict,
    tiles: dict,
    idx: torch.Tensor,
    a_valid: int,
    row_active: torch.Tensor,
    has_weights: bool,
    aux_batched: bool = False,
) -> torch.Tensor:
    """The selective front end under the JAX package's name and argument order.

    The tiles ``idx[:a_valid]`` (ascending) through :func:`packed_sweep_update`,
    which takes the selection itself: the kernel on a CUDA tensor, its plain
    version on a CPU one.
    """
    return packed_sweep_update(
        program, attrs_flat, acc_flat, aux, tiles, row_active, has_weights,
        aux_batched, idx, int(a_valid),
    )

class RangeSweep:
    """One sweep of kernel B1 over tile ranges: the host-residency path.

    Built once a sweep, before its ranges. On a CUDA ``attrs_flat`` it
    checks the sweep's operands, runs ``pre_gather`` once (the gather's
    per-vertex part ``y``, ``(n_pad, K)``, for every source of an active
    interval; counted in :data:`pre_gathers`) and allocates the run-partial
    scratch for ``max_runs`` runs. :meth:`update` then folds one range's
    runs into ``acc`` in place with one entry call (``run_partials`` over
    the range's chunk rows, then one thread per touched destination) on
    the stream that was current when the sweep was built, counted in
    :data:`launches`. Ranges folded in ascending tile order give
    the whole-layout sweep's bits. On a CPU ``attrs_flat``, :meth:`update`
    runs :func:`packed_sweep_range_ref`.
    """

    def __init__(
        self, program, attrs_flat, aux, row_active, has_weights, aux_batched=False, max_runs=0
    ):
        global pre_gathers
        self.program = program
        self.attrs = attrs_flat
        self.aux = aux
        self.row_active = row_active
        self.has_weights = has_weights
        self.aux_batched = aux_batched
        dev = attrs_flat.device
        self.device = dev
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"no tile sweep for device {dev}")
        self._acc = None  # the accumulator last checked
        self.prog_id, dtype, aux_names = _kernel_program(program)
        K, n_pad = attrs_flat.shape
        P = row_active.shape[0]
        if n_pad % P:
            raise ValueError(f"row_active has {P} intervals, which do not divide n_pad={n_pad}")
        _check(attrs_flat, "attrs_flat", dtype, dev)
        self.K, self.n_pad, self.isz, self.dtype = K, n_pad, n_pad // P, dtype
        self.aux_ptrs = _aux_pointers(aux, aux_names, aux_batched, K, n_pad, dev)
        self.aux_stride = n_pad if aux_batched else 0
        self.active = row_active.to(device=dev, dtype=torch.uint8).contiguous()
        self.y = torch.empty((n_pad, K), dtype=dtype, device=dev)
        self.partial = torch.empty((max(int(max_runs), 1), K), dtype=dtype, device=dev)
        self.max_runs = int(max_runs)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library("packed_sweep_pre_gather")(
            self.prog_id, K, n_pad, self.isz, self.aux_stride, attrs_flat.data_ptr(),
            self.y.data_ptr(), self.active.data_ptr(), self.aux_ptrs[0], self.aux_ptrs[1],
            self.stream,
        )
        if err != 0:
            raise RuntimeError(f"packed_sweep pre_gather launch failed: CUDA error {err}")
        with _count_lock:
            pre_gathers += 1
        self._fn = _library("packed_sweep_range_launch")

    def update(
        self, acc: torch.Tensor, buf: torch.Tensor, rng: TileRange,
        tile_sel: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Fold the runs of the range whose payload starts ``buf`` into ``acc``, in place.

        ``buf`` is a uint8 tensor on the sweep's device; ``tile_sel``, a
        ``(num_tiles,)`` range-local selection, needs the range's
        ``run_tile`` section. Returns ``acc``.
        """
        global launches
        if tile_sel is not None and "run_tile" not in rng.sections:
            raise ValueError("a tile selection needs the range's run_tile section")
        if rng.interval_size * self.row_active.shape[0] != self.attrs.shape[1]:
            raise ValueError(
                f"the range was staged for intervals of {rng.interval_size}; "
                f"row_active has {self.row_active.shape[0]} of n_pad={self.attrs.shape[1]}"
            )
        if buf.dtype != torch.uint8 or buf.device != self.device or buf.numel() < rng.nbytes:
            raise ValueError(f"buf must be a uint8 tensor on {self.device} of {rng.nbytes} bytes or more")
        if self.device.type == "cpu":
            return packed_sweep_range_ref(
                self.program, self.attrs, acc, self.aux, range_views(buf, rng), rng,
                self.row_active, self.has_weights, self.aux_batched, tile_sel,
            )
        if acc is not self._acc:
            _check(acc, "acc", self.dtype, self.device, (self.K, self.n_pad))
            self._acc = acc
        if rng.runs > self.max_runs:
            raise ValueError(f"the range has {rng.runs} runs; the sweep was sized for {self.max_runs}")
        base = buf.data_ptr()
        if base % 16:
            raise ValueError("a range's payload must start 16-byte aligned")
        ptrs = [None if o is None else base + o for o in rng.offsets]
        if not self.has_weights:
            ptrs[2] = None
        sel = None
        if tile_sel is not None:
            sel = tile_sel.to(device=self.device, dtype=torch.uint8).contiguous()
            _check(sel, "tile_sel", torch.uint8, self.device, (rng.num_tiles,))
        err = self._fn(
            self.prog_id, self.K, self.n_pad, rng.chunk_rows, rng.touched, self.isz,
            self.aux_stride, self.y.data_ptr(), acc.data_ptr(), self.partial.data_ptr(), *ptrs,
            _ptr(sel), self.active.data_ptr(), self.aux_ptrs[0], self.aux_ptrs[1], self.stream,
        )
        if err != 0:
            raise RuntimeError(f"packed_sweep range launch failed: CUDA error {err}")
        with _count_lock:
            launches += 1
        return acc
