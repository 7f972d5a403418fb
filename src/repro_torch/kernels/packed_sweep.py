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
    "packed_sweep_update_ref",
    "prepare_packed_tiles",
    "run_index",
    "launches",
    "LONG_RUN",
]

# Kernel launches of packed_sweep_update on CUDA tensors (one per call that
# reaches the card). Callers reset it to 0 and read it around a run.
launches = 0

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


def prepare_packed_tiles(packed, *, has_weights: bool, device) -> dict:
    """Upload the tile leaves and the run index.

    The one upload of the layout: ``src``/``dst``/``run_local``/``run_dst``
    ``(NT, T)``, ``e_valid`` ``(NT,)``, ``weights`` when present, plus the
    leaves of :func:`run_index` (with ``perm`` on a ``src_sorted`` layout),
    and ``interval_size``, a Python int the kernel checks ``row_active``
    against.
    """
    leaves = {k: getattr(packed, k) for k in TILE_LEAVES}
    if has_weights:
        leaves["weights"] = packed.weights
    leaves.update(run_index(packed))
    tiles = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in leaves.items()
    }
    tiles["interval_size"] = packed.interval_size
    return tiles


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
    inside runs, vectorised across runs, then the run rank inside a
    destination, vectorised across destinations — never ``index_add_``
    or ``cumsum``, whose order or precision differ. min/max use
    ``scatter_reduce_``, which is exact in any order.
    """
    K, n_pad = attrs_flat.shape
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

    vert_active = row_active.to(dev).repeat_interleave(n_pad // row_active.shape[0])
    contrib = program.gather(
        attrs_flat[:, e_src],
        e_w,
        _edge_aux(aux, aux_batched, e_src),
        _edge_aux(aux, aux_batched, e_dst) if program.needs_dst_aux else None,
    ).to(acc_flat.dtype)
    ident = reduce_identity(program.reduce, contrib.dtype).to(dev)
    contrib = torch.where(vert_active[e_src], contrib.expand(K, -1), ident)
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

    # Phase 1: each run's left fold in ascending edge order. Edges are
    # grouped by run (stable sort keeps edge order), and runs are visited
    # longest first so the runs still open at position j are a prefix.
    order = torch.sort(run_of_edge, stable=True).indices
    grouped = contrib[:, order]
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.sort(counts, descending=True, stable=True).indices
    open_at = torch.bincount(counts, minlength=1).flip(0).cumsum(0).flip(0)
    partial_by_len = fill.expand(K, R).clone()
    start_by_len = starts[by_len]
    for j in range(int(counts.max()) if R else 0):
        c = int(open_at[j + 1])  # runs with more than j edges
        partial_by_len[:, :c] += grouped[:, start_by_len[:c] + j]
    partial = torch.empty_like(partial_by_len)
    partial[:, by_len] = partial_by_len

    # Phase 2: fold each destination's runs in ascending run order.
    d_order = torch.sort(run_dst, stable=True).indices
    dests, d_counts = torch.unique_consecutive(run_dst[d_order], return_counts=True)
    d_starts = torch.cumsum(d_counts, 0) - d_counts
    for j in range(int(d_counts.max()) if R else 0):
        has = d_counts > j
        d = dests[has]
        out[:, d] = out[:, d] + partial[:, d_order[d_starts[has] + j]]
    return out


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------
_ARGTYPES = (
    [ctypes.c_int] * 5  # prog, K, n_pad, NC, isz
    + [ctypes.c_longlong]  # aux_stride
    + [ctypes.c_void_p] * 18  # tensors (see the C entry point)
    + [ctypes.c_void_p]  # stream
)


def _library():
    from repro_torch.kernels import _build

    lib = _build.load("packed_sweep")
    fn = lib.packed_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
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


def _launch(
    program, attrs_flat, acc_flat, aux, tiles, row_active, has_weights,
    aux_batched, idx, a_valid,
) -> torch.Tensor:
    global launches
    spec = _KERNEL_PROGRAMS.get(type(program))
    if spec is None:
        raise NotImplementedError(
            f"the CUDA tile sweep has no gather for program {type(program).__name__}"
        )
    prog_id, dtype, aux_names = spec
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
    aux_ptrs = []
    for name in aux_names:
        v = aux[name]
        want = (K, n_pad) if aux_batched else (n_pad,)
        _check(v, f"aux[{name!r}]", v.dtype, dev, want)
        if v.dtype != (torch.float32 if name == "inv_out_degree" else torch.int32):
            raise TypeError(f"aux[{name!r}] has unexpected dtype {v.dtype}")
        aux_ptrs.append(v.data_ptr())
    aux_ptrs += [None] * (2 - len(aux_ptrs))
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
