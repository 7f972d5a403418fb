"""Destination-Sorted Sub-Shard structure (port of ``repro.core.dsss``).

The sharder: vertices split into ``P`` equal intervals, edges into ``P²``
sub-shards ``SS[i, j]`` (source interval ``i``, destination interval
``j``), destination-sorted inside each, all held as slices of one flat
edge buffer sorted by ``(i, j, dst, src)``. Hubs: each sub-shard's unique
destinations (``hub_dst``) and the edge → hub slot map (``hub_inv``).

Everything here is host-side numpy, array-for-array what the JAX package
builds: the :class:`PackedSweep` tile layout of the packed path, and the
per-sub-shard views (:class:`SubShard`) and padded "shard files"
(:meth:`DSSSGraph.host_blocks`) of the per-block path. The session
uploads what a run needs once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.preprocess import EdgeList

__all__ = [
    "DSSSGraph",
    "PackedSweep",
    "SubShard",
    "build_dsss",
    "next_bucket",
    "choose_tile_edges",
    "cut_runs_into_tiles",
    "tile_candidates",
    "tile_source_spans",
    "active_tile_mask",
]


def next_bucket(e: int, minimum: int = 8) -> int:
    """Smallest power-of-two bucket >= e."""
    b = minimum
    while b < e:
        b *= 2
    return b


# Smallest tile size the adaptive chooser considers on non-trivial graphs.
TILE_EDGES_FLOOR = 128


def cut_runs_into_tiles(bounds: np.ndarray, tile_edges: int) -> list[tuple[int, int]]:
    """Greedy destination-aligned cut: pack runs into ``tile_edges`` tiles.

    ``bounds`` is the (num_runs + 1,) array of cumulative run boundaries;
    returns ``(r0, r1)`` run-index spans, cutting only between runs.
    """
    n_runs = len(bounds) - 1
    tiles: list[tuple[int, int]] = []
    r = 0
    while r < n_runs:
        limit = bounds[r] + tile_edges
        k = int(np.searchsorted(bounds, limit, side="right")) - 1
        k = min(max(k, r + 1), n_runs)
        tiles.append((r, k))
        r = k
    return tiles


def tile_candidates(m: int, max_run: int) -> list[int]:
    """Power-of-two tile sizes from ``max(FLOOR, bucket(max_run))`` to ``bucket(m)``."""
    if m == 0:
        return [8]
    lo = max(min(TILE_EDGES_FLOOR, next_bucket(m)), next_bucket(max_run))
    hi = max(lo, next_bucket(m))
    out = []
    T = lo
    while T <= hi:
        out.append(T)
        T *= 2
    return out


def choose_tile_edges(run_lengths: np.ndarray) -> int:
    """The candidate tile size with the fewest padded slots (ties: smaller)."""
    m = int(run_lengths.sum()) if len(run_lengths) else 0
    if m == 0:
        return 8
    bounds = np.concatenate([[0], np.cumsum(run_lengths)])
    best_T, best_slots = None, None
    for T in tile_candidates(m, int(run_lengths.max())):
        slots = len(cut_runs_into_tiles(bounds, T)) * T
        if best_slots is None or slots < best_slots:
            best_T, best_slots = T, slots
    return best_T


@dataclasses.dataclass(frozen=True)
class SubShard:
    """A view of one sub-shard SS[i, j] (slices of the flat arrays).

    ``src_local``/``dst_local`` are offsets within the source / destination
    interval; ``hub_dst`` the sorted unique local destinations and
    ``hub_inv`` each edge's hub slot.
    """

    i: int
    j: int
    src_local: np.ndarray  # int32 (e,)
    dst_local: np.ndarray  # int32 (e,)
    weights: np.ndarray | None  # float32 (e,) or None
    hub_dst: np.ndarray  # int32 (u,)
    hub_inv: np.ndarray  # int32 (e,)
    src_sorted: bool = False  # True for the GraphChi-like baseline layout

    @property
    def num_edges(self) -> int:
        return int(self.src_local.shape[0])

    @property
    def num_unique_dst(self) -> int:
        return int(self.hub_dst.shape[0])


@dataclasses.dataclass(frozen=True)
class PackedSweep:
    """Destination-aligned tile packing of one full update sweep.

    The flat DSSS edge stream cut into uniform ``(num_tiles, tile_edges)``
    windows. ``mode="adaptive"`` cuts only at destination-run boundaries (a
    run is one sub-shard's span of edges sharing a destination, one hub
    slot), with the tile size chosen by :func:`choose_tile_edges`;
    ``mode="subshard"`` puts each sub-shard in a tile of its own.

    Per tile: ``src``/``dst`` global endpoint ids; ``run_local`` each
    edge's run slot within the tile; ``run_dst`` each run slot's global
    destination (``n_pad`` past ``u``); ``weights``; ``e_valid`` real edges.
    Tile order folds each destination's runs in ascending source-interval
    order, the fold order of every SPU/DPU/MPU schedule.
    ``src_interval``/``dst_interval``/``base_slot``/``u``/``row_offset``
    are host-side metadata; ``interval_size`` is the graph's, with which
    the kernel's run index checks that each run reads one source interval.
    """

    mode: str  # "adaptive" | "subshard"
    m: int
    n_pad: int
    tile_edges: int
    src: np.ndarray  # int32 (NT, T)
    dst: np.ndarray  # int32 (NT, T)
    run_local: np.ndarray  # int32 (NT, T)
    run_dst: np.ndarray  # int32 (NT, T), n_pad sentinel
    weights: np.ndarray | None  # float32 (NT, T) or None
    e_valid: np.ndarray  # int32 (NT,)
    src_interval: np.ndarray  # int32 (NT,)
    dst_interval: np.ndarray  # int32 (NT,)
    base_slot: np.ndarray  # int64 (NT,)
    u: np.ndarray  # int32 (NT,)
    row_offset: np.ndarray  # int64 (NT,)
    interval_size: int  # vertices per interval: source interval = src // interval_size

    @property
    def num_tiles(self) -> int:
        return int(self.e_valid.shape[0])

    @property
    def padded_edge_slots(self) -> int:
        return self.num_tiles * self.tile_edges

    @property
    def padding_ratio(self) -> float:
        return self.padded_edge_slots / max(self.m, 1)


def tile_source_spans(
    packed: PackedSweep, interval_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile source-interval span ``[first_i, last_i]`` (inclusive)."""
    nt = packed.num_tiles
    first = packed.src_interval.astype(np.int64)
    if nt == 0:
        return first, first.copy()
    last_edge = np.maximum(packed.e_valid.astype(np.int64), 1) - 1
    last_src = packed.src[np.arange(nt), last_edge].astype(np.int64)
    return first, np.maximum(first, last_src // interval_size)


def active_tile_mask(
    row_active: np.ndarray, first: np.ndarray, last: np.ndarray
) -> np.ndarray:
    """``(NT,)`` bool: does tile t hold any edge from an active interval?

    A prefix-sum range query over the (P,) interval bitmap, O(P + NT).
    """
    row = np.asarray(row_active, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(row)])
    return (cum[last + 1] - cum[first]) > 0


@dataclasses.dataclass(frozen=True)
class DSSSGraph:
    """The sharded graph: P intervals × P² destination-sorted sub-shards."""

    n: int
    m: int
    P: int
    interval_size: int  # ceil(n / P); last interval padded
    src: np.ndarray  # int32 (m,) sorted by (i, j, dst, src)
    dst: np.ndarray  # int32 (m,)
    weights: np.ndarray | None
    offsets: np.ndarray  # int64 (P, P + 1)
    out_degree: np.ndarray  # int32 (n_pad,)
    in_degree: np.ndarray  # int32 (n_pad,)
    hub_dst_flat: np.ndarray  # int32
    hub_inv_flat: np.ndarray  # int32 (m,)
    hub_offsets: np.ndarray  # int64 (P, P + 1)
    edgelist: EdgeList
    src_sorted: bool = False

    @property
    def n_pad(self) -> int:
        return self.P * self.interval_size

    def interval_bounds(self, i: int) -> tuple[int, int]:
        lo = i * self.interval_size
        return lo, min(lo + self.interval_size, self.n)

    def subshard(self, i: int, j: int) -> SubShard:
        lo = int(self.offsets[i, j])
        hi = int(self.offsets[i, j + 1])
        hlo = int(self.hub_offsets[i, j])
        hhi = int(self.hub_offsets[i, j + 1])
        isz = self.interval_size
        return SubShard(
            i=i,
            j=j,
            src_local=(self.src[lo:hi] - i * isz).astype(np.int32),
            dst_local=(self.dst[lo:hi] - j * isz).astype(np.int32),
            weights=None if self.weights is None else self.weights[lo:hi],
            hub_dst=self.hub_dst_flat[hlo:hhi],
            hub_inv=self.hub_inv_flat[lo:hi],
            src_sorted=self.src_sorted,
        )

    def subshard_edge_count(self, i: int, j: int) -> int:
        return int(self.offsets[i, j + 1] - self.offsets[i, j])

    def padded_subshard(self, i: int, j: int) -> dict | None:
        """SS[i, j] in the per-block path's "shard file" format, or ``None`` if empty.

        Edge arrays padded with zeros to a power-of-two bucket, the hub
        slot list to its own bucket: byte for byte the JAX package's
        buffers (whose bucketing bounds its jit variants).
        """
        e = self.subshard_edge_count(i, j)
        if e == 0:
            return None
        ss = self.subshard(i, j)
        pad = next_bucket(e) - e
        ub = next_bucket(max(ss.num_unique_dst, 1))
        return {
            "src_local": np.pad(ss.src_local, (0, pad)),
            "dst_local": np.pad(ss.dst_local, (0, pad)),
            "hub_inv": np.pad(ss.hub_inv, (0, pad)),
            "hub_dst": np.pad(ss.hub_dst, (0, ub - ss.num_unique_dst)),
            "e": e,
            "u": ss.num_unique_dst,
            "u_bucket": ub,
            "weights": (
                None
                if ss.weights is None
                else np.pad(ss.weights, (0, pad)).astype(np.float32)
            ),
        }

    def host_blocks(self) -> dict[tuple[int, int], dict]:
        """Every non-empty sub-shard's :meth:`padded_subshard`, keyed ``(i, j)``."""
        blocks: dict[tuple[int, int], dict] = {}
        for i in range(self.P):
            for j in range(self.P):
                blk = self.padded_subshard(i, j)
                if blk is not None:
                    blocks[(i, j)] = blk
        return blocks

    def total_edge_bytes(self, Be: int) -> int:
        """Model bytes of the whole edge topology, ``m·Be``."""
        return self.m * Be

    def density_matrix(self) -> np.ndarray:
        """(P, P) edge counts ``e`` per sub-shard."""
        return (self.offsets[:, 1:] - self.offsets[:, :-1]).astype(np.int64)

    def hub_counts(self) -> np.ndarray:
        """(P, P) unique-destination counts ``u`` per sub-shard."""
        return (self.hub_offsets[:, 1:] - self.hub_offsets[:, :-1]).astype(np.int64)

    def global_hub_slots(self) -> np.ndarray:
        """int64 (m,): each edge's global hub slot (run id)."""
        counts = np.diff(
            np.concatenate([[0], self.offsets[:, 1:].ravel()])
        )
        bases = np.repeat(self.hub_offsets[:, :-1].ravel(), counts)
        return bases + self.hub_inv_flat

    def packed_sweep(self, mode: str = "adaptive") -> PackedSweep:
        """Tile-pack the whole sweep (pure numpy)."""
        if mode not in ("adaptive", "subshard"):
            raise ValueError(f"packing mode must be 'adaptive' or 'subshard', got {mode!r}")
        if mode == "adaptive" and self.src_sorted:
            raise ValueError(
                "adaptive tile packing needs destination-sorted sub-shards; "
                "src_sorted graphs must use mode='subshard'"
            )
        m = self.m
        gslot = self.global_hub_slots()
        if mode == "adaptive":
            if m == 0:
                starts = np.zeros(0, np.int64)
            else:
                change = np.ones(m, dtype=bool)
                change[1:] = gslot[1:] != gslot[:-1]
                starts = np.flatnonzero(change).astype(np.int64)
            bounds = np.concatenate([starts, [m]])
            T = choose_tile_edges(np.diff(bounds))
            tile_runs = cut_runs_into_tiles(bounds, T)
        else:
            blk_bounds = self.offsets[:, 1:].ravel()
            blk_lo = np.concatenate([[0], blk_bounds[:-1]])
            nonempty = blk_bounds > blk_lo
            lo, hi = blk_lo[nonempty], blk_bounds[nonempty]
            T = next_bucket(int((hi - lo).max()) if len(lo) else 8)
            bounds = None
            tile_runs = [(int(a), int(b)) for a, b in zip(lo, hi)]
        nt = len(tile_runs)
        src = np.zeros((nt, T), np.int32)
        dst = np.zeros((nt, T), np.int32)
        run_local = np.zeros((nt, T), np.int32)
        run_dst = np.full((nt, T), self.n_pad, np.int32)
        weights = None if self.weights is None else np.zeros((nt, T), np.float32)
        e_valid = np.zeros(nt, np.int32)
        src_iv = np.zeros(nt, np.int32)
        dst_iv = np.zeros(nt, np.int32)
        base_slot = np.zeros(nt, np.int64)
        u = np.zeros(nt, np.int32)
        row_offset = np.zeros(nt, np.int64)
        isz = self.interval_size
        for t, span in enumerate(tile_runs):
            if mode == "adaptive":
                r0, r1 = span
                lo_e, hi_e = int(bounds[r0]), int(bounds[r1])
                base = int(gslot[lo_e])
                nu = r1 - r0
            else:
                lo_e, hi_e = span
                base = int(gslot[lo_e] - self.hub_inv_flat[lo_e])
                nu = int(self.hub_inv_flat[lo_e:hi_e].max()) + 1
            e = hi_e - lo_e
            src[t, :e] = self.src[lo_e:hi_e]
            dst[t, :e] = self.dst[lo_e:hi_e]
            run_local[t, :e] = (gslot[lo_e:hi_e] - base).astype(np.int32)
            run_dst[t, :e][run_local[t, :e]] = dst[t, :e]
            if weights is not None:
                weights[t, :e] = self.weights[lo_e:hi_e]
            e_valid[t] = e
            src_iv[t] = self.src[lo_e] // isz
            dst_iv[t] = self.dst[lo_e] // isz
            base_slot[t] = base
            u[t] = nu
            row_offset[t] = lo_e
        return PackedSweep(
            mode=mode,
            m=m,
            n_pad=self.n_pad,
            tile_edges=T,
            src=src,
            dst=dst,
            run_local=run_local,
            run_dst=run_dst,
            weights=weights,
            e_valid=e_valid,
            src_interval=src_iv,
            dst_interval=dst_iv,
            base_slot=base_slot,
            u=u,
            row_offset=row_offset,
            interval_size=isz,
        )

    def mean_hub_in_degree(self) -> float:
        """The paper's ``d``: m / Σ unique sub-shard destinations."""
        return self.m / max(int(self.hub_offsets[-1, -1]), 1)


def build_dsss(el: EdgeList, P: int, *, src_sorted: bool = False) -> DSSSGraph:
    """The sharding pass; ``src_sorted`` builds the GraphChi-like baseline layout."""
    if P < 1:
        raise ValueError("P must be >= 1")
    n, m = el.n, el.m
    interval_size = -(-n // P)
    src = el.src.astype(np.int64)
    dst = el.dst.astype(np.int64)
    si = src // interval_size
    dj = dst // interval_size
    # np.lexsort keys are last-key-major.
    if src_sorted:
        order = np.lexsort((dst, src, dj, si))
    else:
        order = np.lexsort((src, dst, dj, si))
    src_s = src[order].astype(np.int32)
    dst_s = dst[order].astype(np.int32)
    w_s = None if el.weights is None else el.weights[order]

    block = si[order] * P + dj[order]
    counts = np.bincount(block, minlength=P * P).reshape(P, P)
    flat_offsets = np.zeros(P * P + 1, dtype=np.int64)
    np.cumsum(counts.ravel(), out=flat_offsets[1:])
    offsets = np.zeros((P, P + 1), dtype=np.int64)
    offsets[:, 0] = flat_offsets[:-1].reshape(P, P)[:, 0]
    offsets[:, 1:] = flat_offsets[1:].reshape(P, P)

    isz = interval_size
    starts = flat_offsets[:-1]
    is_block_start = np.zeros(m, dtype=bool)
    is_block_start[starts[starts < m]] = True
    if src_sorted:
        hub_dst_parts: list[np.ndarray] = []
        hub_inv_flat = np.zeros(m, dtype=np.int32)
        hub_counts = np.zeros(P * P, dtype=np.int64)
        for b in range(P * P):
            lo, hi = int(flat_offsets[b]), int(flat_offsets[b + 1])
            if hi == lo:
                hub_dst_parts.append(np.zeros(0, dtype=np.int32))
                continue
            u, inv = np.unique(dst_s[lo:hi], return_inverse=True)
            hub_dst_parts.append((u - (b % P) * isz).astype(np.int32))
            hub_inv_flat[lo:hi] = inv.astype(np.int32)
            hub_counts[b] = len(u)
        hub_dst_flat = (
            np.concatenate(hub_dst_parts) if hub_dst_parts else np.zeros(0, np.int32)
        )
    else:
        # Destinations are sorted inside each block: a new hub slot opens
        # wherever dst changes or a new sub-shard begins.
        new_slot = np.ones(m, dtype=bool)
        if m > 1:
            new_slot[1:] = (dst_s[1:] != dst_s[:-1]) | is_block_start[1:]
        slot_global = np.cumsum(new_slot) - 1 if m else np.zeros(0, np.int64)
        hub_dst_flat = (
            (dst_s[new_slot] - (dst_s[new_slot] // isz) * isz).astype(np.int32)
            if m
            else np.zeros(0, np.int32)
        )
        hub_counts = np.zeros(P * P, dtype=np.int64)
        if m:
            blk_of_slot = np.repeat(
                np.arange(P * P), np.diff(flat_offsets)
            )[new_slot]
            hub_counts = np.bincount(blk_of_slot, minlength=P * P)
            slot_base = np.zeros(P * P, dtype=np.int64)
            np.cumsum(hub_counts[:-1], out=slot_base[1:])
            hub_inv_flat = (
                slot_global - np.repeat(slot_base, np.diff(flat_offsets))
            ).astype(np.int32)
        else:
            hub_inv_flat = np.zeros(0, np.int32)

    hub_offsets = np.zeros((P, P + 1), dtype=np.int64)
    hub_cum = np.zeros(P * P + 1, dtype=np.int64)
    np.cumsum(hub_counts, out=hub_cum[1:])
    hub_offsets[:, 0] = hub_cum[:-1].reshape(P, P)[:, 0]
    hub_offsets[:, 1:] = hub_cum[1:].reshape(P, P)

    n_pad = P * interval_size
    out_deg = np.zeros(n_pad, dtype=np.int32)
    out_deg[:n] = el.out_degree
    in_deg = np.zeros(n_pad, dtype=np.int32)
    in_deg[:n] = el.in_degree

    return DSSSGraph(
        n=n,
        m=m,
        P=P,
        interval_size=interval_size,
        src=src_s,
        dst=dst_s,
        weights=w_s,
        offsets=offsets,
        out_degree=out_deg,
        in_degree=in_deg,
        hub_dst_flat=hub_dst_flat,
        hub_inv_flat=hub_inv_flat,
        hub_offsets=hub_offsets,
        edgelist=el,
        src_sorted=src_sorted,
    )
