"""External-memory DSSS build: raw edge stream → ``.dsss`` in bounded RAM.

Port of ``repro.storage.build``: the files it writes are byte for byte the
JAX package's for the same input.

The in-memory pipeline (``degree_and_densify`` → ``build_dsss`` →
``write_dsss``) holds the whole edge set several times over; this module
produces the *identical* container layout while keeping resident
edge-array bytes bounded by the configured ``chunk_budget`` (GraphMP's
semi-external-memory discipline: vertex-scale state — degrees, the
dense-id mapping, the P² directory — stays in RAM; edge-scale state never
does). The classic partition-and-merge shape:

1. **id pass** — stream the input once, accumulating the sorted unique
   endpoint set (the dense-id mapping of the degreer) chunk by chunk.
2. **partition pass** — stream again: map each chunk to dense ids, bucket
   by ``(source interval, destination interval)``, sort each chunk's
   bucket slice by ``(dst, src)`` and append it to a single spill file
   (one file + an in-RAM run registry, not the paper's P² files — which
   hit OS handle limits, §IV-D). Each bucket is now a sequence of sorted
   runs.
3. **merge pass** — visit buckets in the schedules' row-major streaming
   order. A bucket that fits the budget is loaded and sorted whole;
   larger buckets are k-way merged from their runs with bounded read
   buffers (``heapq.merge`` is stable, so duplicate edges keep input
   order and dedup keeps the first occurrence — exactly
   ``degree_and_densify``'s semantics). The merged stream is deduplicated
   and emitted *streamingly* into spool files for every store segment:
   flat edges, hub arrays, and the bucket-padded per-block arrays. Run
   lengths feed per-candidate greedy tile counters, so the adaptive tile
   size is chosen exactly as :func:`repro_torch.core.dsss.choose_tile_edges`
   would choose it — without ever materializing the run-length array.
4. **packed pass** — re-stream the flat spools with the chosen tile size,
   cutting tiles at destination-run boundaries (the identical greedy
   rule) and spooling the :class:`~repro_torch.core.dsss.PackedSweep` arrays.
5. **assembly** — stream every spool into a :class:`~repro_torch.storage.
   format.StoreWriter` with bounded copy buffers.

Every edge-scale allocation is charged to an internal ledger;
``BuildStats.peak_edge_bytes`` is the proof the bounded-memory contract
tests assert against.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import shutil
import tempfile
from typing import Callable, Iterable, Iterator

import numpy as np

from repro_torch.core.dsss import next_bucket, tile_candidates
from repro_torch.graph.preprocess import _sorted_unique, map_to_dense, merge_unique_ids
from repro_torch.storage.format import FORMAT_VERSION, StoreWriter

__all__ = ["BuildStats", "build_dsss_file", "build_from_text"]

# Candidate tile sizes tracked by the streaming chooser: 2^3 .. 2^42
# (an edge count past 2^42 would overflow the greedy counters' premise).
_TILE_LOG2_LO, _TILE_LOG2_HI = 3, 42


@dataclasses.dataclass
class BuildStats:
    """What the build did — including the bounded-memory proof.

    ``peak_edge_bytes`` is the high-water mark of *resident edge-array
    bytes* (chunk buffers, bucket loads, merge/read buffers, tile
    buffers, assembly copy windows) charged by the builder's allocation
    ledger. Vertex-scale state (degrees, the id mapping, the P²
    directory) is excluded by design — it is O(n), the semi-external
    assumption. The bounded-build contract is
    ``peak_edge_bytes <= ~2 * chunk_budget``.
    """

    path: str
    n: int
    m: int
    m_raw: int
    P: int
    interval_size: int
    num_blocks: int
    chunk_budget: int
    chunk_edges: int
    num_chunks: int
    streamed_buckets: int
    spill_bytes: int
    peak_edge_bytes: int
    tile_edges: int
    num_tiles: int


class _Ledger:
    """Tracks live edge-array bytes by tag; ``peak`` is the contract."""

    def __init__(self):
        self._live: dict[str, int] = {}
        self.peak = 0

    def track(self, tag: str, *arrays) -> None:
        self._live[tag] = sum(int(a.nbytes) for a in arrays if a is not None)
        self._bump()

    def add(self, tag: str, nbytes: int) -> None:
        self._live[tag] = self._live.get(tag, 0) + int(nbytes)
        self._bump()

    def drop(self, tag: str) -> None:
        self._live.pop(tag, None)

    def _bump(self) -> None:
        total = sum(self._live.values())
        if total > self.peak:
            self.peak = total


class _Spool:
    """An append-only raw temp file holding one future store segment."""

    def __init__(self, path: str, dtype):
        self.path = path
        self.dtype = np.dtype(dtype)
        self._f = open(path, "wb")
        self.items = 0

    def append(self, arr) -> None:
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        arr.tofile(self._f)
        self.items += arr.size

    def append_zeros(self, count: int) -> None:
        if count > 0:
            self.append(np.zeros(count, self.dtype))

    def close(self) -> None:
        self._f.close()


class _TileChooser:
    """Streaming replica of :func:`repro_torch.core.dsss.choose_tile_edges`.

    Maintains, for every power-of-two candidate tile size, the greedy
    destination-run-aligned cut's tile count, fed one closed run at a
    time. The greedy rule is the exact stream form of
    ``cut_runs_into_tiles``: a run joins the current tile iff its end
    stays within ``tile_start + T``, else it opens a new tile (a run
    longer than T force-opens a tile alone — never hit by the chosen
    candidates, whose floor is ``bucket(max_run)``).
    """

    def __init__(self):
        self.T = np.array(
            [1 << k for k in range(_TILE_LOG2_LO, _TILE_LOG2_HI + 1)], np.int64
        )
        self.tiles = np.zeros(len(self.T), np.int64)
        self.tile_start = np.zeros(len(self.T), np.int64)
        self.opened = False
        self.max_run = 0

    def close_run(self, start: int, end: int) -> None:
        if end - start > self.max_run:
            self.max_run = end - start
        if not self.opened:
            self.tiles[:] = 1
            self.tile_start[:] = start
            self.opened = True
            return
        over = end > self.tile_start + self.T
        self.tiles[over] += 1
        self.tile_start[over] = start

    def choose(self, m: int) -> int:
        if m >= 1 << _TILE_LOG2_HI:
            raise ValueError("edge count exceeds the tile chooser's range")
        best_T, best_slots = None, None
        for T in tile_candidates(m, self.max_run):
            idx = int(T).bit_length() - 1 - _TILE_LOG2_LO
            slots = int(self.tiles[idx]) * T
            if best_slots is None or slots < best_slots:
                best_T, best_slots = T, slots
        return best_T


def _normalize_chunk(chunk) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    if len(chunk) == 2:
        src, dst = chunk
        w = None
    else:
        src, dst, w = chunk
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError("chunk src/dst length mismatch")
    if w is not None:
        w = np.asarray(w, dtype=np.float32).reshape(-1)
        if w.shape != src.shape:
            raise ValueError("chunk weights length mismatch")
    return src, dst, w


class _ExternalBuilder:
    def __init__(
        self,
        chunks: Callable[[], Iterable],
        out_path: str,
        P: int,
        *,
        chunk_budget: int,
        drop_self_loops: bool,
        dedup: bool,
        workdir: str | None,
        packing: str | None,
    ):
        if P < 1:
            raise ValueError("P must be >= 1")
        if packing not in ("adaptive", None):
            raise ValueError(
                "the external builder emits destination-sorted DSSS; packing "
                f"must be 'adaptive' or None, got {packing!r}"
            )
        self.chunks = chunks
        self.out_path = out_path
        self.P = P
        self.chunk_budget = int(chunk_budget)
        self.drop_self_loops = drop_self_loops
        self.dedup = dedup
        self.packing = packing
        self.workdir = workdir
        # ~64 bytes/edge of transient state per partition sub-chunk (raw
        # int64 pair + dense ids + block keys + lexsort order + records).
        self.chunk_edges = max(1024, self.chunk_budget // 64)
        self.load_bytes = max(64, self.chunk_budget // 4)
        self.io_chunk = max(4096, min(1 << 22, self.chunk_budget // 4))
        self.ledger = _Ledger()
        self.stats_chunks = 0
        self.streamed_buckets = 0
        self.m_raw = 0

    # -- pass 1: the dense-id mapping ---------------------------------------
    def pass_ids(self) -> None:
        # Per-chunk uniques are folded into the accumulator only when the
        # pending pile grows past a few chunks' worth — folding re-sorts
        # the whole O(n) accumulator, so doing it every sub-chunk would
        # make this pass O(num_chunks · n log n) on big graphs. The
        # pending bound keeps peak memory at O(n + a few chunks).
        uniq = np.zeros(0, np.int64)
        pending: list[np.ndarray] = []
        pending_items = 0
        fold_at = 4 * self.chunk_edges
        m_raw = 0
        self.weighted = False
        first = True
        for chunk in self.chunks():
            src, dst, w = _normalize_chunk(chunk)
            if first:
                # The weights column fixes the spill record dtype; noting
                # it here keeps chunks() at exactly two invocations.
                self.weighted = w is not None
                first = False
            for lo in range(0, len(src), self.chunk_edges):
                s = src[lo : lo + self.chunk_edges]
                d = dst[lo : lo + self.chunk_edges]
                if self.drop_self_loops:
                    keep = s != d
                    s, d = s[keep], d[keep]
                m_raw += len(s)
                self.ledger.track("id_chunk", s, d)
                part = _sorted_unique(np.concatenate([s, d]))
                pending.append(part)
                pending_items += len(part)
                self.ledger.add("id_pending", part.nbytes)
                if pending_items >= fold_at:
                    uniq = merge_unique_ids(uniq, *pending)
                    pending, pending_items = [], 0
                    self.ledger.drop("id_pending")
                self.ledger.drop("id_chunk")
        if pending:
            uniq = merge_unique_ids(uniq, *pending)
            self.ledger.drop("id_pending")
        self.uniq = uniq
        self.n = int(len(uniq))
        self.interval_size = -(-self.n // self.P) if self.n else 0
        self.m_raw = m_raw

    # -- pass 2: partition into sorted runs ---------------------------------
    def pass_partition(self) -> None:
        P, isz = self.P, self.interval_size
        self.spill_path = os.path.join(self.workdir, "spill.bin")
        self.rec_dtype = np.dtype(
            [("d", "<i4"), ("s", "<i4")]
            + ([("w", "<f4")] if self.weighted else [])
        )
        rec = self.rec_dtype.itemsize
        runs: dict[int, list[tuple[int, int]]] = {}
        with open(self.spill_path, "wb") as sf:
            for chunk in self.chunks():
                src, dst, w = _normalize_chunk(chunk)
                if (w is not None) != self.weighted:
                    raise ValueError("chunks disagree on the weights column")
                for lo in range(0, len(src), self.chunk_edges):
                    s_raw = src[lo : lo + self.chunk_edges]
                    d_raw = dst[lo : lo + self.chunk_edges]
                    w_raw = None if w is None else w[lo : lo + self.chunk_edges]
                    if self.drop_self_loops:
                        keep = s_raw != d_raw
                        s_raw, d_raw = s_raw[keep], d_raw[keep]
                        if w_raw is not None:
                            w_raw = w_raw[keep]
                    if len(s_raw) == 0:
                        continue
                    self.stats_chunks += 1
                    s = map_to_dense(self.uniq, s_raw)
                    d = map_to_dense(self.uniq, d_raw)
                    block = (s.astype(np.int64) // isz) * P + d // isz
                    order = np.lexsort((s, d, block))
                    recs = np.empty(len(s), self.rec_dtype)
                    recs["d"] = d[order]
                    recs["s"] = s[order]
                    if w_raw is not None:
                        recs["w"] = w_raw[order]
                    bsort = block[order]
                    self.ledger.track(
                        "part_chunk", s_raw, d_raw, w_raw, s, d, block, order,
                        recs, bsort,
                    )
                    base = sf.tell()
                    recs.tofile(sf)
                    bnd = np.flatnonzero(np.diff(bsort)) + 1
                    edges = np.concatenate([[0], bnd, [len(recs)]])
                    for a, b in zip(edges[:-1], edges[1:]):
                        runs.setdefault(int(bsort[a]), []).append(
                            (base + int(a) * rec, int(b - a))
                        )
                    self.ledger.drop("part_chunk")
        self.runs = runs
        self.spill_bytes = os.path.getsize(self.spill_path)

    # -- pass 3: merge, dedup, and emit every segment stream -----------------
    def _run_records(self, f, offset: int, count: int) -> Iterator[tuple]:
        """Yield one sorted run's records as python tuples, block-buffered."""
        rec = self.rec_dtype.itemsize
        buf_items = max(
            64,
            (self.chunk_budget // 4) // rec // max(self._active_runs, 1),
        )
        pos = 0
        names = self.rec_dtype.names
        while pos < count:
            k = min(buf_items, count - pos)
            f.seek(offset + pos * rec)
            arr = np.fromfile(f, dtype=self.rec_dtype, count=k)
            pos += k
            cols = [arr[name].tolist() for name in names]
            for t in zip(*cols):
                yield t

    def _bucket_pieces(
        self, f, run_list: list[tuple[int, int]]
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray | None]]:
        """Sorted, bounded pieces of one bucket's merged record stream."""
        total = sum(c for _, c in run_list)
        rec = self.rec_dtype.itemsize
        if total * rec <= self.load_bytes:
            parts = []
            for off, cnt in run_list:
                f.seek(off)
                parts.append(np.fromfile(f, dtype=self.rec_dtype, count=cnt))
            recs = np.concatenate(parts)
            order = np.lexsort((recs["s"], recs["d"]))
            recs = recs[order]
            self.ledger.track("bucket_load", *parts, recs, order)
            d = recs["d"].copy()
            s = recs["s"].copy()
            w = recs["w"].copy() if self.weighted else None
            del parts, recs, order
            self.ledger.track("bucket_load", d, s, w)
            yield d, s, w
            self.ledger.drop("bucket_load")
            return
        # k-way bounded merge of the bucket's sorted runs. heapq.merge is
        # stable across iterables, so duplicate (dst, src) keys keep their
        # partition (= input) order and dedup keeps the first occurrence,
        # matching degree_and_densify exactly.
        self.streamed_buckets += 1
        self._active_runs = len(run_list)
        merged = heapq.merge(
            *(self._run_records(f, off, cnt) for off, cnt in run_list),
            key=lambda t: (t[0], t[1]),
        )
        piece = self.chunk_edges
        bd: list = []
        bs: list = []
        bw: list = []
        # Charge what the merge actually keeps resident: every run's read
        # buffer (the same buf_items formula as _run_records) plus the
        # output piece being accumulated.
        buf_items = max(
            64, (self.chunk_budget // 4) // rec // max(self._active_runs, 1)
        )
        self.ledger.add(
            "merge_buffers",
            self._active_runs * buf_items * rec + piece * rec,
        )
        for t in merged:
            bd.append(t[0])
            bs.append(t[1])
            if self.weighted:
                bw.append(t[2])
            if len(bd) >= piece:
                yield (
                    np.array(bd, np.int32),
                    np.array(bs, np.int32),
                    np.array(bw, np.float32) if self.weighted else None,
                )
                bd, bs, bw = [], [], []
        if bd:
            yield (
                np.array(bd, np.int32),
                np.array(bs, np.int32),
                np.array(bw, np.float32) if self.weighted else None,
            )
        self.ledger.drop("merge_buffers")

    def pass_merge(self) -> None:
        P, isz, n = self.P, self.interval_size, self.n
        sp = {
            name: _Spool(os.path.join(self.workdir, name + ".spool"), dt)
            for name, dt in (
                ("src", np.int32),
                ("dst", np.int32),
                ("hub_dst_flat", np.int32),
                ("hub_inv_flat", np.int32),
                ("blk_src_local", np.int32),
                ("blk_dst_local", np.int32),
                ("blk_hub_inv", np.int32),
                ("blk_hub_dst", np.int32),
            )
        }
        if self.weighted:
            sp["weights"] = _Spool(
                os.path.join(self.workdir, "weights.spool"), np.float32
            )
            sp["blk_weights"] = _Spool(
                os.path.join(self.workdir, "blk_weights.spool"), np.float32
            )
        self.spools = sp
        self.counts = np.zeros((P, P), np.int64)
        self.hub_counts = np.zeros((P, P), np.int64)
        self.out_deg = np.zeros(max(n, 1), np.int64)
        self.in_deg = np.zeros(max(n, 1), np.int64)
        self.blk_dir: list[tuple[int, int, int, int, int]] = []  # i,j,e,u,ub
        chooser = _TileChooser()
        self._active_runs = 1
        flat_pos = 0
        cur_run_start: int | None = None
        with open(self.spill_path, "rb") as f:
            for b in range(P * P):
                run_list = self.runs.get(b)
                if not run_list:
                    continue
                i, j = divmod(b, P)
                prev_d = prev_s = None  # dedup carry within the bucket
                last_run_d = None  # run carry within the block
                e_blk = 0
                u_blk = 0
                for d, s, w in self._bucket_pieces(f, run_list):
                    if self.dedup:
                        new = np.ones(len(d), bool)
                        new[1:] = (d[1:] != d[:-1]) | (s[1:] != s[:-1])
                        if prev_d is not None:
                            new[0] = (int(d[0]) != prev_d) or (int(s[0]) != prev_s)
                        d_k, s_k = d[new], s[new]
                        w_k = None if w is None else w[new]
                    else:
                        d_k, s_k, w_k = d, s, w
                    prev_d, prev_s = int(d[-1]), int(s[-1])
                    if len(d_k) == 0:
                        continue
                    self.ledger.track("merge_piece", d, s, w, d_k, s_k, w_k)
                    run_new = np.ones(len(d_k), bool)
                    run_new[1:] = d_k[1:] != d_k[:-1]
                    if last_run_d is not None:
                        run_new[0] = int(d_k[0]) != last_run_d
                    last_run_d = int(d_k[-1])
                    # Feed the streaming tile chooser one closed run at a
                    # time (runs close when the next one starts).
                    for p in np.flatnonzero(run_new):
                        a = flat_pos + int(p)
                        if cur_run_start is not None:
                            chooser.close_run(cur_run_start, a)
                        cur_run_start = a
                    slots = u_blk + np.cumsum(run_new) - 1
                    sp["src"].append(s_k)
                    sp["dst"].append(d_k)
                    sp["hub_inv_flat"].append(slots)
                    sp["blk_hub_inv"].append(slots)
                    hub_d = (d_k[run_new] - j * isz).astype(np.int32)
                    sp["hub_dst_flat"].append(hub_d)
                    sp["blk_hub_dst"].append(hub_d)
                    sp["blk_src_local"].append(s_k - i * isz)
                    sp["blk_dst_local"].append(d_k - j * isz)
                    if self.weighted:
                        sp["weights"].append(w_k)
                        sp["blk_weights"].append(w_k)
                    self.out_deg += np.bincount(s_k, minlength=len(self.out_deg))
                    self.in_deg += np.bincount(d_k, minlength=len(self.in_deg))
                    e_blk += len(d_k)
                    u_blk += int(run_new.sum())
                    flat_pos += len(d_k)
                    self.ledger.drop("merge_piece")
                if e_blk == 0:
                    continue
                self.counts[i, j] = e_blk
                self.hub_counts[i, j] = u_blk
                ub = next_bucket(max(u_blk, 1))
                bucket = next_bucket(e_blk)
                self.blk_dir.append((i, j, e_blk, u_blk, ub))
                # Bucket padding — the block stream stores padded arrays,
                # exactly like DSSSGraph.padded_subshard.
                for name in ("blk_src_local", "blk_dst_local", "blk_hub_inv"):
                    sp[name].append_zeros(bucket - e_blk)
                sp["blk_hub_dst"].append_zeros(ub - u_blk)
                if self.weighted:
                    sp["blk_weights"].append_zeros(bucket - e_blk)
        if cur_run_start is not None:
            chooser.close_run(cur_run_start, flat_pos)
        self.m = flat_pos
        self.chooser = chooser
        for s in sp.values():
            s.close()

    # -- pass 4: tile the flat stream with the chosen T ----------------------
    def pass_packed(self) -> None:
        P, isz = self.P, self.interval_size
        T = self.chooser.choose(self.m)
        self.tile_edges = T
        self.num_tiles = 0
        n_pad = P * isz
        psp = {
            name: _Spool(os.path.join(self.workdir, name + ".spool"), dt)
            for name, dt in (
                ("p_src", np.int32),
                ("p_dst", np.int32),
                ("p_run_local", np.int32),
                ("p_run_dst", np.int32),
                ("p_e_valid", np.int32),
                ("p_src_interval", np.int32),
                ("p_dst_interval", np.int32),
                ("p_base_slot", np.int64),
                ("p_u", np.int32),
                ("p_row_offset", np.int64),
            )
        }
        if self.weighted:
            psp["p_weights"] = _Spool(
                os.path.join(self.workdir, "p_weights.spool"), np.float32
            )
        self.packed_spools = psp
        if self.m == 0:
            for s in psp.values():
                s.close()
            return
        flat_offsets = np.zeros(P * P + 1, np.int64)
        np.cumsum(self.counts.ravel(), out=flat_offsets[1:])
        hub_base = np.zeros(P * P, np.int64)
        np.cumsum(self.hub_counts.ravel()[:-1], out=hub_base[1:])

        # Current tile / pending run accumulators (each bounded by T).
        tile: dict[str, list] = {"s": [], "d": [], "g": [], "w": []}
        run: dict[str, list] = {"s": [], "d": [], "g": [], "w": []}
        state = {
            "tile_start": 0, "base_slot": 0, "tile_u": 0, "tile_open": False,
            "run_start": 0,
        }

        def flush_tile():
            e = sum(len(a) for a in tile["s"])
            assert 0 < e <= T
            s_cat = np.concatenate(tile["s"])
            d_cat = np.concatenate(tile["d"])
            g_cat = np.concatenate(tile["g"])
            row_src = np.zeros(T, np.int32)
            row_src[:e] = s_cat
            row_dst = np.zeros(T, np.int32)
            row_dst[:e] = d_cat
            rl = (g_cat - state["base_slot"]).astype(np.int32)
            row_rl = np.zeros(T, np.int32)
            row_rl[:e] = rl
            row_rd = np.full(T, n_pad, np.int32)
            row_rd[rl] = d_cat
            self.ledger.track(
                "tile", s_cat, d_cat, g_cat, row_src, row_dst, row_rl, row_rd
            )
            psp["p_src"].append(row_src)
            psp["p_dst"].append(row_dst)
            psp["p_run_local"].append(row_rl)
            psp["p_run_dst"].append(row_rd)
            if self.weighted:
                w_cat = np.concatenate(tile["w"])
                row_w = np.zeros(T, np.float32)
                row_w[:e] = w_cat
                psp["p_weights"].append(row_w)
            psp["p_e_valid"].append(np.array([e], np.int32))
            psp["p_src_interval"].append(
                np.array([int(s_cat[0]) // isz], np.int32)
            )
            psp["p_dst_interval"].append(
                np.array([int(d_cat[0]) // isz], np.int32)
            )
            psp["p_base_slot"].append(np.array([state["base_slot"]], np.int64))
            psp["p_u"].append(np.array([state["tile_u"]], np.int32))
            psp["p_row_offset"].append(np.array([state["tile_start"]], np.int64))
            self.num_tiles += 1
            for key in tile:
                tile[key] = []
            state["tile_u"] = 0
            state["tile_open"] = False
            self.ledger.drop("tile")

        def close_pending(end_abs: int):
            if not run["s"]:
                return
            if state["tile_open"] and end_abs > state["tile_start"] + T:
                flush_tile()
            if not state["tile_open"]:
                state["tile_open"] = True
                state["tile_start"] = state["run_start"]
                state["base_slot"] = int(run["g"][0][0])
            for key in ("s", "d", "g", "w"):
                tile[key].extend(run[key])
                run[key] = []
            state["tile_u"] += 1

        prev_gslot = None
        for off, s_c, d_c, g_c, w_c in self._iter_flat(flat_offsets, hub_base):
            new_run = np.ones(len(g_c), bool)
            new_run[1:] = g_c[1:] != g_c[:-1]
            if prev_gslot is not None:
                new_run[0] = int(g_c[0]) != prev_gslot
            prev_gslot = int(g_c[-1])
            starts = np.flatnonzero(new_run)
            bounds = np.concatenate([starts, [len(g_c)]])
            if len(starts) == 0 or starts[0] != 0:
                # leading continuation of the pending run
                head = int(bounds[0]) if len(starts) else len(g_c)
                run["s"].append(s_c[:head])
                run["d"].append(d_c[:head])
                run["g"].append(g_c[:head])
                if self.weighted:
                    run["w"].append(w_c[:head])
            for q in range(len(starts)):
                p = int(starts[q])
                close_pending(off + p)
                state["run_start"] = off + p
                hi = int(bounds[q + 1])
                run["s"].append(s_c[p:hi])
                run["d"].append(d_c[p:hi])
                run["g"].append(g_c[p:hi])
                if self.weighted:
                    run["w"].append(w_c[p:hi])
        close_pending(self.m)
        if state["tile_open"]:
            flush_tile()
        for s in psp.values():
            s.close()

    def _iter_flat(self, flat_offsets: np.ndarray, hub_base: np.ndarray):
        """Stream (offset, src, dst, gslot, weights) chunks of the flat spools."""
        paths = self.spools
        step = self.chunk_edges
        with open(paths["src"].path, "rb") as fs, open(
            paths["dst"].path, "rb"
        ) as fd, open(paths["hub_inv_flat"].path, "rb") as fh:
            fw = open(paths["weights"].path, "rb") if self.weighted else None
            try:
                off = 0
                while off < self.m:
                    k = min(step, self.m - off)
                    s_c = np.fromfile(fs, np.int32, k)
                    d_c = np.fromfile(fd, np.int32, k)
                    h_c = np.fromfile(fh, np.int32, k)
                    w_c = np.fromfile(fw, np.float32, k) if fw else None
                    blk = (
                        np.searchsorted(
                            flat_offsets, np.arange(off, off + k), side="right"
                        )
                        - 1
                    )
                    g_c = hub_base[blk] + h_c
                    self.ledger.track("flat_chunk", s_c, d_c, h_c, w_c, blk, g_c)
                    yield off, s_c, d_c, g_c, w_c
                    self.ledger.drop("flat_chunk")
                    off += k
            finally:
                if fw:
                    fw.close()

    # -- assembly ------------------------------------------------------------
    def assemble(self) -> None:
        P, isz, n = self.P, self.interval_size, self.n
        n_pad = P * isz
        w = StoreWriter(self.out_path)

        def addf(name, dt, shape, path):
            return w.add_file(name, dt, shape, path, io_chunk=self.io_chunk)

        try:
            flat_offsets = np.zeros(P * P + 1, np.int64)
            np.cumsum(self.counts.ravel(), out=flat_offsets[1:])
            offsets = np.zeros((P, P + 1), np.int64)
            offsets[:, 0] = flat_offsets[:-1].reshape(P, P)[:, 0]
            offsets[:, 1:] = flat_offsets[1:].reshape(P, P)
            hub_cum = np.zeros(P * P + 1, np.int64)
            np.cumsum(self.hub_counts.ravel(), out=hub_cum[1:])
            hub_offsets = np.zeros((P, P + 1), np.int64)
            hub_offsets[:, 0] = hub_cum[:-1].reshape(P, P)[:, 0]
            hub_offsets[:, 1:] = hub_cum[1:].reshape(P, P)
            out_deg = np.zeros(n_pad, np.int32)
            out_deg[:n] = self.out_deg[:n]
            in_deg = np.zeros(n_pad, np.int32)
            in_deg[:n] = self.in_deg[:n]
            meta = {
                "format": "dsss",
                "version": FORMAT_VERSION,
                "n": n,
                "m": self.m,
                "P": P,
                "interval_size": isz,
                "weighted": self.weighted,
                "src_sorted": False,
                "num_blocks": len(self.blk_dir),
            }
            w.add_array("offsets", offsets)
            w.add_array("hub_offsets", hub_offsets)
            w.add_array("out_degree", out_deg)
            w.add_array("in_degree", in_deg)
            w.add_array("id_to_index", self.uniq)
            self.ledger.add("assembly_io", self.io_chunk)
            addf("src", np.int32, (self.m,), self.spools["src"].path)
            addf("dst", np.int32, (self.m,), self.spools["dst"].path)
            if self.weighted:
                addf(
                    "weights", np.float32, (self.m,), self.spools["weights"].path
                )
            total_hub = int(hub_cum[-1])
            addf(
                "hub_dst_flat", np.int32, (total_hub,),
                self.spools["hub_dst_flat"].path,
            )
            addf(
                "hub_inv_flat", np.int32, (self.m,),
                self.spools["hub_inv_flat"].path,
            )
            nb = len(self.blk_dir)
            dir_cols = list(zip(*self.blk_dir)) if nb else [[]] * 5
            w.add_array("blk_i", np.asarray(dir_cols[0], np.int32))
            w.add_array("blk_j", np.asarray(dir_cols[1], np.int32))
            w.add_array("blk_e", np.asarray(dir_cols[2], np.int64))
            w.add_array("blk_u", np.asarray(dir_cols[3], np.int64))
            w.add_array("blk_ub", np.asarray(dir_cols[4], np.int64))
            buckets = np.array(
                [next_bucket(e) for e in dir_cols[2]], np.int64
            ) if nb else np.zeros(0, np.int64)
            ubs = np.asarray(dir_cols[4], np.int64) if nb else np.zeros(0, np.int64)
            beo = np.zeros(nb, np.int64)
            bho = np.zeros(nb, np.int64)
            if nb:
                np.cumsum(buckets[:-1], out=beo[1:])
                np.cumsum(ubs[:-1], out=bho[1:])
            w.add_array("blk_edge_off", beo)
            w.add_array("blk_hub_off", bho)
            tot_slots = int(buckets.sum())
            tot_ub = int(ubs.sum())
            for name, shape in (
                ("blk_src_local", (tot_slots,)),
                ("blk_dst_local", (tot_slots,)),
                ("blk_hub_inv", (tot_slots,)),
                ("blk_hub_dst", (tot_ub,)),
            ):
                addf(name, np.int32, shape, self.spools[name].path)
            if self.weighted:
                addf(
                    "blk_weights", np.float32, (tot_slots,),
                    self.spools["blk_weights"].path,
                )
            if self.packing is not None:
                meta["packing"] = "adaptive"
                meta["tile_edges"] = self.tile_edges
                meta["num_tiles"] = self.num_tiles
                NT, T = self.num_tiles, self.tile_edges
                for name, dt, shape in (
                    ("p_src", np.int32, (NT, T)),
                    ("p_dst", np.int32, (NT, T)),
                    ("p_run_local", np.int32, (NT, T)),
                    ("p_run_dst", np.int32, (NT, T)),
                ):
                    addf(name, dt, shape, self.packed_spools[name].path)
                if self.weighted:
                    addf(
                        "p_weights", np.float32, (NT, T),
                        self.packed_spools["p_weights"].path,
                    )
                for name, dt, shape in (
                    ("p_e_valid", np.int32, (NT,)),
                    ("p_src_interval", np.int32, (NT,)),
                    ("p_dst_interval", np.int32, (NT,)),
                    ("p_base_slot", np.int64, (NT,)),
                    ("p_u", np.int32, (NT,)),
                    ("p_row_offset", np.int64, (NT,)),
                ):
                    addf(name, dt, shape, self.packed_spools[name].path)
            else:
                meta["packing"] = None
            self.ledger.drop("assembly_io")
            w.close(meta)
        except BaseException:
            w.abort()
            raise

    def run(self) -> BuildStats:
        owns_workdir = self.workdir is None
        if owns_workdir:
            self.workdir = tempfile.mkdtemp(
                prefix=".dsss-build-",
                dir=os.path.dirname(os.path.abspath(self.out_path)) or ".",
            )
        else:
            os.makedirs(self.workdir, exist_ok=True)
        try:
            self.pass_ids()  # also records self.weighted from chunk 1
            self.pass_partition()
            self.pass_merge()
            if self.packing is not None:
                self.pass_packed()
            else:
                self.tile_edges = 0
                self.num_tiles = 0
            self.assemble()
        finally:
            if owns_workdir:
                shutil.rmtree(self.workdir, ignore_errors=True)
        return BuildStats(
            path=self.out_path,
            n=self.n,
            m=self.m,
            m_raw=self.m_raw,
            P=self.P,
            interval_size=self.interval_size,
            num_blocks=len(self.blk_dir),
            chunk_budget=self.chunk_budget,
            chunk_edges=self.chunk_edges,
            num_chunks=self.stats_chunks,
            streamed_buckets=self.streamed_buckets,
            spill_bytes=self.spill_bytes,
            peak_edge_bytes=self.ledger.peak,
            tile_edges=self.tile_edges,
            num_tiles=self.num_tiles,
        )


def build_dsss_file(
    chunks: Callable[[], Iterable],
    out_path: str,
    P: int,
    *,
    chunk_budget: int = 64 << 20,
    drop_self_loops: bool = False,
    dedup: bool = True,
    workdir: str | None = None,
    packing: str | None = "adaptive",
) -> BuildStats:
    """Build a ``.dsss`` container from a re-iterable raw edge stream.

    Args:
      chunks: zero-argument callable returning a fresh iterator of
        ``(src, dst)`` or ``(src, dst, weights)`` array chunks. It is
        invoked multiple times (id pass, partition pass) and must yield
        the same data each time — e.g. ``lambda:
        iter_text_edges("edges.txt")``.
      out_path: destination ``.dsss`` path.
      P: number of vertex intervals.
      chunk_budget: target bytes of resident edge-array state. The
        builder derives its chunk, bucket-load and copy-buffer sizes from
        it and charges every edge-scale allocation to a ledger;
        ``BuildStats.peak_edge_bytes`` stays within ~2× this budget.
      drop_self_loops / dedup: same semantics (and identical results) as
        :func:`repro_torch.graph.preprocess.degree_and_densify`.
      workdir: spill/spool directory (a sibling temp dir by default,
        removed afterwards).
      packing: ``"adaptive"`` stores the PackedSweep tile section with
        exactly the tile size :func:`repro_torch.core.dsss.choose_tile_edges`
        would pick; ``None`` skips it.

    The resulting container is layout-identical to ``write_dsss(
    build_dsss(degree_and_densify(...), P))`` — but peak edge-resident memory is bounded by the
    chunk budget instead of O(m).
    """
    builder = _ExternalBuilder(
        chunks,
        out_path,
        P,
        chunk_budget=chunk_budget,
        drop_self_loops=drop_self_loops,
        dedup=dedup,
        workdir=workdir,
        packing=packing,
    )
    return builder.run()


def build_from_text(
    text_path: str,
    out_path: str,
    P: int,
    *,
    weights: bool = False,
    comment: str = "#",
    id_dtype=np.int64,
    **kwargs,
) -> BuildStats:
    """Front end: chunk-stream a SNAP-style text edge list into a build."""
    from repro_torch.graph.io import iter_text_edges

    chunk_budget = kwargs.get("chunk_budget", 64 << 20)
    chunk_edges = max(1024, int(chunk_budget) // 64)

    def chunks():
        return iter_text_edges(
            text_path,
            comment=comment,
            dtype=id_dtype,
            weights=weights,
            chunk_edges=chunk_edges,
        )

    return build_dsss_file(chunks, out_path, P, **kwargs)
