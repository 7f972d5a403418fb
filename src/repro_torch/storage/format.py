"""The ``.dsss`` on-disk container — a memory-mappable DSSS graph store.

Port of ``repro.storage.format``: the same bytes, the same checksums, so a
file written by either package opens in the other. The paper keeps
sub-shards in binary files on disk and streams them through memory (§IV
"streamlined disk access"). This module is that bottom tier: a single
versioned file holding every staged artifact of a
:class:`repro_torch.core.dsss.DSSSGraph` in the exact layout the execution
engine consumes, so a session can *mmap* the file and run without ever
materializing the graph in host RAM:

* **meta arrays** — ``offsets``/``hub_offsets`` tables, padded degree
  arrays, the dense-id reverse mapping;
* **flat edge segments** — ``src``/``dst``(/``weights``) and the hub
  arrays in DSSS streaming order (row-major ``(i, j)``,
  destination-sorted inside each sub-shard) — the fused path and
  re-packing read these;
* **sub-shard block stream + directory** — every non-empty sub-shard's
  *padded* block arrays (``src_local``/``dst_local``/``hub_inv``/
  ``hub_dst``/``weights``, bucket-padded exactly like
  :meth:`~repro_torch.core.dsss.DSSSGraph.padded_subshard`) concatenated in the
  schedules' streaming order, with a per-block segment directory — the
  ``_BlockFetcher`` streams mmap views of these disk→device;
* **the packed sweep** — the adaptive
  :class:`~repro_torch.core.dsss.PackedSweep` tile arrays, so a stored graph
  skips repacking and packed execution streams tile chunks straight from
  the file.

Layout: a fixed 32-byte preamble (magic, version, footer pointer), then
64-byte-aligned binary segments, then a JSON *footer* holding the graph
metadata and the segment directory (name, dtype, shape, offset, nbytes,
crc32 per segment). Writing streams segments first and patches the
preamble last, so the external-memory builder never needs the directory
up front; a truncated or bit-flipped file fails the footer or segment
checksums instead of producing garbage results.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from typing import Any, BinaryIO

import numpy as np

from repro_torch.core.dsss import DSSSGraph, PackedSweep, next_bucket
from repro_torch.graph.preprocess import EdgeList
from repro_torch.obs.registry import REGISTRY as _REGISTRY

_OBS_READ_RETRIES = _REGISTRY.counter(
    "repro_storage_read_retries_total",
    "Checksum-failed segment reads that were retried",
)
_OBS_HEALS = _REGISTRY.counter(
    "repro_storage_heals_total",
    "Segments that verified after at least one failed read",
)
_OBS_QUARANTINES = _REGISTRY.counter(
    "repro_storage_quarantines_total",
    "Segments quarantined after retry exhaustion",
)

__all__ = [
    "MAGIC",
    "FORMAT_VERSION",
    "ChecksumError",
    "DegradedReadError",
    "FormatError",
    "ReadPolicy",
    "Segment",
    "StoreWriter",
    "DSSSStore",
    "open_dsss",
    "write_dsss",
    "verify_dsss",
    "store_info",
]

MAGIC = b"NXGDSSS1"
FORMAT_VERSION = 1
_PREAMBLE = struct.Struct("<8sIQQI")  # magic, version, foot_off, foot_len, foot_crc
_ALIGN = 64
_IO_CHUNK = 1 << 22  # 4 MiB streaming unit for copies / verification


class FormatError(Exception):
    """The file is not a (readable) .dsss container."""


class ChecksumError(FormatError):
    """A segment's stored checksum does not match its bytes."""


class DegradedReadError(FormatError):
    """A segment stayed corrupt through the retry budget and is quarantined.

    Structured: names the exact segment, its byte extent, its tile span
    (packed ``p_*`` segments), and how many read attempts were spent — the
    report an operator (or ``repro_torch.storage verify --repair``) acts
    on. The fetch layer raises this instead of ever returning garbage.
    """

    def __init__(
        self,
        path: str,
        segment: str,
        *,
        offset: int,
        nbytes: int,
        shape: tuple[int, ...],
        attempts: int,
        tile_range: tuple[int, int] | None = None,
    ):
        self.segment = segment
        self.offset = offset
        self.nbytes = nbytes
        self.shape = shape
        self.attempts = attempts
        self.tile_range = tile_range
        span = (
            f", tiles [{tile_range[0]}, {tile_range[1]})"
            if tile_range is not None
            else ""
        )
        super().__init__(
            f"{path}: segment {segment!r} quarantined after {attempts} read "
            f"attempts (bytes [{offset}, {offset + nbytes}){span}); rebuild "
            "it from the raw edge source with "
            "`python -m repro_torch.storage verify --repair --source <edges>`"
        )


@dataclasses.dataclass(frozen=True)
class ReadPolicy:
    """Self-healing read discipline for segment verification.

    A segment whose checksum read fails is re-read up to ``max_retries``
    times with exponential backoff (torn reads heal); a segment still bad
    after the budget is quarantined behind a :class:`DegradedReadError`.
    """

    max_retries: int = 3
    backoff_s: float = 0.001
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}"
            )


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    dtype: str
    shape: tuple[int, ...]
    offset: int
    nbytes: int
    crc32: int

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "offset": self.offset,
            "nbytes": self.nbytes,
            "crc32": self.crc32,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Segment":
        return cls(
            name=d["name"],
            dtype=d["dtype"],
            shape=tuple(int(s) for s in d["shape"]),
            offset=int(d["offset"]),
            nbytes=int(d["nbytes"]),
            crc32=int(d["crc32"]),
        )


def _expected_nbytes(dtype: str, shape: tuple[int, ...]) -> int:
    count = 1
    for s in shape:
        count *= int(s)
    return count * np.dtype(dtype).itemsize


class _SegmentStream:
    """An append-only segment whose length is unknown until closed.

    The external-memory builder writes flat/packed segments in bounded
    pieces; the stream tracks length and a running crc32 so the directory
    entry can be recorded at close time.
    """

    def __init__(self, writer: "StoreWriter", name: str, dtype):
        self._writer = writer
        self.name = name
        self.dtype = np.dtype(dtype)
        self.offset = writer._align()
        self.nbytes = 0
        self.crc = 0
        self.items = 0

    def append(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        buf = arr.view(np.uint8).reshape(-1).data
        self._writer._f.write(buf)
        self.crc = zlib.crc32(buf, self.crc)
        self.nbytes += arr.nbytes
        self.items += arr.size
        self._writer._pos += arr.nbytes

    def close(self, shape: tuple[int, ...] | None = None) -> Segment:
        shape = (self.items,) if shape is None else tuple(int(s) for s in shape)
        if _expected_nbytes(str(self.dtype), shape) != self.nbytes:
            raise FormatError(
                f"segment {self.name!r}: closed with shape {shape} but "
                f"{self.nbytes} bytes were written"
            )
        seg = Segment(
            name=self.name,
            dtype=str(self.dtype),
            shape=shape,
            offset=self.offset,
            nbytes=self.nbytes,
            crc32=self.crc,
        )
        self._writer._record(seg)
        return seg


class StoreWriter:
    """Sequential .dsss writer: segments stream in, directory lands last."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: BinaryIO = open(path, "wb")
        self._f.write(_PREAMBLE.pack(MAGIC, FORMAT_VERSION, 0, 0, 0))
        self._pos = _PREAMBLE.size
        self._segments: list[Segment] = []
        self._names: set[str] = set()
        self._closed = False

    def _align(self) -> int:
        pad = (-self._pos) % _ALIGN
        if pad:
            self._f.write(b"\x00" * pad)
            self._pos += pad
        return self._pos

    def _record(self, seg: Segment) -> None:
        if seg.name in self._names:
            raise FormatError(f"duplicate segment name {seg.name!r}")
        self._names.add(seg.name)
        self._segments.append(seg)

    def add_array(self, name: str, arr: np.ndarray) -> Segment:
        """Write one in-memory (or mmap) array as a segment."""
        arr = np.ascontiguousarray(arr)
        stream = self.stream(name, arr.dtype)
        # Stream in bounded windows so mmap-backed sources never fully
        # materialize (the writer is part of the bounded-RAM pipeline).
        flat = arr.reshape(-1)
        step = max(1, _IO_CHUNK // max(arr.itemsize, 1))
        for lo in range(0, flat.size, step):
            stream.append(flat[lo : lo + step])
        return stream.close(arr.shape)

    def stream(self, name: str, dtype) -> _SegmentStream:
        """Open an append-only segment (close() records it)."""
        return _SegmentStream(self, name, dtype)

    def add_file(
        self,
        name: str,
        dtype,
        shape: tuple[int, ...],
        src_path: str,
        *,
        io_chunk: int = _IO_CHUNK,
    ) -> Segment:
        """Stream a raw spool file (builder temp output) in as a segment.

        ``io_chunk`` bounds the copy window — the external builder passes
        a budget-derived size so assembly stays within its memory ledger.
        """
        stream = self.stream(name, dtype)
        itemsize = np.dtype(dtype).itemsize
        io_chunk = max(itemsize, (io_chunk // itemsize) * itemsize)
        with open(src_path, "rb") as src:
            while True:
                buf = src.read(io_chunk)
                if not buf:
                    break
                if len(buf) % itemsize:
                    raise FormatError(
                        f"spool {src_path!r} is not a whole number of "
                        f"{dtype} items"
                    )
                stream.append(np.frombuffer(buf, dtype=dtype))
        return stream.close(shape)

    def close(self, meta: dict) -> None:
        """Write the JSON footer and patch the preamble pointer."""
        if self._closed:
            return
        foot_off = self._align()
        footer = dict(meta)
        footer["segments"] = [s.to_json() for s in self._segments]
        blob = json.dumps(footer, sort_keys=True).encode("utf-8")
        self._f.write(blob)
        self._f.seek(0)
        self._f.write(
            _PREAMBLE.pack(
                MAGIC, FORMAT_VERSION, foot_off, len(blob), zlib.crc32(blob)
            )
        )
        self._f.flush()
        self._f.close()
        self._closed = True

    def abort(self) -> None:
        if not self._closed:
            self._f.close()
            self._closed = True
            if os.path.exists(self.path):
                os.unlink(self.path)


# ---------------------------------------------------------------------------
# Reader.
# ---------------------------------------------------------------------------
class DSSSStore:
    """An opened .dsss file: metadata + zero-copy mmap views of segments.

    ``array(name)`` returns a read-only :class:`numpy.memmap` of one
    segment; :meth:`graph`, :meth:`host_blocks` and :meth:`packed`
    assemble the engine-facing objects out of those views, so nothing
    edge-scale is resident in host RAM until a page is actually touched.
    """

    def __init__(
        self,
        path: str,
        *,
        verify: bool = False,
        read_policy: ReadPolicy | None = None,
    ):
        self.path = path
        # Self-healing read state: ``read_policy`` turns on
        # verify-on-first-touch (ensure_segment) with bounded re-read;
        # ``quarantined`` remembers segments that stayed bad so every
        # later fetch re-raises the same structured error instantly.
        self.read_policy = read_policy
        self.quarantined: dict[str, DegradedReadError] = {}
        self.healed_reads = 0
        self._verified: set[str] = set()
        self._injector = None
        size = os.path.getsize(path)
        if size < _PREAMBLE.size:
            raise FormatError(f"{path}: too small to be a .dsss file")
        with open(path, "rb") as f:
            magic, version, foot_off, foot_len, foot_crc = _PREAMBLE.unpack(
                f.read(_PREAMBLE.size)
            )
            if magic != MAGIC:
                raise FormatError(f"{path}: bad magic {magic!r}")
            if version != FORMAT_VERSION:
                raise FormatError(
                    f"{path}: unsupported format version {version} "
                    f"(expected {FORMAT_VERSION})"
                )
            if foot_off == 0 or foot_off + foot_len > size:
                raise FormatError(f"{path}: missing or truncated footer")
            f.seek(foot_off)
            blob = f.read(foot_len)
        if zlib.crc32(blob) != foot_crc:
            raise ChecksumError(f"{path}: footer checksum mismatch")
        footer = json.loads(blob.decode("utf-8"))
        self.meta: dict[str, Any] = {
            k: v for k, v in footer.items() if k != "segments"
        }
        self.segments: dict[str, Segment] = {}
        for d in footer["segments"]:
            seg = Segment.from_json(d)
            if seg.offset + seg.nbytes > size:
                raise ChecksumError(
                    f"{path}: segment {seg.name!r} extends past end of file "
                    "(truncated?)"
                )
            if _expected_nbytes(seg.dtype, seg.shape) != seg.nbytes:
                raise FormatError(
                    f"{path}: segment {seg.name!r} shape/nbytes mismatch"
                )
            self.segments[seg.name] = seg
        self._arrays: dict[str, np.ndarray] = {}
        self._graph: DSSSGraph | None = None
        self._blocks: dict[tuple[int, int], dict] | None = None
        self._packed: PackedSweep | None = None
        if verify:
            self.verify()

    # -- raw access ----------------------------------------------------------
    def has(self, name: str) -> bool:
        return name in self.segments

    def array(self, name: str) -> np.ndarray:
        """Read-only view of one segment (mmap; zero-copy, lazily paged)."""
        arr = self._arrays.get(name)
        if arr is None:
            seg = self.segments[name]
            if seg.nbytes == 0:
                arr = np.empty(seg.shape, dtype=np.dtype(seg.dtype))
            else:
                arr = np.memmap(
                    self.path,
                    dtype=np.dtype(seg.dtype),
                    mode="r",
                    offset=seg.offset,
                    shape=seg.shape,
                )
            self._arrays[name] = arr
        return arr

    def attach_faults(self, injector) -> None:
        """Attach (or clear) a :class:`repro_torch.reliability.FaultInjector`.

        The injector's ``storage_read(segment, attempt)`` decisions make
        checksum reads observe corrupt / short bytes — the deterministic
        stand-in for torn reads and bad media the self-healing path is
        tested against. Clearing resets the verified-segment memo so a
        new plan re-exercises the reads.
        """
        self._injector = injector
        self._verified.clear()

    def _checksum_segment(self, seg: Segment, *, attempt: int = 0) -> None:
        """Recompute one segment's checksum — one bounded-chunk read attempt.

        This is the storage fault-injection boundary: an attached injector
        can make this attempt observe a short (truncated) or corrupt
        (crc-perturbed) read. Raises :class:`ChecksumError` on any
        mismatch; never returns bad bytes to a caller.
        """
        decision = (
            self._injector.storage_read(seg.name, attempt)
            if self._injector is not None
            else None
        )
        if decision == "short":
            raise ChecksumError(
                f"{self.path}: segment {seg.name!r} truncated "
                "(injected short read)"
            )
        with open(self.path, "rb") as f:
            f.seek(seg.offset)
            remaining, crc = seg.nbytes, 0
            while remaining:
                buf = f.read(min(_IO_CHUNK, remaining))
                if not buf:
                    raise ChecksumError(
                        f"{self.path}: segment {seg.name!r} truncated"
                    )
                crc = zlib.crc32(buf, crc)
                remaining -= len(buf)
        if decision == "corrupt":
            crc ^= 0xDEADBEEF  # the injected bit flip
        if crc != seg.crc32:
            raise ChecksumError(
                f"{self.path}: segment {seg.name!r} checksum mismatch "
                f"(stored {seg.crc32:#010x}, computed {crc:#010x})"
            )

    def verify(self) -> None:
        """Recompute every segment checksum; raise :class:`ChecksumError`.

        Reads the file sequentially in bounded chunks — verification of an
        out-of-core graph never materializes it.
        """
        for seg in self.segments.values():
            self._checksum_segment(seg)

    def scan(self) -> list[str]:
        """Names of segments whose checksum currently fails (no retries).

        The repair tool's damage report: unlike :meth:`verify` it keeps
        going past the first failure, and unlike :meth:`ensure_segment`
        it neither retries nor quarantines.
        """
        bad = []
        for seg in self.segments.values():
            try:
                self._checksum_segment(seg)
            except ChecksumError:
                bad.append(seg.name)
        return bad

    def ensure_segment(self, name: str) -> None:
        """Verify one segment on first touch, healing torn reads.

        No-op without a :class:`ReadPolicy` (the opt-in) or when the
        segment already verified. A failing checksum read is retried up
        to ``max_retries`` times with exponential backoff —
        ``healed_reads`` counts recoveries; exhaustion quarantines the
        segment and raises the structured :class:`DegradedReadError`
        (re-raised instantly on every later touch).
        """
        policy = self.read_policy
        if policy is None or name in self._verified:
            return
        err = self.quarantined.get(name)
        if err is not None:
            raise err
        seg = self.segments[name]
        attempt = 0
        delay = policy.backoff_s
        while True:
            try:
                self._checksum_segment(seg, attempt=attempt)
            except ChecksumError as exc:
                if attempt >= policy.max_retries:
                    tile_range = (
                        (0, int(seg.shape[0]))
                        if name.startswith("p_") and seg.shape
                        else None
                    )
                    err = DegradedReadError(
                        self.path,
                        name,
                        offset=seg.offset,
                        nbytes=seg.nbytes,
                        shape=seg.shape,
                        attempts=attempt + 1,
                        tile_range=tile_range,
                    )
                    self.quarantined[name] = err
                    _OBS_QUARANTINES.inc()
                    raise err from exc
                _OBS_READ_RETRIES.inc()
                time.sleep(delay)
                delay *= policy.backoff_factor
                attempt += 1
            else:
                if attempt:
                    self.healed_reads += 1
                    _OBS_HEALS.inc()
                self._verified.add(name)
                return

    def ensure_segments(self, names) -> None:
        """:meth:`ensure_segment` over an iterable of segment names."""
        for name in names:
            self.ensure_segment(name)

    # -- engine-facing assembly ---------------------------------------------
    def graph(self) -> DSSSGraph:
        """The mmap-backed :class:`DSSSGraph` (cached; arrays stay views)."""
        if self._graph is None:
            meta = self.meta
            n, m = int(meta["n"]), int(meta["m"])
            out_deg = self.array("out_degree")
            in_deg = self.array("in_degree")
            weights = self.array("weights") if self.has("weights") else None
            edgelist = EdgeList(
                src=self.array("src"),
                dst=self.array("dst"),
                n=n,
                out_degree=out_deg[:n],
                in_degree=in_deg[:n],
                id_to_index=self.array("id_to_index"),
                weights=weights,
            )
            self._graph = DSSSGraph(
                n=n,
                m=m,
                P=int(meta["P"]),
                interval_size=int(meta["interval_size"]),
                src=self.array("src"),
                dst=self.array("dst"),
                weights=weights,
                offsets=np.asarray(self.array("offsets")),
                out_degree=out_deg,
                in_degree=in_deg,
                hub_dst_flat=self.array("hub_dst_flat"),
                hub_inv_flat=self.array("hub_inv_flat"),
                hub_offsets=np.asarray(self.array("hub_offsets")),
                edgelist=edgelist,
                src_sorted=bool(meta["src_sorted"]),
            )
        return self._graph

    def host_blocks(self) -> dict[tuple[int, int], dict]:
        """Padded sub-shard blocks as mmap views — the disk-tier image.

        Leaf-for-leaf identical to
        :meth:`repro_torch.core.dsss.DSSSGraph.host_blocks`, but every array is
        a view into the block stream segments: building this dict
        allocates nothing edge-scale, and a fetch only pages in the block
        actually touched.
        """
        if self._blocks is None:
            bi = self.array("blk_i")
            bj = self.array("blk_j")
            be = self.array("blk_e")
            bu = self.array("blk_u")
            bub = self.array("blk_ub")
            beo = self.array("blk_edge_off")
            bho = self.array("blk_hub_off")
            bsl = self.array("blk_src_local")
            bdl = self.array("blk_dst_local")
            bhi = self.array("blk_hub_inv")
            bhd = self.array("blk_hub_dst")
            bw = self.array("blk_weights") if self.has("blk_weights") else None
            blocks: dict[tuple[int, int], dict] = {}
            for k in range(len(bi)):
                e, u, ub = int(be[k]), int(bu[k]), int(bub[k])
                eo, ho = int(beo[k]), int(bho[k])
                bucket = next_bucket(e)
                blocks[(int(bi[k]), int(bj[k]))] = {
                    "src_local": bsl[eo : eo + bucket],
                    "dst_local": bdl[eo : eo + bucket],
                    "hub_inv": bhi[eo : eo + bucket],
                    "hub_dst": bhd[ho : ho + ub],
                    "e": e,
                    "u": u,
                    "u_bucket": ub,
                    "weights": None if bw is None else bw[eo : eo + bucket],
                }
            self._blocks = blocks
        return self._blocks

    def packed(self) -> PackedSweep | None:
        """The stored :class:`PackedSweep` (mmap leaves), or ``None``."""
        if self.meta.get("packing") is None:
            return None
        if self._packed is None:
            self._packed = PackedSweep(
                mode=str(self.meta["packing"]),
                m=int(self.meta["m"]),
                n_pad=int(self.meta["P"]) * int(self.meta["interval_size"]),
                tile_edges=int(self.meta["tile_edges"]),
                src=self.array("p_src"),
                dst=self.array("p_dst"),
                run_local=self.array("p_run_local"),
                run_dst=self.array("p_run_dst"),
                weights=self.array("p_weights") if self.has("p_weights") else None,
                e_valid=self.array("p_e_valid"),
                src_interval=self.array("p_src_interval"),
                dst_interval=self.array("p_dst_interval"),
                base_slot=self.array("p_base_slot"),
                u=self.array("p_u"),
                row_offset=self.array("p_row_offset"),
                interval_size=int(self.meta["interval_size"]),
            )
        return self._packed


def open_dsss(
    path: str,
    *,
    verify: bool = False,
    read_policy: ReadPolicy | None = None,
) -> DSSSStore:
    """Open a .dsss container (``verify=True`` checks every segment crc).

    ``read_policy`` opts in to self-healing reads: segments verify on
    first touch with bounded re-read + backoff and quarantine behind
    :class:`DegradedReadError` when they stay bad (see
    :meth:`DSSSStore.ensure_segment`).
    """
    return DSSSStore(path, verify=verify, read_policy=read_policy)


def verify_dsss(path: str) -> DSSSStore:
    """Fully verify a container; returns the opened store on success."""
    return DSSSStore(path, verify=True)


def _base_meta(graph: DSSSGraph) -> dict:
    return {
        "format": "dsss",
        "version": FORMAT_VERSION,
        "n": graph.n,
        "m": graph.m,
        "P": graph.P,
        "interval_size": graph.interval_size,
        "weighted": graph.weights is not None,
        "src_sorted": bool(graph.src_sorted),
    }


def _write_blocks(w: StoreWriter, blocks: dict[tuple[int, int], dict]) -> None:
    keys = sorted(blocks)  # row-major (i, j): the schedules' streaming order
    nb = len(keys)
    weighted = any(blocks[k]["weights"] is not None for k in keys)
    bi = np.fromiter((k[0] for k in keys), np.int32, nb)
    bj = np.fromiter((k[1] for k in keys), np.int32, nb)
    be = np.fromiter((blocks[k]["e"] for k in keys), np.int64, nb)
    bu = np.fromiter((blocks[k]["u"] for k in keys), np.int64, nb)
    bub = np.fromiter((blocks[k]["u_bucket"] for k in keys), np.int64, nb)
    buckets = np.fromiter((next_bucket(blocks[k]["e"]) for k in keys), np.int64, nb)
    beo = np.zeros(nb, np.int64)
    np.cumsum(buckets[:-1], out=beo[1:])
    bho = np.zeros(nb, np.int64)
    np.cumsum(bub[:-1], out=bho[1:])
    for name, arr in (
        ("blk_i", bi), ("blk_j", bj), ("blk_e", be), ("blk_u", bu),
        ("blk_ub", bub), ("blk_edge_off", beo), ("blk_hub_off", bho),
    ):
        w.add_array(name, arr)
    for leaf, name in (
        ("src_local", "blk_src_local"),
        ("dst_local", "blk_dst_local"),
        ("hub_inv", "blk_hub_inv"),
    ):
        s = w.stream(name, np.int32)
        for k in keys:
            s.append(blocks[k][leaf])
        s.close()
    s = w.stream("blk_hub_dst", np.int32)
    for k in keys:
        s.append(blocks[k]["hub_dst"])
    s.close()
    if weighted:
        s = w.stream("blk_weights", np.float32)
        for k in keys:
            s.append(blocks[k]["weights"])
        s.close()


def _write_packed(w: StoreWriter, packed: PackedSweep) -> None:
    w.add_array("p_src", packed.src)
    w.add_array("p_dst", packed.dst)
    w.add_array("p_run_local", packed.run_local)
    w.add_array("p_run_dst", packed.run_dst)
    if packed.weights is not None:
        w.add_array("p_weights", packed.weights)
    w.add_array("p_e_valid", packed.e_valid)
    w.add_array("p_src_interval", packed.src_interval)
    w.add_array("p_dst_interval", packed.dst_interval)
    w.add_array("p_base_slot", packed.base_slot)
    w.add_array("p_u", packed.u)
    w.add_array("p_row_offset", packed.row_offset)


def write_dsss(graph: DSSSGraph, path: str, *, packing: str = "auto") -> DSSSStore:
    """Serialize an in-memory :class:`DSSSGraph` to a .dsss container.

    ``packing`` selects the stored :class:`PackedSweep` layout
    (``"auto"`` → adaptive, or subshard for ``src_sorted`` graphs);
    ``packing=None`` skips the packed section. The external-memory
    builder (:mod:`repro_torch.storage.build`) produces byte-identical segment
    *contents* without ever holding the graph — this writer is the
    in-memory reference (and the small-graph convenience path).
    """
    if packing == "auto":
        packing = "subshard" if graph.src_sorted else "adaptive"
    w = StoreWriter(path)
    try:
        meta = _base_meta(graph)
        w.add_array("offsets", graph.offsets)
        w.add_array("hub_offsets", graph.hub_offsets)
        w.add_array("out_degree", graph.out_degree)
        w.add_array("in_degree", graph.in_degree)
        w.add_array("id_to_index", np.asarray(graph.edgelist.id_to_index, np.int64))
        w.add_array("src", graph.src)
        w.add_array("dst", graph.dst)
        if graph.weights is not None:
            w.add_array("weights", graph.weights)
        w.add_array("hub_dst_flat", graph.hub_dst_flat)
        w.add_array("hub_inv_flat", graph.hub_inv_flat)
        blocks = graph.host_blocks()
        meta["num_blocks"] = len(blocks)
        _write_blocks(w, blocks)
        if packing is not None:
            packed = graph.packed_sweep(packing)
            meta["packing"] = packed.mode
            meta["tile_edges"] = packed.tile_edges
            meta["num_tiles"] = packed.num_tiles
            _write_packed(w, packed)
        else:
            meta["packing"] = None
        w.close(meta)
    except BaseException:
        w.abort()
        raise
    return DSSSStore(path)


def store_info(path: str) -> dict:
    """Human-facing summary of a container (the CLI ``info`` command)."""
    store = DSSSStore(path)
    total = sum(s.nbytes for s in store.segments.values())
    return {
        "path": path,
        "file_bytes": os.path.getsize(path),
        "segment_bytes": total,
        "meta": dict(store.meta),
        "segments": [
            {
                "name": s.name,
                "dtype": s.dtype,
                "shape": list(s.shape),
                "nbytes": s.nbytes,
            }
            for s in store.segments.values()
        ],
    }
