"""Closed-form slow-tier I/O models, paper Table II (port of ``repro.core.iomodel``).

They drive the adaptive SPU / MPU(Q) / DPU choice and are the oracle the
engine's modelled byte meters reproduce. Pure Python arithmetic, equal to
the JAX package's for the same inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "IOParams",
    "spu_io",
    "dpu_io",
    "mpu_io",
    "mpu_q",
    "select_strategy",
    "StrategyChoice",
    "modelled_io",
    "IOComparison",
    "compare_measured",
    "calibrate_edge_bytes",
    "turbograph_like_io",
    "PACKED_SLOT_BYTES",
    "KERNEL_SLOT_BYTES",
    "packed_h2d_bytes",
    "packed_kernel_h2d_bytes",
    "packed_disk_bytes",
    "disk_read_bytes",
    "selective_streamed_tiles",
    "streamed_block_bytes",
    "selective_edge_bytes",
]


@dataclasses.dataclass(frozen=True)
class IOParams:
    """Byte-size parameters of the I/O model (paper Table I)."""

    n: int  # vertices
    m: int  # edges
    Ba: int = 8  # bytes per vertex attribute
    Bv: int = 4  # bytes per vertex id
    Be: int = 8  # bytes per edge
    d: float = 15.0  # mean in-degree of sub-shard destinations (hub factor)
    P: int = 16  # number of intervals


def spu_io(p: IOParams, B_M: int) -> tuple[float, float]:
    """SPU: read ``m·Be + 2n·Ba − B_M`` clamped to ``[0, m·Be]``; write 0."""
    read = p.m * p.Be + 2 * p.n * p.Ba - B_M
    return float(min(max(read, 0), p.m * p.Be)), 0.0


def dpu_io(p: IOParams, B_M: int = 0) -> tuple[float, float]:
    """DPU: read ``m·Be + m(Ba+Bv)/d + n·Ba``; write ``m(Ba+Bv)/d + n·Ba``."""
    hub = p.m * (p.Ba + p.Bv) / p.d
    return float(p.m * p.Be + hub + p.n * p.Ba), float(hub + p.n * p.Ba)


def mpu_q(p: IOParams, B_M: int) -> int:
    """``Q ≤ B_M / (2·ceil(n/P)·Ba)`` ping-pong-resident intervals."""
    per_interval = 2 * -(-p.n // p.P) * p.Ba
    return max(0, min(p.P, int(B_M // per_interval)))


def mpu_io(p: IOParams, B_M: int, *, continuous: bool = False) -> tuple[float, float]:
    """MPU: Q=P is SPU-like, Q=0 is DPU.

    read  = m·Be + ((P−Q)/P)·n·Ba + ((P−Q)²/P²)·m·(Ba+Bv)/d
    write =        ((P−Q)/P)·n·Ba + ((P−Q)²/P²)·m·(Ba+Bv)/d

    ``continuous=True`` uses the unquantized Q = (B_M/2n·Ba)·P that the
    paper's Fig. 6 comparison assumes (the large-P limit); with integer Q
    and small P, MPU quantizes down to DPU.
    """
    if continuous:
        cold = 1.0 - min(1.0, B_M / max(2 * p.n * p.Ba, 1))
    else:
        cold = (p.P - mpu_q(p, B_M)) / p.P
    hub = cold * cold * p.m * (p.Ba + p.Bv) / p.d
    iv = cold * p.n * p.Ba
    return float(p.m * p.Be + iv + hub), float(iv + hub)


def turbograph_like_io(p: IOParams, B_M: int) -> tuple[float, float]:
    """TurboGraph/GridGraph-style block-load strategy (paper §III-C).

    With the I/O-optimal partitioning ``P* = 2n·Ba/B_M``:
      read  = m·Be + 2(n·Ba)²/B_M + n·Ba
      write = n·Ba
    """
    read = p.m * p.Be + 2 * (p.n * p.Ba) ** 2 / max(B_M, 1) + p.n * p.Ba
    return float(read), float(p.n * p.Ba)


@dataclasses.dataclass(frozen=True)
class StrategyChoice:
    strategy: str  # "spu" | "mpu" | "dpu"
    Q: int
    modelled_read: float
    modelled_write: float

    @property
    def modelled_total(self) -> float:
        return self.modelled_read + self.modelled_write


def modelled_io(p: IOParams, B_M: int | None, strategy: str) -> tuple[float, float]:
    """Closed-form (read, write) for one strategy; ``B_M=None`` is unlimited."""
    if strategy == "spu":
        if B_M is None:
            return 0.0, 0.0
        return spu_io(p, B_M)
    if strategy == "dpu":
        return dpu_io(p)
    if strategy == "mpu":
        return mpu_io(p, B_M if B_M is not None else 0)
    if strategy == "turbograph-like":
        # Its P* term needs a B_M; "unlimited" is both attribute copies fitting.
        return turbograph_like_io(p, B_M if B_M is not None else 2 * p.n * p.Ba)
    raise ValueError(f"no closed form for strategy {strategy!r}")


def select_strategy(
    p: IOParams, B_M: int | None, *, host_B_M: int | None = None
) -> StrategyChoice:
    """SPU when both padded attribute copies fit, else MPU with the largest Q
    (DPU at Q == 0).

    ``host_B_M`` is the disk tier's host RAM budget (a disk-backed
    session passes its ``host_memory_budget``): edge topology that fits
    neither the device pins nor the host cache re-streams from disk every
    sweep, adding ``max(0, m·Be − device_pinned − host_B_M)`` to the
    modelled read. Only SPU pins edges on the device (its budget left
    after both padded attribute copies).
    """
    if B_M is None:
        choice = StrategyChoice("spu", p.P, 0.0, 0.0)
    elif B_M >= 2 * p.P * -(-p.n // p.P) * p.Ba:  # 2 · n_pad · Ba
        r, w = spu_io(p, B_M)
        choice = StrategyChoice("spu", p.P, r, w)
    else:
        Q = mpu_q(p, B_M)
        r, w = mpu_io(p, B_M)
        choice = StrategyChoice("dpu" if Q == 0 else "mpu", Q, r, w)
    if host_B_M is not None:
        pinned = 0
        if choice.strategy == "spu":
            n_pad = p.P * -(-p.n // p.P)
            pinned = p.m * p.Be if B_M is None else max(0, B_M - 2 * n_pad * p.Ba)
        disk = max(0.0, p.m * p.Be - min(pinned, p.m * p.Be) - host_B_M)
        choice = StrategyChoice(
            choice.strategy, choice.Q, choice.modelled_read + disk, choice.modelled_write
        )
    return choice


@dataclasses.dataclass(frozen=True)
class IOComparison:
    """Measured engine meters vs. the Table II closed forms, per iteration.

    ``slack_bytes`` is the discretization slack the measured numbers may
    deviate by (SPU: one sub-shard, since residency is block-granular;
    DPU/MPU: the padded intervals, ``(n_pad − n)·Ba`` a read and a write).
    """

    strategy: str
    modelled_read: float
    modelled_write: float
    measured_read: float
    measured_write: float
    slack_bytes: float

    @property
    def within_slack(self) -> bool:
        return (
            abs(self.measured_read - self.modelled_read) <= self.slack_bytes + 1e-6
            and abs(self.measured_write - self.modelled_write) <= self.slack_bytes + 1e-6
        )


def compare_measured(
    per_iteration_meters, p: IOParams, strategy: str, B_M: int | None, *, slack_bytes: float = 0.0
) -> IOComparison:
    """A run's per-iteration byte meters (``Meters.per_iteration()``) against
    the closed forms."""
    read, write = modelled_io(p, B_M, strategy)
    return IOComparison(
        strategy=strategy,
        modelled_read=read,
        modelled_write=write,
        measured_read=float(per_iteration_meters.bytes_read),
        measured_write=float(per_iteration_meters.bytes_written),
        slack_bytes=float(slack_bytes),
    )


def calibrate_edge_bytes(p: IOParams, meters) -> float:
    """Physical bytes per modelled edge byte, from actual transfers.

    ``p.Be`` scaled by ``meters.bytes_h2d / meters.bytes_read_edges``, the
    measured inflation of what is shipped over the model's ``Be`` an edge;
    ``p.Be`` unchanged when nothing was streamed (device residency).
    """
    if getattr(meters, "bytes_h2d", 0.0) <= 0.0 or meters.bytes_read_edges <= 0.0:
        return float(p.Be)
    return float(p.Be) * meters.bytes_h2d / meters.bytes_read_edges


# Raw bytes per tile edge slot the packed host-streaming path ships under
# execution="packed": four int32 leaves (src, dst, run_local, run_dst),
# plus float32 weights on weighted graphs and one int32 e_valid per tile.
PACKED_SLOT_BYTES = 16

# Raw bytes per tile edge slot of kernel B1's streamed payload under
# execution="packed_kernel": src and dst (int32), plus float32 weights on
# weighted graphs. run_local, run_dst and e_valid stay on the host.
KERNEL_SLOT_BYTES = 8


def packed_h2d_bytes(
    streamed_tiles: int, tile_edges: int, *, weighted: bool = False
) -> float:
    """Closed-form raw host→device bytes per sweep of packed streaming.

    Every streamed tile ships its dense leaves once a sweep:
    ``streamed_tiles · (tile_edges · slot_bytes + 4)``, so the adaptive
    packer's padding is also the physical transfer's padding.
    """
    per_tile = tile_edges * (PACKED_SLOT_BYTES + (4 if weighted else 0)) + 4
    return float(streamed_tiles * per_tile)


def packed_disk_bytes(
    streamed_tiles: int, tile_edges: int, *, weighted: bool = False
) -> float:
    """Closed-form disk-tier bytes per sweep of packed disk streaming.

    A chunk read from the ``.dsss`` file is the JAX package's tile leaves,
    so the volume is :func:`packed_h2d_bytes` over the tiles that are
    neither device-pinned nor host-cached (``num_tiles − pin_tiles −
    host_tiles`` of the session's ``PackedStreamPlan``), whatever the
    execution ships to the device.
    """
    return packed_h2d_bytes(streamed_tiles, tile_edges, weighted=weighted)


def disk_read_bytes(block_nbytes, resident, host_cached, *, active_rows=None) -> float:
    """Closed-form per-sweep disk reads of the per-block disk stream.

    ``block_nbytes`` maps sub-shard ``(i, j)`` to the raw bytes of its
    padded block; a sweep reads each processed block that is neither
    device-pinned (``resident``) nor host-cached (``host_cached``) once.
    ``active_rows`` (a (P,) bitmap) restricts it to the active source
    intervals; ``None`` is a full sweep.
    """
    return float(
        sum(
            b
            for k, b in block_nbytes.items()
            if k not in resident
            and k not in host_cached
            and (active_rows is None or active_rows[k[0]])
        )
    )


def packed_kernel_h2d_bytes(
    streamed_tiles: int,
    tile_edges: int,
    *,
    ranges: int,
    runs: int,
    chunk_rows: int,
    touched: int,
    perm_edges: int = 0,
    weighted: bool = False,
) -> float:
    """Closed-form raw host→device bytes per sweep of kernel B1's stream.

    What the kernel reads of ``ranges`` streamed tile ranges holding
    ``streamed_tiles`` tiles: the padded ``src``/``dst`` (and weights)
    slots, and each range's index — its chunk-table rows (32 B each), one
    run start and one fold-list entry per run (8 B), each touched
    destination's id and CSR offset (8 B, plus one closing offset a
    range), and on ``src_sorted`` layouts the edge permutation (4 B per
    real edge). The counts are sums over the streamed ranges.
    """
    slot = KERNEL_SLOT_BYTES + (4 if weighted else 0)
    return float(
        streamed_tiles * tile_edges * slot
        + 32 * chunk_rows + 8 * runs + 8 * touched + 4 * ranges + 4 * perm_edges
    )


def selective_streamed_tiles(tile_active, pin_tiles: int, chunk_tiles: int) -> int:
    """Streamed tile count of one frontier-aware packed sweep.

    The stream walks the chunk grid ``[lo, lo + chunk_tiles)`` for ``lo`` in
    ``range(pin_tiles, num_tiles, chunk_tiles)`` and skips every chunk that
    holds no active tile; chunks go whole, so the count is the sum of the
    active chunks' sizes.
    """
    act = np.asarray(tile_active, dtype=bool)
    nt = int(act.shape[0])
    streamed = 0
    for lo in range(pin_tiles, nt, chunk_tiles):
        hi = min(lo + chunk_tiles, nt)
        if act[lo:hi].any():
            streamed += hi - lo
    return streamed


def streamed_block_bytes(block_nbytes, resident, active_rows=None) -> float:
    """Closed-form per-sweep ``bytes_h2d`` of the per-block host stream.

    ``block_nbytes`` maps sub-shard ``(i, j)`` to the raw bytes of its
    padded host block; a sweep ships every processed block outside the
    ``resident`` set once. ``active_rows`` (a (P,) bitmap) restricts the
    sweep to the active source intervals; ``None`` is a full sweep.
    """
    return float(
        sum(
            b
            for k, b in block_nbytes.items()
            if k not in resident and (active_rows is None or active_rows[k[0]])
        )
    )


def selective_edge_bytes(block_edges, resident, active_rows, Be) -> float:
    """Modelled edge-byte charge (``Be`` per edge) of one selective sweep.

    ``block_edges`` maps sub-shard ``(i, j)`` to its real edge count; every
    processed block outside ``resident`` is charged. With ``active_rows``
    all True it is the full sweep's ``m·Be`` less the resident set.
    """
    return float(
        sum(
            e * Be
            for k, e in block_edges.items()
            if k not in resident and (active_rows is None or active_rows[k[0]])
        )
    )
