"""GraphSession — stage the graph once, run many plans (port of ``repro.core.session``).

A :class:`GraphSession` stages its graph once and executes any number of
:class:`repro_torch.core.plan.ExecutionPlan` jobs against it; ``run_batch``
fuses K compatible plans into one sweep sequence whose tensors carry a
leading ``(K,)`` query axis.

Three residencies, the ``residency`` axis:

* ``"device"``: what a run needs is uploaded to the card once, and the
  memory budget only shapes the modelled meters.
* ``"host"`` (and ``"auto"`` with a ``memory_budget``): the budget is
  enforced. The edge topology it pins goes to the card once; the rest
  stays in page-locked host memory and is copied host→device every sweep,
  in the sweep's order, two units in flight (:mod:`repro_torch.core.
  streaming`), each copy charged to ``Meters.bytes_h2d``. The packed
  paths stream tile chunks (:meth:`GraphSession.packed_stream_plan`,
  :func:`_packed_host_sweep`), the per-block path sub-shard blocks
  (:class:`_BlockFetcher`). Results and model meters equal device
  residency's bit for bit.
* ``"disk"`` (and ``"auto"`` for a session opened from a ``.dsss`` file
  with :meth:`GraphSession.open`): the same streams, read from the file's
  read-only mmap views (:mod:`repro_torch.storage`). The
  ``host_memory_budget`` keeps a window of the stream in host memory
  after the device pins (page-locked, built once); everything else is
  read from the file every sweep, charged to ``Meters.bytes_disk_read``
  where it is read, and laid straight into a page-locked slot of the
  copy ring. Nothing edge-scale is held in host memory outside that
  window and the two slots.

Three execution paths, the ``execution`` axis:

* ``"packed_kernel"`` (and ``"auto"``, which resolves to it for SPU, DPU
  and MPU): each update sweep (:func:`_iteration_packed`) computes the
  per-query globals, one ⊕-accumulator init, the tile sweep over the
  :class:`repro_torch.core.dsss.PackedSweep` layout
  (:func:`repro_torch.kernels.packed_sweep.packed_sweep_update` — the CUDA
  kernel on the card, its plain version on the CPU) and one batched apply.
  The numeric pass is the same for every strategy, because the tile order
  folds each destination's runs in ascending source interval, the fold
  order of every schedule; the strategies differ in the slow-tier traffic
  the paper models, which ``_charge_packed_*`` charge to :class:`Meters`
  from the layout's metadata.
* ``"packed"``: the same sweep with the tile sweep's plain PyTorch version
  (:func:`repro_torch.kernels.packed_sweep.packed_sweep_update_ref`) in
  place of the kernel, on the card as on the CPU: the JAX package's XLA
  scan path, run only when named.
* ``"per_block"``: the paper's own schedules, one sub-shard at a time —
  SPU (Algorithm 5, :func:`_iteration_spu`), DPU and MPU (Algorithms 6
  and 7, :func:`_iteration_two_phase`) with their hubs — over the padded
  "shard files" (:meth:`DSSSGraph.host_blocks`), handed out by
  :class:`_BlockFetcher`, which charges the edge bytes. The
  ``"fused"`` strategy (:func:`_iteration_fused`, one whole-graph
  gather-reduce per sweep) always runs here. The block primitives are
  plain PyTorch: float sums are left folds in edge order
  (``torch.segment_reduce`` over ``(e, K)`` data, which folds each segment
  in order on the CPU and on CUDA), never atomics, so per-block and
  packed runs of SPU/DPU/MPU give the same bits.

Selective execution: monotone programs under ``activity="auto"`` skip the
source intervals (per-block) or tiles (packed) that did not change in the
previous sweep; results are bit-identical to full sweeps.

Custom schedules (the baselines of :mod:`repro_torch.core.baselines`) plug
in through :meth:`GraphSession.register_strategy` and run per-block.
:func:`get_session` keeps one staged session per graph object and variant
(the drivers of :mod:`repro_torch.core.algorithms` share it).

Observability (:mod:`repro_torch.obs`): the byte counters
``repro_engine_bytes_total{kind}`` move on the same lines that charge
:class:`Meters` (the physical kinds where the copy is queued or the file
read, the model kinds once a sweep), and a plan's ``trace`` records
staging, sweep and run spans.

Reliability (:mod:`repro_torch.reliability`): a :class:`FaultPlan`
(``fault_plan=`` or :meth:`GraphSession.inject_faults`) fires at the sweep
boundary (crashes), at each host→device copy of streamed topology
(transient faults, retried in place by ``with_transient_retries``; labels
``"chunk:lo"`` and ``"block:i,j"``, the JAX package's) and in the store's
checksum reads. A plan's ``checkpoint`` snapshots the loop state every
``every`` sweeps, and ``run(..., resume_from=)`` continues from one, with
the bits and meters of an uninterrupted run; ``cancel`` is called before
each sweep (the graph server's deadlines).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import streaming
from repro_torch.core.dsss import DSSSGraph, active_tile_mask, tile_source_spans
from repro_torch.core.identities import reduce_identity, segment_fill_value
from repro_torch.core.iomodel import (
    PACKED_SLOT_BYTES,
    IOParams,
    StrategyChoice,
    modelled_io,
    mpu_q,
    select_strategy,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.vertex_programs import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import prepare_from_host_block
from repro_torch.kernels.packed_sweep import (
    RangeSweep,
    _edge_aux,
    packed_sweep_update,
    packed_sweep_update_ref,
    prepare_packed_tiles,
    range_from_leaves,
    run_index,
    tile_ranges,
    write_range,
)
from repro_torch.obs.registry import REGISTRY as _REGISTRY
from repro_torch.obs.trace import TRACER as _TRACER
from repro_torch.reliability.checkpoint import (
    SnapshotError,
    latest_snapshot,
    load_snapshot,
    save_snapshot,
)
from repro_torch.reliability.faults import FaultPlan, with_transient_retries

__all__ = [
    "GraphSession",
    "Meters",
    "MODEL_METER_FIELDS",
    "Result",
    "BatchResult",
    "CompiledPlan",
    "PackedStreamPlan",
    "IdentityLRU",
    "get_session",
    "clear_session_cache",
]

# The modelled Meters fields: identical to the JAX package's for the same
# plan, by contract. wall_seconds and peak_device_graph_bytes are physical.
MODEL_METER_FIELDS = (
    "bytes_read_edges",
    "bytes_read_intervals",
    "bytes_read_hubs",
    "bytes_written_hubs",
    "bytes_written_intervals",
    "iterations",
    "blocks_processed",
    "blocks_skipped",
    "edges_processed",
)

# Observability handles (repro_torch.obs), the JAX package's metric names.
# The byte counter moves on the same lines that charge the matching Meters
# field (h2d and disk_read where the copy is queued or the file read, the
# model kinds once a sweep), so a run's registry deltas equal its meters
# field for field. Each call is one branch under REPRO_OBS=0.
_OBS_BYTES = _REGISTRY.counter(
    "repro_engine_bytes_total",
    "Engine bytes moved/charged, by Meters field (bytes_<kind>)",
    ("kind",),
)
_OBS_H2D = _OBS_BYTES.labels(kind="h2d")
_OBS_DISK = _OBS_BYTES.labels(kind="disk_read")
_OBS_MODEL_BYTES = tuple(
    (f, _OBS_BYTES.labels(kind=f[len("bytes_"):]))
    for f in MODEL_METER_FIELDS
    if f.startswith("bytes_")
)
_OBS_SWEEPS = _REGISTRY.counter("repro_engine_sweeps_total", "Update sweeps executed")
_OBS_RUNS = _REGISTRY.counter(
    "repro_engine_runs_total",
    "Engine runs completed",
    ("program", "strategy", "residency", "execution"),
)
_OBS_PEAK = _REGISTRY.gauge(
    "repro_engine_peak_device_graph_bytes",
    "Device-held topology high-water mark of the last run (model units)",
)
_OBS_DRIFT = _REGISTRY.gauge(
    "repro_iomodel_drift_ratio",
    "Measured/modelled per-iteration slow-tier bytes of the last run with "
    "a Table II closed form (1.0 = the exactness contract holds live)",
    ("direction", "strategy"),
)
# Per-process run ids, linking "sweep" spans to their "run" span.
_RUN_SEQ = itertools.count(1)


@dataclasses.dataclass
class Meters:
    """Slow-tier byte counters (paper Table II, model units) + scheduling stats.

    ``peak_device_graph_bytes`` is the device-held edge topology in model
    units: at device residency, the whole graph; at host residency, the
    pinned set plus the units in flight. ``bytes_h2d`` is physical: the raw
    bytes of every host→device copy of edge topology, charged where the
    copy is queued (0 at device residency). ``bytes_disk_read`` is the raw
    bytes read from the ``.dsss`` file under disk residency, each sweep,
    for every block or tile chunk that is neither device-pinned nor
    host-cached (the JAX package's figure: the page cache may absorb a
    re-read, the meter charges it); 0 at the other residencies.
    """

    bytes_read_edges: float = 0.0
    bytes_read_intervals: float = 0.0
    bytes_read_hubs: float = 0.0
    bytes_written_hubs: float = 0.0
    bytes_written_intervals: float = 0.0
    bytes_h2d: float = 0.0
    bytes_disk_read: float = 0.0
    peak_device_graph_bytes: float = 0.0
    iterations: int = 0
    blocks_processed: int = 0
    blocks_skipped: int = 0
    edges_processed: int = 0
    wall_seconds: float = 0.0

    def model_dict(self) -> dict:
        """The modelled fields only (see :data:`MODEL_METER_FIELDS`)."""
        return {f: getattr(self, f) for f in MODEL_METER_FIELDS}

    @property
    def bytes_read(self) -> float:
        return self.bytes_read_edges + self.bytes_read_intervals + self.bytes_read_hubs

    @property
    def bytes_written(self) -> float:
        return self.bytes_written_hubs + self.bytes_written_intervals

    @property
    def bytes_total(self) -> float:
        return self.bytes_read + self.bytes_written

    def per_iteration(self) -> "Meters":
        """The byte fields divided by ``max(iterations, 1)``; the rest as is."""
        k = max(self.iterations, 1)
        out = dataclasses.replace(self)
        for f in (
            "bytes_read_edges",
            "bytes_read_intervals",
            "bytes_read_hubs",
            "bytes_written_hubs",
            "bytes_written_intervals",
            "bytes_h2d",
            "bytes_disk_read",
        ):
            setattr(out, f, getattr(self, f) / k)
        return out

    def mteps(self) -> float:
        """Million traversed edges per second."""
        if self.wall_seconds <= 0:
            return float("nan")
        return self.edges_processed / self.wall_seconds / 1e6

    def merge(self, other: "Meters") -> "Meters":
        """Accumulate another run's counters (peak takes the max)."""
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            setattr(
                self, f.name,
                max(a, b) if f.name == "peak_device_graph_bytes" else a + b,
            )
        return self


@dataclasses.dataclass
class Result:
    attrs: np.ndarray
    output: Any
    iterations: int
    converged: bool
    meters: Meters
    strategy: StrategyChoice
    # One (P,) bool array per executed sweep: the source intervals that
    # sweep processed (union over the batch).
    activity_log: tuple = ()


@dataclasses.dataclass
class BatchResult:
    """K plans executed in one sweep sequence (or sequentially, ``fused=False``)."""

    results: list[Result]
    meters: Meters
    iterations: int
    converged: bool
    fused: bool
    activity_log: tuple = ()

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, m: int) -> Result:
        return self.results[m]


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """A plan resolved against one session: strategy, resident set, modes.

    ``resident`` is the set of sub-shards the memory budget pins in the
    fast tier; at device residency it drives the modelled meters only, at
    host and disk residency the per-block path pins exactly these blocks.
    ``host_cached`` is the disk tier's middle level: the sub-shards the
    ``host_memory_budget`` keeps in host memory, whose fetches charge no
    ``bytes_disk_read`` (empty except under ``"disk"``).
    """

    params: IOParams
    choice: StrategyChoice
    resident: frozenset
    residency: str = "device"
    host_cached: frozenset = frozenset()
    execution: str = "packed_kernel"
    # "selective" iff the program is monotone and activity != "off".
    activity: str = "off"


@dataclasses.dataclass(frozen=True)
class PackedStreamPlan:
    """How the packed paths place tiles under host residency.

    ``pin_tiles`` leading tiles stay on the card (SPU pins what the budget
    leaves after both attribute copies; DPU/MPU pin nothing, since their
    model streams every edge); the other tiles go up every sweep in chunks
    of ``chunk_tiles``, two in flight, so the device topology peaks at the
    pinned prefix plus two chunks (``max_chunk_model_bytes`` each).
    ``host_tiles`` is the disk tier's host-cached level (0 except for a
    disk-backed session): the chunk-aligned tiles right after the pinned
    prefix that the ``host_memory_budget`` keeps in host memory; their
    chunks charge ``bytes_h2d`` but not ``bytes_disk_read``, and every
    tile past ``pin_tiles + host_tiles`` is read from the file each sweep.
    Field for field the JAX package's plan for the same session.
    """

    pin_tiles: int
    chunk_tiles: int
    num_tiles: int
    tile_edges: int
    pin_model_bytes: float  # real-edge model bytes of the pinned prefix
    max_chunk_model_bytes: float  # largest streamed chunk, model units
    host_tiles: int = 0


@dataclasses.dataclass
class _RunContext:
    session: "GraphSession"
    program: VertexProgram
    choice: StrategyChoice
    resident: frozenset
    params: IOParams
    aux: dict
    aux_views: list[dict]  # all P interval views of aux, sliced once per run
    valid: torch.Tensor  # (P, isz) bool
    tol: torch.Tensor
    K: int
    fetcher: "_BlockFetcher" = None  # type: ignore[assignment]
    activity: str = "off"
    aux_batched: bool = False
    execution: str = "packed_kernel"
    residency: str = "device"

    @property
    def block_keys(self) -> frozenset:
        return self.session.block_keys


def _rows_to_process(ctx: _RunContext, active: np.ndarray) -> list[int]:
    """Selective runs skip source intervals inactive for every query."""
    P = ctx.session.graph.P
    if ctx.activity == "selective":
        return [i for i in range(P) if active[:, i].any()]
    return list(range(P))


def _apply_all_impl(
    program: VertexProgram,
    old: torch.Tensor,  # (K, P, isz)
    acc: torch.Tensor,  # (K, P, isz)
    aux: dict,
    globals_: dict,  # (K,) leaves
    valid: torch.Tensor,  # (P, isz) bool
    tol: torch.Tensor,
    aux_batched: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All P interval applies of a sweep, for all K queries at once.

    The JAX package's vmap over queries and intervals, written out as
    broadcasting over the leading ``(K, P)`` axes. Returns the new
    attributes and the ``(K, P)`` changed-interval map.
    """
    K, P, isz = old.shape
    vertex_ndim = 2 if aux_batched else 1
    aux2 = {}
    for k, v in aux.items():
        if v.ndim == vertex_ndim:
            aux2[k] = v.reshape(*v.shape[:-1], P, isz)
        else:  # scalar: 0-d shared, (K,) batched
            aux2[k] = v.reshape(-1, 1, 1) if aux_batched else v
    gl = {k: v.reshape(K, 1, 1) for k, v in globals_.items()}
    new = program.apply(old, acc, aux2, gl)
    new = torch.where(valid, new, old)
    changed = (program.changed(old, new, tol) & valid).any(dim=-1)
    return new, changed


# ---------------------------------------------------------------------------
# Block primitives of the per-block path, batched over the leading (K,)
# query axis. Block index arrays are query-invariant; attributes and
# accumulators carry K; aux interval views are shared (vertex leaves
# (isz,), scalars 0-d) or, with ``aux_batched``, carry their own leading K.
# A block holds only its e real edges (see _device_block), so no edge needs
# masking to the ⊕-identity as the JAX package's bucket padding does.
# ---------------------------------------------------------------------------
def _pre_iteration(program: VertexProgram, attrs_flat, aux: dict):
    """Per-query iteration globals (e.g. PageRank's dangling mass), (K,) leaves.

    The programs reduce over the last axis, so shared ``(n_pad,)`` and
    batched ``(K, n_pad)`` aux leaves both broadcast against ``(K, n_pad)``.
    Each query's row is reduced on its own: a reduction's split over the
    card's blocks depends on how many rows it has, so a fused batch's
    float sums would round apart from the same query run alone.
    """
    K = attrs_flat.shape[0]
    if K == 1:
        return program.pre_iteration(attrs_flat, aux)
    rows = [
        program.pre_iteration(
            attrs_flat[k:k + 1],
            {n: (v[k:k + 1] if v.dim() == 2 else v) for n, v in aux.items()},
        )
        for k in range(K)
    ]
    return {n: torch.cat([r[n] for r in rows]) for n in rows[0]}


def _edge_contrib(program, prev_src, src_view, dst_view, blk, has_weights, aux_batched):
    """(K, e) gather contributions of one block's edges, in edge order."""
    src = blk["src_local"]
    vals = prev_src.index_select(-1, src)
    d_aux = (
        _edge_aux(dst_view, aux_batched, blk["dst_local"])
        if program.needs_dst_aux
        else None
    )
    return program.gather(
        vals, blk["weights"] if has_weights else None,
        _edge_aux(src_view, aux_batched, src), d_aux,
    )


def _ordered_reduce(
    contrib: torch.Tensor,  # (K, e)
    reduce: str,
    index: torch.Tensor,  # (e,) output column of each edge
    size: int,
    fill,
    lengths: torch.Tensor,  # (size,) edges per output column
    order: torch.Tensor | None = None,  # stable sort of the edges by index
) -> torch.Tensor:
    """(K, size) ⊕ of the edges grouped by ``index``; the one reduction
    policy of the per-block and fused paths.

    A float sum is a left fold from 0 in edge order: ``segment_reduce``
    over ``(e, K)`` data folds each segment sequentially (its 1-D form does
    not on CUDA), on edges grouped by column, already or through ``order``.
    Never ``index_add_``/``scatter_add_``, whose atomics fold in any order.
    min/max, and sums of integers, are exact in any order and scatter into
    ``fill``.
    """
    if reduce == "sum" and contrib.dtype.is_floating_point:
        if order is not None:
            contrib = contrib.index_select(1, order)
        return torch.segment_reduce(contrib.T, "sum", lengths=lengths, axis=0, unsafe=True).T
    K = contrib.shape[0]
    out = torch.full((K, size), fill, dtype=contrib.dtype, device=contrib.device)
    how = {"sum": "sum", "min": "amin", "max": "amax"}[reduce]
    return out.scatter_reduce_(1, index.expand(K, -1), contrib, how)


def _hub_fold(program, contrib: torch.Tensor, blk: dict) -> torch.Tensor:
    """(K, u) ⊕ of each hub slot's edges (one slot per block destination)."""
    return _ordered_reduce(
        contrib, program.reduce, blk["hub_inv"], blk["u"],
        reduce_identity(program.reduce, contrib.dtype).item(),
        blk["seg_lengths"], blk["seg_order"],
    )


def _block_from_hub(program, acc: torch.Tensor, hub_dst: torch.Tensor, partial: torch.Tensor):
    """FromHub (paper Alg. 6 line 11): fold one hub into ``acc``, in place.

    ``hub_dst`` holds distinct destinations, so the write is conflict-free.
    Only the hub's destinations are touched: elsewhere the JAX package adds
    the identity, which leaves an accumulator that started at ``+0.0``
    bitwise unchanged.
    """
    cur = acc.index_select(1, hub_dst)
    p = partial.to(acc.dtype)
    if program.reduce == "sum":
        new = cur + p
    elif program.reduce == "min":
        new = torch.minimum(cur, p)
    else:
        new = torch.maximum(cur, p)
    return acc.index_copy_(1, hub_dst, new)


def _block_to_hub(program, prev_src, src_view, dst_view, blk, has_weights, aux_batched=False):
    """ToHub (paper Alg. 6 line 4): partial ⊕ per unique destination, (K, u)."""
    contrib = _edge_contrib(program, prev_src, src_view, dst_view, blk, has_weights, aux_batched)
    return _hub_fold(program, contrib, blk)


def _block_gather_reduce(
    program, prev_src, src_view, dst_view, blk, acc, has_weights, aux_batched=False
):
    """UpdateInMemory: fold one block's edges into the (K, isz) ``acc``, in place.

    The destination-grouped fold of the JAX package's ``segment_*``
    followed by ``acc ⊕ red``: a block's hub partials are its direct
    partials, since destination sorting gives both the same fold order.
    """
    partial = _block_to_hub(program, prev_src, src_view, dst_view, blk, has_weights, aux_batched)
    return _block_from_hub(program, acc, blk["hub_dst"], partial)


def _apply_interval(
    program: VertexProgram,
    old: torch.Tensor,  # (K, isz)
    acc: torch.Tensor,  # (K, isz)
    aux_view: dict,  # the interval's aux view
    globals_: dict,  # (K,) leaves
    valid: torch.Tensor,  # (isz,) bool
    tol: torch.Tensor,
    aux_batched: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One interval's apply for all K queries: new attrs and (K,) changed."""
    aux2 = {
        k: (v.reshape(-1, 1) if aux_batched and v.ndim == 1 else v)
        for k, v in aux_view.items()
    }
    gl = {k: v.reshape(-1, 1) for k, v in globals_.items()}
    new = program.apply(old, acc, aux2, gl)
    new = torch.where(valid, new, old)
    changed = (program.changed(old, new, tol) & valid).any(dim=-1)
    return new, changed


def _fused_iteration(
    program: VertexProgram,
    attrs: torch.Tensor,  # (K, n_pad)
    aux: dict,
    fused: dict,  # GraphSession.fused_arrays()
    valid: torch.Tensor,  # (P, isz) bool
    tol: torch.Tensor,
    has_weights: bool,
    aux_batched: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole-graph gather-reduce and apply; returns new attrs and (K, P) changed.

    The staged edges are stably sorted by destination, so a float sum folds
    each destination's edges in the flat DSSS order from 0, as the JAX
    package's ``segment_sum`` does.
    """
    K, n_pad = attrs.shape
    P, isz = valid.shape
    globals_ = _pre_iteration(program, attrs, aux)
    src, dst = fused["src"], fused["dst"]
    contrib = program.gather(
        attrs.index_select(1, src),
        fused["weights"] if has_weights else None,
        _edge_aux(aux, aux_batched, src),
        _edge_aux(aux, aux_batched, dst) if program.needs_dst_aux else None,
    )
    red = _ordered_reduce(
        contrib, program.reduce, dst, n_pad,
        segment_fill_value(program.reduce, contrib.dtype).item(), fused["lengths"],
    )
    red = red.to(attrs.dtype).reshape(K, P, isz)
    new, changed = _apply_all_impl(
        program, attrs.reshape(K, P, isz), red, aux, globals_, valid, tol, aux_batched
    )
    return new, changed


# ---------------------------------------------------------------------------
# Per-block schedules (paper §III-B). Each takes (ctx, attrs (K, P, isz),
# active (K, P) numpy, meters) and returns the new attrs and the (K, P)
# numpy map of changed intervals.
# ---------------------------------------------------------------------------
def _new_accumulators(ctx: _RunContext) -> list[torch.Tensor]:
    prog, g = ctx.program, ctx.session.graph
    ident = reduce_identity(prog.reduce, prog.dtype).item()
    return [
        torch.full((ctx.K, g.interval_size), ident, dtype=prog.dtype, device=ctx.session.device)
        for _ in range(g.P)
    ]


def _changed_map(ctx: _RunContext, changed: dict[int, torch.Tensor]) -> np.ndarray:
    """(K, P) numpy map from the applied intervals' (K,) flags, one transfer."""
    active_next = np.zeros((ctx.K, ctx.session.graph.P), dtype=bool)
    if changed:
        cols = list(changed)
        active_next[:, cols] = torch.stack([changed[j] for j in cols], dim=1).cpu().numpy()
    return active_next


def _iteration_spu(ctx: _RunContext, attrs, active, meters: Meters):
    """Paper Algorithm 5: row-major, all intervals ping-pong resident."""
    sess, prog = ctx.session, ctx.program
    g = sess.graph
    K = ctx.K
    globals_ = _pre_iteration(prog, attrs.reshape(K, -1), ctx.aux)
    acc = _new_accumulators(ctx)
    touched = [False] * g.P
    rows = _rows_to_process(ctx, active)
    order = [(i, j) for i in rows for j in range(g.P) if (i, j) in ctx.block_keys]
    fetch = ctx.fetcher.begin(order)
    for i, j in order:
        blk = fetch()
        acc[j] = _block_gather_reduce(
            prog, attrs[:, i], ctx.aux_views[i],
            ctx.aux_views[j] if prog.needs_dst_aux else {},
            blk, acc[j], sess.has_weights, ctx.aux_batched,
        )
        touched[j] = True
        meters.blocks_processed += 1
        meters.edges_processed += blk["e"]
    meters.blocks_skipped += (g.P - len(rows)) * g.P
    new_cols = []
    changed = {}
    for j in range(g.P):
        if not touched[j] and prog.monotone:
            new_cols.append(attrs[:, j])
            continue
        new_j, changed[j] = _apply_interval(
            prog, attrs[:, j], acc[j], ctx.aux_views[j], globals_,
            ctx.valid[j], ctx.tol, ctx.aux_batched,
        )
        new_cols.append(new_j)
    return torch.stack(new_cols, dim=1), _changed_map(ctx, changed)


def _iteration_two_phase(ctx: _RunContext, attrs, active, meters: Meters, Q: int):
    """Paper Algorithms 6 (Q=0: DPU) and 7 (0<Q<P: MPU).

    Intervals < Q are ping-pong resident (SPU-like); intervals >= Q are
    cold: their contributions route through hubs and they are loaded and
    saved once per sweep. Interval and hub bytes are charged per query
    (K×); the edge stream is shared.
    """
    sess, prog = ctx.session, ctx.program
    g = sess.graph
    K = ctx.K
    globals_ = _pre_iteration(prog, attrs.reshape(K, -1), ctx.aux)
    acc = _new_accumulators(ctx)
    touched = [False] * g.P
    # Hub state between the phases: (partial, hub_dst, u). Phase 2 never
    # re-touches an edge block: each sub-shard is fetched once per sweep.
    hubs: dict[tuple[int, int], tuple] = {}
    rows = _rows_to_process(ctx, active)
    iv_bytes = g.interval_size * ctx.params.Ba * K
    hub_bytes = ctx.params.Ba + sess.Bv

    # Every sub-shard is visited once: (j < Q or i >= Q) blocks in the
    # row-major phase, deferred (i < Q, j >= Q) blocks in the column phase.
    phase1 = [
        (i, j)
        for i in rows
        for j in range(g.P)
        if (j < Q or i >= Q) and (i, j) in ctx.block_keys
    ]
    phase2 = [
        (i, j)
        for j in range(g.P)
        if j >= Q
        for i in rows
        if i < Q and (i, j) in ctx.block_keys
    ]
    fetch = ctx.fetcher.begin(phase1 + phase2)

    def _direct(i: int, j: int, blk: dict) -> None:
        """UpdateInMemory (paper Alg. 7 lines 4, 10, 20)."""
        acc[j] = _block_gather_reduce(
            prog, attrs[:, i], ctx.aux_views[i],
            ctx.aux_views[j] if prog.needs_dst_aux else {},
            blk, acc[j], sess.has_weights, ctx.aux_batched,
        )
        touched[j] = True
        meters.blocks_processed += 1
        meters.edges_processed += blk["e"]

    # Phase 1 (row-major): resident rows update resident destinations; cold
    # rows (i >= Q) are loaded once, updating resident destinations
    # directly and cold ones via ToHub. Blocks (i < Q, j >= Q) wait for the
    # column phase, so only one cold accumulator is ever live.
    for i in rows:
        if i >= Q:
            meters.bytes_read_intervals += iv_bytes  # LoadFromDisk(I_i)
        for j in range(g.P):
            if (i, j) not in ctx.block_keys or not (j < Q or i >= Q):
                continue
            blk = fetch()
            if j < Q:
                _direct(i, j, blk)
            else:
                partial = _block_to_hub(
                    prog, attrs[:, i], ctx.aux_views[i],
                    ctx.aux_views[j] if prog.needs_dst_aux else {},
                    blk, sess.has_weights, ctx.aux_batched,
                )
                hubs[(i, j)] = (partial, blk["hub_dst"], blk["u"])
                touched[j] = True
                meters.bytes_written_hubs += blk["u"] * hub_bytes * K
                meters.blocks_processed += 1
                meters.edges_processed += blk["e"]
    meters.blocks_skipped += (g.P - len(rows)) * g.P

    # Phase 2 (column-major): resident columns apply directly; cold columns
    # first take the deferred resident-source blocks, then fold their hubs
    # in ascending source interval, then save (Alg. 6 lines 8-14).
    new_cols: list = [None] * g.P
    changed = {}
    for j in range(g.P):
        if j >= Q:
            for i in rows:
                if i < Q and (i, j) in ctx.block_keys:
                    _direct(i, j, fetch())
            for i in rows:
                h = hubs.get((i, j))
                if h is None:
                    continue
                partial, hub_dst, u = h
                acc[j] = _block_from_hub(prog, acc[j], hub_dst, partial)
                meters.bytes_read_hubs += u * hub_bytes * K
        if not touched[j] and prog.monotone:
            new_cols[j] = attrs[:, j]
            continue
        if j >= Q and prog.monotone:
            # A monotone apply needs the cold interval's previous attributes:
            # one interval read more than the paper's PageRank accounting.
            meters.bytes_read_intervals += iv_bytes
        new_cols[j], changed[j] = _apply_interval(
            prog, attrs[:, j], acc[j], ctx.aux_views[j], globals_,
            ctx.valid[j], ctx.tol, ctx.aux_batched,
        )
        if j >= Q:
            meters.bytes_written_intervals += iv_bytes  # SaveToDisk(I_j)
    return torch.stack(new_cols, dim=1), _changed_map(ctx, changed)


def _iteration_dpu(ctx, attrs, active, meters):
    return _iteration_two_phase(ctx, attrs, active, meters, Q=0)


def _iteration_mpu(ctx, attrs, active, meters):
    return _iteration_two_phase(ctx, attrs, active, meters, Q=ctx.choice.Q)


def _iteration_fused(ctx: _RunContext, attrs, active, meters: Meters):
    """One whole-graph gather-reduce per sweep (every interval, every sweep).

    Equal to SPU up to float-sum association: it folds each destination's
    edges in one run where SPU folds per sub-shard first.
    """
    sess, prog = ctx.session, ctx.program
    g = sess.graph
    K = ctx.K
    new, changed = _fused_iteration(
        prog, attrs.reshape(K, -1), ctx.aux, sess.fused_arrays(), ctx.valid,
        ctx.tol, sess.has_weights, ctx.aux_batched,
    )
    meters.blocks_processed += len(sess.block_keys)
    meters.edges_processed += g.m
    return new, changed.cpu().numpy()


# The per-block schedules by strategy name; GraphSession.register_strategy
# adds custom ones (core/baselines.py registers "turbograph-like").
_STRATEGIES: dict[str, Callable] = {
    "spu": _iteration_spu,
    "dpu": _iteration_dpu,
    "mpu": _iteration_mpu,
    "fused": _iteration_fused,
}


def _charge_packed_spu(ctx: _RunContext, rows: list[int], meters: Meters) -> None:
    """Meter charges of the SPU schedule, from the layout's metadata."""
    sess = ctx.session
    g = sess.graph
    e_blk = sess._staged.block_e
    for i in rows:
        for j in range(g.P):
            if (i, j) not in ctx.block_keys:
                continue
            e = int(e_blk[i, j])
            if (i, j) not in ctx.resident:
                meters.bytes_read_edges += e * sess.Be
            meters.blocks_processed += 1
            meters.edges_processed += e
    meters.blocks_skipped += (g.P - len(rows)) * g.P


def _charge_packed_two_phase(
    ctx: _RunContext, rows: list[int], meters: Meters, Q: int
) -> None:
    """Meter charges of the DPU (Q=0) / MPU schedules, from metadata alone.

    Mirrors the two-phase control flow: phase-1 direct and ToHub blocks,
    deferred phase-2 direct blocks, hub folds, interval load/saves and the
    monotone cold-interval re-read.
    """
    sess, prog = ctx.session, ctx.program
    g = sess.graph
    e_blk, u_blk = sess._staged.block_e, sess._staged.block_u
    Be = sess.Be
    K = ctx.K
    iv_bytes = g.interval_size * ctx.params.Ba * K
    hub_bytes = ctx.params.Ba + sess.Bv
    touched = [False] * g.P
    hub_u: dict[tuple[int, int], int] = {}
    for i in rows:
        if i >= Q:
            meters.bytes_read_intervals += iv_bytes
        for j in range(g.P):
            if (i, j) not in ctx.block_keys or not (j < Q or i >= Q):
                continue
            e = int(e_blk[i, j])
            if (i, j) not in ctx.resident:
                meters.bytes_read_edges += e * Be
            if j >= Q:
                u = int(u_blk[i, j])
                hub_u[(i, j)] = u
                meters.bytes_written_hubs += u * hub_bytes * K
            touched[j] = True
            meters.blocks_processed += 1
            meters.edges_processed += e
    meters.blocks_skipped += (g.P - len(rows)) * g.P
    for j in range(g.P):
        if j >= Q:
            for i in rows:
                if i < Q and (i, j) in ctx.block_keys:
                    e = int(e_blk[i, j])
                    if (i, j) not in ctx.resident:
                        meters.bytes_read_edges += e * Be
                    meters.blocks_processed += 1
                    meters.edges_processed += e
                    touched[j] = True
            for i in rows:
                u = hub_u.get((i, j))
                if u is not None:
                    meters.bytes_read_hubs += u * hub_bytes * K
        if not touched[j] and prog.monotone:
            continue
        if j >= Q and prog.monotone:
            meters.bytes_read_intervals += iv_bytes
        if j >= Q:
            meters.bytes_written_intervals += iv_bytes


def _sweep_tile_slab(ctx: _RunContext, attrs_flat, acc, tiles, row_active, window):
    """Run the tile sweep over the staged tiles, restricted to ``window``.

    ``window=None`` or an all-True window sweeps every tile; otherwise the
    active tiles go to the sweep as an ascending index list (ascending
    keeps the full sweep's fold order), and an all-False window is a no-op.
    ``execution="packed"`` runs the plain version, ``"packed_kernel"`` the
    kernel.
    """
    sess, prog = ctx.session, ctx.program
    sweep = packed_sweep_update_ref if ctx.execution == "packed" else packed_sweep_update
    if window is None or window.all():
        return sweep(
            prog, attrs_flat, acc, ctx.aux, tiles, row_active,
            sess.has_weights, ctx.aux_batched,
        )
    local = np.flatnonzero(window)
    if local.size == 0:
        return acc
    idx = torch.from_numpy(local.astype(np.int32)).to(sess.device)
    return sweep(
        prog, attrs_flat, acc, ctx.aux, tiles, row_active, sess.has_weights,
        ctx.aux_batched, idx, int(local.size),
    )


def _packed_host_sweep(ctx: _RunContext, attrs_flat, acc, row_active, meters: Meters, tile_active):
    """The tile sweep at host residency: a pinned prefix, then streamed chunks.

    The session's :class:`PackedStreamPlan` pins a leading tile prefix on
    the card (:meth:`GraphSession._ensure_packed_pins`), swept first; the
    other tiles are cut into its chunks, copied host→device through the
    session's :class:`~repro_torch.core.streaming.CopyRing` (chunk c+1's
    copy runs while chunk c computes) and swept in ascending order, which
    is the device sweep's fold order, so the bits are device residency's.
    Each streamed chunk charges its raw bytes to ``bytes_h2d`` and its
    real-edge model bytes to the peak (the prefix plus at most two chunks).
    Under selective execution a chunk with no active tile is not copied
    and not charged, and the prefix runs restricted to its active tiles;
    a streamed chunk runs whole (its inactive tiles fold identities).

    ``"packed_kernel"`` ships what kernel B1 reads (tile ranges of
    :func:`repro_torch.kernels.packed_sweep.tile_ranges`: ``src``, ``dst``,
    weights, and each range's run and fold index) and runs
    ``pre_gather`` once and one range launch per slab
    (:class:`~repro_torch.kernels.packed_sweep.RangeSweep`); ``"packed"``
    ships the JAX package's tile leaves and runs the plain tile sweep on
    each chunk, carrying the accumulator.

    ``residency="disk"`` runs the same loop over a :class:`_DiskStream`:
    the chunks of the plan's host-cached window come from page-locked
    payloads built once, every other chunk is read from the file's mmap
    views each sweep (its JAX leaves' bytes charged to
    ``bytes_disk_read``), built into the same payload and laid into a
    page-locked staging slot, from which the ring copies it. So
    ``bytes_h2d`` and the bits are host residency's.
    """
    sess, prog = ctx.session, ctx.program
    dev = sess.device
    splan = sess.packed_stream_plan(ctx.choice.strategy, ctx.params.Ba)
    form = "leaves" if ctx.execution == "packed" else "kernel"
    pins, pin_model = sess._ensure_packed_pins(splan.pin_tiles, form)
    meters.peak_device_graph_bytes = max(meters.peak_device_graph_bytes, pin_model)
    stream, starts = None, []
    if splan.pin_tiles < splan.num_tiles:
        if ctx.residency == "disk":
            stream = sess._disk_stream(splan, form)
        else:
            stream = sess._staged.packed_stream(
                sess.packing, splan.pin_tiles, splan.chunk_tiles, form, dev.type == "cuda"
            )
        starts = [
            c for c, (lo, hi) in enumerate(stream.bounds)
            if tile_active is None or tile_active[lo:hi].any()
        ]
    window = None if tile_active is None else tile_active[: splan.pin_tiles]
    ranges = None
    if form == "kernel":
        max_runs = max(pins[1].runs if pins is not None else 0, stream.max_runs if stream else 0)
        ranges = RangeSweep(
            prog, attrs_flat, ctx.aux, row_active, sess.has_weights, ctx.aux_batched, max_runs
        )
    if pins is not None:
        if form == "leaves":
            acc = _sweep_tile_slab(ctx, attrs_flat, acc, pins, row_active, window)
        elif window is None or window.all():
            ranges.update(acc, *pins)
        elif window.any():
            ranges.update(acc, *pins, torch.from_numpy(window.astype(np.uint8)).to(dev))
    if not starts:
        return acc
    ring = sess._copy_ring(form, stream.max_nbytes)
    ring.begin()
    units = [None] * len(starts)

    def put(n: int) -> None:
        c = starts[n]
        src, units[n], nbytes, slot = stream.fetch(c, meters)
        # The copy is the "h2d" injection point (the JAX package's label:
        # the chunk's first tile). Only the copy is retried, so the disk
        # read and its charge happen once however many retries it takes.
        done = with_transient_retries(
            sess._injector, f"chunk:{stream.bounds[c][0]}", lambda: ring.put(n, src)
        )
        if slot is not None:
            sess._disk_slots().copied(slot, done)
        meters.bytes_h2d += nbytes
        _OBS_H2D.inc(nbytes)

    put(0)
    Be = sess.Be
    for n, c in enumerate(starts):
        if n + 1 < len(starts):
            put(n + 1)
        live = pin_model + stream.edges[c] * Be
        if n + 1 < len(starts):
            live += stream.edges[starts[n + 1]] * Be
        meters.peak_device_graph_bytes = max(meters.peak_device_graph_bytes, float(live))
        buf = ring.take(n)
        if form == "kernel":
            ranges.update(acc, buf, units[n])
        else:
            acc = packed_sweep_update_ref(
                prog, attrs_flat, acc, ctx.aux, streaming.typed_views(buf, units[n]),
                row_active, sess.has_weights, ctx.aux_batched,
            )
        ring.release(n)
    return acc


def _iteration_packed(ctx: _RunContext, attrs, active, meters: Meters):
    """One update sweep for any of SPU/DPU/MPU, ``"packed"`` or ``"packed_kernel"``.

    Meters from metadata → pre-iteration globals → accumulator init → tile
    sweep (compacted to the active tiles under selective execution; at
    host and disk residency, :func:`_packed_host_sweep`) → batched apply. Returns
    the new ``(K, P, isz)`` attrs and the ``(K, P)`` numpy map of changed
    intervals.
    """
    sess, prog = ctx.session, ctx.program
    g = sess.graph
    K = ctx.K
    strategy = ctx.choice.strategy
    rows = _rows_to_process(ctx, active)
    if strategy == "spu":
        _charge_packed_spu(ctx, rows, meters)
    else:
        _charge_packed_two_phase(
            ctx, rows, meters, Q=0 if strategy == "dpu" else ctx.choice.Q
        )
    attrs_flat = attrs.reshape(K, g.n_pad)
    globals_ = _pre_iteration(prog, attrs_flat, ctx.aux)
    ident = reduce_identity(prog.reduce, prog.dtype)
    acc = torch.full((K, g.n_pad), ident.item(), dtype=prog.dtype, device=sess.device)
    row_mask = np.zeros(g.P, dtype=bool)
    row_mask[rows] = True
    row_active = torch.from_numpy(row_mask).to(sess.device)
    selective = ctx.activity == "selective" and not row_mask.all()
    tile_active = sess._packed_tile_activity(row_mask) if selective else None
    if ctx.residency in ("host", "disk"):
        acc = _packed_host_sweep(ctx, attrs_flat, acc, row_active, meters, tile_active)
    else:
        tiles = sess._staged.packed_tiles(sess.packing, sess.device)
        acc = _sweep_tile_slab(ctx, attrs_flat, acc, tiles, row_active, tile_active)
    new, changed = _apply_all_impl(
        prog, attrs, acc.reshape(K, g.P, g.interval_size), ctx.aux, globals_,
        ctx.valid, ctx.tol, aux_batched=ctx.aux_batched,
    )
    return new, changed.cpu().numpy()


def _batch_aux(prog: VertexProgram, g, kwargs_list: list[dict]) -> tuple[dict, bool]:
    """The batch's aux: shared when every query's is identical, else stacked.

    Stacked leaves carry a leading ``(K,)`` query axis (``aux_batched``).
    Aux dicts that cannot be stacked raise :class:`TypeError`.
    """
    aux_list = [prog.make_aux(g, **kw) for kw in kwargs_list]
    aux0 = aux_list[0]
    identical = True
    for aux in aux_list[1:]:
        if set(aux) != set(aux0):
            raise TypeError(
                f"aux-incompatible batch for program {prog.name!r}: queries "
                f"produced different aux keys ({sorted(aux0)} vs "
                f"{sorted(aux)}); run these plans individually"
            )
        for k in aux0:
            a, b = aux[k], aux0[k]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise TypeError(
                    f"aux-incompatible batch for program {prog.name!r}: "
                    f"leaf {k!r} differs in shape/dtype across queries "
                    f"({tuple(b.shape)}/{b.dtype} vs {tuple(a.shape)}/{a.dtype}); "
                    "run these plans individually"
                )
            if identical and not torch.equal(a, b):
                identical = False
    if identical:
        return aux0, False
    return {k: torch.stack([a[k] for a in aux_list]) for k in aux0}, True


def _device_block(host: dict, device: torch.device) -> dict:
    """Upload one padded host block (a "shard file") to ``device``.

    Only the ``e`` real edges and ``u`` hub slots go up: the port runs
    eagerly, so the bucket padding that bounds the JAX package's jit
    variants buys nothing here. Index leaves are int64, as PyTorch's
    scatters want. The block's hub run index rides along: ``seg_lengths``,
    the edges of each hub slot, and ``seg_order``, a stable sort of the
    edges by slot where they are not already grouped (``src_sorted``
    layouts), ``None`` otherwise.
    """
    e, u = host["e"], host["u"]
    hub_inv = host["hub_inv"][:e]
    grouped = bool(np.all(hub_inv[1:] >= hub_inv[:-1]))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return {
        "src_local": up(host["src_local"][:e]),
        "dst_local": up(host["dst_local"][:e]),
        "hub_inv": up(hub_inv),
        "hub_dst": up(host["hub_dst"][:u]),
        "seg_lengths": up(np.bincount(hub_inv, minlength=u)),
        "seg_order": None if grouped else up(np.argsort(hub_inv, kind="stable")),
        "e": e,
        "u": u,
        "weights": (
            None
            if host["weights"] is None
            # A copy: a store's blocks are read-only mmap views.
            else torch.from_numpy(np.array(host["weights"][:e], dtype=np.float32)).to(device)
        ),
    }


def _block_on_device(views: dict, e: int, u: int, grouped: bool) -> dict:
    """The per-block path's block from an uploaded padded block (``views``).

    What :func:`_device_block` does on the host, done on the block's
    device: trim to the ``e`` real edges and ``u`` hub slots, widen the
    indices to int64, count each hub slot's edges (an integer scatter-add,
    exact in any order) and, where the edges are not grouped by slot, sort
    them stably by slot. ``grouped`` is the host's per-block flag, known
    once per staged graph.
    """
    hub_inv = views["hub_inv"][:e].long()
    w = views.get("weights")
    return {
        "src_local": views["src_local"][:e].long(),
        "dst_local": views["dst_local"][:e].long(),
        "hub_inv": hub_inv,
        "hub_dst": views["hub_dst"][:u].long(),
        "seg_lengths": torch.zeros(u, dtype=torch.long, device=hub_inv.device).scatter_add_(
            0, hub_inv, torch.ones_like(hub_inv)
        ),
        "seg_order": None if grouped else torch.argsort(hub_inv, stable=True),
        "e": e,
        "u": u,
        "weights": None if w is None else w[:e],
    }


def _host_block_nbytes(host: dict) -> int:
    """Raw bytes of one padded host block's arrays (what a streamed fetch ships)."""
    total = 0
    for name in ("src_local", "dst_local", "hub_inv", "hub_dst", "weights"):
        arr = host.get(name)
        if arr is not None:
            total += arr.nbytes
    return total


# The arrays of a padded host block that a streamed fetch ships, in order.
_BLOCK_ARRAYS = ("src_local", "dst_local", "hub_inv", "hub_dst", "weights")


@dataclasses.dataclass
class _BlockPayload:
    """One padded host block as a byte payload: one copy host→device."""

    buf: torch.Tensor  # uint8, page-locked on a CUDA session
    sections: dict  # streaming.layout of _BLOCK_ARRAYS
    nbytes: int  # _host_block_nbytes of the block
    e: int
    u: int
    grouped: bool  # edges already grouped by hub slot
    slot: int | None = None  # its HostSlots slot, when read from disk into one


def _block_payload(host: dict, pin_memory: bool, slots: "streaming.HostSlots | None" = None):
    """One padded host block as a :class:`_BlockPayload`.

    In a buffer of its own, or in the next of ``slots`` (a disk read, once
    a sweep).
    """
    arrays = {name: host[name] for name in _BLOCK_ARRAYS}
    sections, nbytes = streaming.layout(arrays)
    if slots is None:
        slot, buf = None, streaming.host_buffer(nbytes, pin_memory)
    else:
        slot, buf = slots.take(nbytes)
    streaming.fill(buf.numpy(), sections, arrays)
    e, u = host["e"], host["u"]
    hub_inv = host["hub_inv"][:e]
    return _BlockPayload(
        buf=buf, sections=sections, nbytes=nbytes, e=e, u=u,
        grouped=bool(np.all(hub_inv[1:] >= hub_inv[:-1])), slot=slot,
    )


@dataclasses.dataclass
class _PackedStream:
    """The streamed tiles of one packed stream plan, staged in host memory once.

    One unit per chunk of the plan's grid (``bounds``), each a byte payload
    in one host buffer, page-locked on a CUDA session: a
    :class:`~repro_torch.kernels.packed_sweep.TileRange` (form
    ``"kernel"``) or the JAX package's tile leaves (form ``"leaves"``,
    ``units`` their :func:`~repro_torch.core.streaming.layout`).
    """

    bounds: list  # (lo, hi) tiles per chunk
    units: list
    nbytes: list  # raw bytes per chunk
    edges: list  # real edges per chunk
    host: list  # per chunk, its uint8 view of the host buffer
    max_nbytes: int
    max_runs: int

    def fetch(self, c: int, meters: Meters) -> tuple:
        """Chunk ``c``: ``(host payload, unit, raw bytes, staging slot or None)``."""
        return self.host[c], self.units[c], self.nbytes[c], None


class _DiskStream:
    """The streamed tiles of a disk-backed session's plan, read every sweep.

    The chunks of the plan's host-cached window (``host_tiles`` after the
    pinned prefix) are built once into page-locked payloads of their own
    (:meth:`GraphSession._packed_ram_chunk`). Every other chunk is read from
    the file's mmap views at each :meth:`fetch`, which charges the JAX
    package's leaves of its tiles to ``bytes_disk_read``, builds B1's
    range operands from those leaves alone (form ``"kernel"``; or lays out
    the leaves, form ``"leaves"``) and writes them into the next of the
    session's two page-locked staging slots. ``max_nbytes`` and
    ``max_runs`` are bounds from the layout's per-tile metadata (a chunk's
    rows, runs and touched destinations are at most its runs), so the
    device ring and the range scratch are sized before any chunk is read.
    """

    def __init__(self, sess: "GraphSession", splan: PackedStreamPlan, form: str):
        self.sess = sess
        self.form = form
        staged = sess._staged
        self.packed = staged.packed_host(sess.packing)
        nt, T = splan.num_tiles, splan.tile_edges
        self.bounds = [
            (lo, min(lo + splan.chunk_tiles, nt))
            for lo in range(splan.pin_tiles, nt, splan.chunk_tiles)
        ]
        self.cache_end = splan.pin_tiles + splan.host_tiles
        e_cum = np.concatenate([[0], np.cumsum(self.packed.e_valid, dtype=np.int64)])
        u_cum = np.concatenate([[0], np.cumsum(self.packed.u, dtype=np.int64)])
        self.edges = [int(e_cum[hi] - e_cum[lo]) for lo, hi in self.bounds]
        w = 4 if sess.has_weights else 0
        self.permuted = False
        if form == "kernel":
            self.permuted = staged.layout_permuted(sess.packing)
            runs = [int(u_cum[hi] - u_cum[lo]) for lo, hi in self.bounds]
            bounds = [
                (hi - lo) * T * (8 + w) + 48 * r + 4 + (4 * e if self.permuted else 0)
                for (lo, hi), r, e in zip(self.bounds, runs, self.edges)
            ]
            self.max_runs = max(runs, default=0)
        else:
            bounds = [(hi - lo) * (T * (PACKED_SLOT_BYTES + w) + 4) for lo, hi in self.bounds]
            self.max_runs = 0
        self.max_nbytes = max(bounds, default=0)

    def build(self, lo: int, hi: int, slots: "streaming.HostSlots | None") -> tuple:
        """Tiles ``[lo, hi)`` read from the file and laid out: ``(buf, unit, nbytes, slot)``.

        Into the next of ``slots``, or a page-locked buffer of its own
        (``slots=None``).
        """
        leaves = _packed_leaves(self.packed, lo, hi)
        if self.form == "kernel":
            unit, arrays = range_from_leaves(
                leaves, lo, interval_size=self.sess.graph.interval_size, permuted=self.permuted
            )
            nbytes, write = unit.nbytes, write_range
        else:
            arrays = leaves
            unit, nbytes = streaming.layout(leaves)
            write = streaming.fill
        if slots is None:
            slot, buf = None, streaming.host_buffer(nbytes, self.sess.device.type == "cuda")
        else:
            slot, buf = slots.take(nbytes)
        write(buf.numpy(), unit, arrays)
        return buf[:nbytes], unit, nbytes, slot

    def fetch(self, c: int, meters: Meters) -> tuple:
        """Chunk ``c``: ``(host payload, unit, raw bytes, staging slot or None)``."""
        lo, hi = self.bounds[c]
        if hi <= self.cache_end:
            return self.sess._packed_ram_chunk(self, lo, hi) + (None,)
        nbytes = sum(a.nbytes for a in _packed_leaves(self.packed, lo, hi).values() if a is not None)
        meters.bytes_disk_read += nbytes
        _OBS_DISK.inc(nbytes)
        return self.build(lo, hi, self.sess._disk_slots())


def _packed_leaves(packed, lo: int, hi: int) -> dict:
    """The JAX package's streamed leaves of tiles [lo, hi) (``_packed_host_chunk``)."""
    return {
        "src": packed.src[lo:hi],
        "dst": packed.dst[lo:hi],
        "run_local": packed.run_local[lo:hi],
        "run_dst": packed.run_dst[lo:hi],
        "e_valid": packed.e_valid[lo:hi],
        "weights": None if packed.weights is None else packed.weights[lo:hi],
    }


class _StagedGraph:
    """Staged state that is a pure function of the graph (and its store).

    Per-sub-shard edge and hub counts (the meters' metadata); the padded
    host blocks of the per-block path, built at first use so a session that
    only runs packed sweeps never pays for them; per device, their upload
    (:meth:`device_blocks`), the fused path's edge arrays and the staged
    kernel operands; and, per packing mode, the host :class:`PackedSweep`,
    its per-tile source spans, its kernel run index and its device tiles.
    For host residency, in host memory: the blocks as byte payloads
    (:meth:`block_payloads`) and each stream plan's chunks
    (:meth:`packed_stream`), page-locked for a CUDA session.

    With a ``store`` (a :class:`repro_torch.storage.DSSSStore`), the host
    blocks and the host :class:`PackedSweep` of the stored packing are the
    file's read-only mmap views, not built or re-packed, and tile ranges
    are built from each range's own leaves
    (:func:`~repro_torch.kernels.packed_sweep.range_from_leaves`): no
    whole-layout run index is built for them.
    """

    def __init__(self, graph: DSSSGraph, store=None):
        self.graph = graph
        self.store = store
        self.block_e = graph.density_matrix()
        self.block_u = graph.hub_counts()
        self.block_keys = frozenset(
            (int(i), int(j)) for i, j in zip(*np.nonzero(self.block_e))
        )
        self._host_blocks: dict[tuple[int, int], dict] | None = None
        self._device_blocks: dict[torch.device, dict] = {}
        self._packed_host: dict[str, Any] = {}
        self._packed_tiles: dict[tuple[str, torch.device], dict] = {}
        self._packed_spans: dict[str, tuple] = {}
        self._packed_index: dict[str, dict] = {}
        self._packed_streams: dict[tuple, _PackedStream] = {}
        self._packed_prefixes: dict[tuple, tuple] = {}
        self._permuted: dict[str, bool] = {}
        self._block_payloads: dict[bool, dict] = {}
        self.fused: dict[torch.device, dict] = {}
        self.kernel_operands: dict[tuple, tuple] = {}

    @property
    def host_blocks(self) -> dict[tuple[int, int], dict]:
        """The padded numpy "shard files", built once at first use (a store's mmap views)."""
        if self._host_blocks is None:
            if self.store is not None:
                self._host_blocks = self.store.host_blocks()
            else:
                self._host_blocks = self.graph.host_blocks()
        return self._host_blocks

    def device_blocks(self, device: torch.device) -> dict[tuple[int, int], dict]:
        """Every host block uploaded to ``device``, once per device."""
        blocks = self._device_blocks.get(device)
        if blocks is None:
            with _TRACER.span("stage_device_blocks", cat="staging", blocks=len(self.block_keys)):
                blocks = {
                    key: _device_block(host, device)
                    for key, host in self.host_blocks.items()
                }
            self._device_blocks[device] = blocks
        return blocks

    def packed_host(self, mode: str):
        """The host-side :class:`PackedSweep`, built once per mode.

        A store's packed section when its mode matches (mmap views, not
        re-packed); otherwise packed from the graph's (maybe mmap) arrays.
        """
        packed = self._packed_host.get(mode)
        if packed is None:
            stored = self.store.packed() if self.store is not None else None
            if stored is not None and stored.mode == mode:
                packed = stored
            else:
                with _TRACER.span("stage_packed_host", cat="staging", mode=mode):
                    packed = self.graph.packed_sweep(mode)
            self._packed_host[mode] = packed
        return packed

    def packed_tiles(self, mode: str, device: torch.device) -> dict:
        """Device tile leaves and run index of one layout, uploaded once."""
        tiles = self._packed_tiles.get((mode, device))
        if tiles is None:
            packed = self.packed_host(mode)
            with _TRACER.span(
                "stage_packed_tiles", cat="staging", mode=mode, tiles=int(packed.num_tiles)
            ):
                tiles = prepare_packed_tiles(
                    packed, has_weights=packed.weights is not None, device=device,
                    index=self.packed_run_index(mode),
                )
            self._packed_tiles[(mode, device)] = tiles
        return tiles

    def packed_spans(self, mode: str) -> tuple:
        """Per-tile inclusive source-interval spans, computed once."""
        spans = self._packed_spans.get(mode)
        if spans is None:
            spans = tile_source_spans(self.packed_host(mode), self.graph.interval_size)
            self._packed_spans[mode] = spans
        return spans

    def packed_run_index(self, mode: str) -> dict:
        """Kernel B1's host run index of one layout, computed once."""
        index = self._packed_index.get(mode)
        if index is None:
            index = self._packed_index[mode] = run_index(self.packed_host(mode))
        return index

    def layout_permuted(self, mode: str) -> bool:
        """Does the layout's run index carry ``perm`` (non-contiguous runs)?

        From the run index where one is built; else scanned in bounded tile
        ranges, and only for a ``src_sorted`` graph: a destination-sorted
        layout's runs are contiguous by construction.
        """
        flag = self._permuted.get(mode)
        if flag is None:
            if mode in self._packed_index:
                flag = "perm" in self._packed_index[mode]
            elif not self.graph.src_sorted:
                flag = False
            else:
                packed = self.packed_host(mode)
                T = packed.tile_edges
                step = max(1, (1 << 22) // max(T, 1))
                flag = False
                for lo in range(0, packed.num_tiles, step):
                    rl = np.asarray(packed.run_local[lo:lo + step])
                    valid = np.arange(T)[None, :] < packed.e_valid[lo:lo + step, None]
                    if np.any((rl[:, 1:] < rl[:, :-1]) & valid[:, 1:]):
                        flag = True
                        break
            self._permuted[mode] = flag
        return flag

    def range_units(self, mode: str, bounds: list, run_tile: bool = False) -> list:
        """Kernel B1's ``(TileRange, arrays)`` of tile ranges ``bounds``.

        From the whole layout's run index (:func:`tile_ranges`), or, for a
        store, from each range's own leaves (:func:`range_from_leaves`):
        the same arrays.
        """
        packed = self.packed_host(mode)
        if self.store is None:
            return tile_ranges(packed, bounds, index=self.packed_run_index(mode), run_tile=run_tile)
        permuted = self.layout_permuted(mode)
        return [
            range_from_leaves(
                _packed_leaves(packed, lo, hi), lo, interval_size=self.graph.interval_size,
                permuted=permuted, run_tile=run_tile,
            )
            for lo, hi in bounds
        ]

    def _stage_units(self, mode: str, bounds: list, form: str, pin_memory: bool, run_tile=False):
        """Tile ranges ``bounds`` as back-to-back payloads of one host buffer.

        Returns ``(buffer, units, sizes, offsets)``: per range a
        :class:`~repro_torch.kernels.packed_sweep.TileRange` (form
        ``"kernel"``, with ``run_tile`` if asked) or the layout of the JAX
        package's tile leaves (form ``"leaves"``).
        """
        packed = self.packed_host(mode)
        if form == "kernel":
            items = self.range_units(mode, bounds, run_tile)
            sizes = [unit.nbytes for unit, _ in items]
            write = write_range
        else:
            items, sizes = [], []
            for lo, hi in bounds:
                arrays = _packed_leaves(packed, lo, hi)
                sections, nbytes = streaming.layout(arrays)
                items.append((sections, arrays))
                sizes.append(nbytes)
            write = streaming.fill
        offsets = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).tolist()
        buf = streaming.host_buffer(offsets[-1], pin_memory)
        view = buf.numpy()
        for (unit, arrays), off, n in zip(items, offsets, sizes):
            write(view[off:off + n], unit, arrays)
        return buf, [unit for unit, _ in items], sizes, offsets

    def packed_stream(
        self, mode: str, pin_tiles: int, chunk_tiles: int, form: str, pin_memory: bool
    ) -> _PackedStream:
        """The tiles past ``pin_tiles``, cut every ``chunk_tiles``, staged once per form."""
        key = (mode, pin_tiles, chunk_tiles, form, pin_memory)
        stream = self._packed_streams.get(key)
        if stream is None:
            packed = self.packed_host(mode)
            nt = packed.num_tiles
            bounds = [(lo, min(lo + chunk_tiles, nt)) for lo in range(pin_tiles, nt, chunk_tiles)]
            buf, units, sizes, offsets = self._stage_units(mode, bounds, form, pin_memory)
            stream = self._packed_streams[key] = _PackedStream(
                bounds=bounds,
                units=units,
                nbytes=sizes,
                edges=[int(packed.e_valid[lo:hi].sum()) for lo, hi in bounds],
                host=[buf[off:off + n] for off, n in zip(offsets, sizes)],
                max_nbytes=max(sizes, default=0),
                max_runs=max((u.runs for u in units), default=0) if form == "kernel" else 0,
            )
        return stream

    def packed_prefix(self, mode: str, pin_tiles: int, form: str, pin_memory: bool) -> tuple:
        """The leading ``pin_tiles`` tiles as one host payload, built once per form.

        ``(buffer, unit, nbytes)``; the ``"kernel"`` form's range carries
        ``run_tile``, so a selective sweep can restrict the prefix to its
        active tiles.
        """
        key = (mode, pin_tiles, form, pin_memory)
        prefix = self._packed_prefixes.get(key)
        if prefix is None:
            buf, (unit,), (nbytes,), _ = self._stage_units(
                mode, [(0, pin_tiles)], form, pin_memory, run_tile=True
            )
            prefix = self._packed_prefixes[key] = (buf, unit, nbytes)
        return prefix

    def block_payloads(self, pin_memory: bool) -> dict:
        """Every padded host block as a byte payload, built once per pinning."""
        payloads = self._block_payloads.get(pin_memory)
        if payloads is None:
            with _TRACER.span("stage_block_payloads", cat="staging", blocks=len(self.block_keys)):
                payloads = {
                    key: _block_payload(host, pin_memory)
                    for key, host in self.host_blocks.items()
                }
            self._block_payloads[pin_memory] = payloads
        return payloads


class _BlockFetcher:
    """Per-run edge-block access layer: blocks in each sweep's declared order.

    Every per-block schedule obtains its sub-shard blocks through this
    object, so edge bytes are charged where the data moves:

    * ``residency="device"``: the blocks come from the staged device
      mirror, and a fetch of a key outside the resident set charges
      ``e·Be`` model bytes (the simulated slow tier). The whole topology is
      on the device, so the high-water mark is reported once, up front.
    * ``residency="host"``: only the resident set is on the device, pinned
      once (:meth:`GraphSession._ensure_pinned`). Any other key is a real
      copy of its padded host block, in the declared order, with the next
      block's copy queued (on a stream of its own) before this block is
      handed out; the block is then trimmed and indexed on the device
      (:func:`_block_on_device`). The charge is the same ``e·Be``, and
      ``bytes_h2d`` records the raw padded bytes shipped. The peak is the
      pinned set plus the block in use and the one prefetched.
    * ``residency="disk"``: the same stream, but a block outside the
      ``host_memory_budget``'s cache is read from the file's mmap views
      into the next of the session's two page-locked staging slots, and
      its raw padded bytes are charged to ``bytes_disk_read`` there;
      cached blocks come from their page-locked copies, built once.
    """

    def __init__(
        self, session: "GraphSession", compiled: CompiledPlan, meters: Meters, pinned: dict
    ):
        self._session = session
        self._resident = compiled.resident
        self._host = compiled.residency in ("host", "disk")
        self._disk = compiled.residency == "disk"
        self._host_cached = compiled.host_cached
        self._meters = meters
        self._pinned = pinned
        self._ring: dict[tuple[int, int], tuple] = {}
        self._order: list[tuple[int, int]] = []
        self._pos = 0
        e_blk = session._staged.block_e
        self._model_bytes = {k: int(e_blk[k]) * session.Be for k in session.block_keys}
        if self._host:
            self._pinned_model = float(sum(self._model_bytes[k] for k in pinned))
            meters.peak_device_graph_bytes = max(
                meters.peak_device_graph_bytes, self._pinned_model
            )
        else:
            meters.peak_device_graph_bytes = max(
                meters.peak_device_graph_bytes, float(sum(self._model_bytes.values()))
            )

    def begin(self, order: list[tuple[int, int]]) -> Callable[[], dict]:
        """Declare this sweep's block order; returns the sequential fetch.

        At host residency the first streamed block's copy is queued at once.
        """
        self._order = order
        self._pos = 0
        if self._host and order:
            self._prefetch(order[0])
        return self._next

    def _payload(self, key: tuple[int, int]) -> _BlockPayload:
        """The block's host payload; a read from the file charges its raw bytes."""
        sess = self._session
        pin = sess.device.type == "cuda"
        if not self._disk:
            return sess._staged.block_payloads(pin)[key]
        if key in self._host_cached:
            return sess._host_cache_block(key)
        payload = _block_payload(sess._staged.host_blocks[key], pin, sess._disk_slots())
        self._meters.bytes_disk_read += payload.nbytes
        _OBS_DISK.inc(payload.nbytes)
        return payload

    def _upload(self, key: tuple[int, int]) -> tuple:
        """Queue one block's host→device copy and charge its raw bytes.

        The copy is the "h2d" injection point: an injected transient fault
        is retried in place (bounded, with backoff), and the charges land
        once, after the copy, so the meters do not depend on the retries.
        """
        sess = self._session
        payload = self._payload(key)
        buf, done = with_transient_retries(
            sess._injector, f"block:{key[0]},{key[1]}",
            lambda: streaming.upload(payload.buf, sess.device, sess._copy_stream()),
        )
        if payload.slot is not None:
            sess._disk_slots().copied(payload.slot, done)
        self._meters.bytes_h2d += payload.nbytes
        _OBS_H2D.inc(payload.nbytes)
        return payload, buf, done

    def _prefetch(self, key: tuple[int, int]) -> None:
        if key in self._pinned or key in self._ring:
            return
        self._ring[key] = self._upload(key)

    def _next(self) -> dict:
        key = self._order[self._pos]
        self._pos += 1
        if not self._host:
            if key not in self._resident:
                self._meters.bytes_read_edges += self._model_bytes[key]
            return self._session._staged.device_blocks(self._session.device)[key]
        blk = self._pinned.get(key)
        if blk is not None:
            if self._pos < len(self._order):
                self._prefetch(self._order[self._pos])
            return blk
        pending = self._ring.pop(key, None)
        if pending is None:  # an access out of the declared order
            pending = self._upload(key)
        if self._pos < len(self._order):
            self._prefetch(self._order[self._pos])
        self._meters.bytes_read_edges += self._model_bytes[key]
        live = (
            self._pinned_model
            + self._model_bytes[key]
            + sum(self._model_bytes[k] for k in self._ring)
        )
        self._meters.peak_device_graph_bytes = max(self._meters.peak_device_graph_bytes, live)
        payload, buf, done = pending
        if done is not None:
            torch.cuda.current_stream(self._session.device).wait_event(done)
        return _block_on_device(
            streaming.typed_views(buf, payload.sections), payload.e, payload.u, payload.grouped
        )


class GraphSession:
    """Staged graph state shared by every run.

    Args:
      graph: sharded :class:`DSSSGraph`.
      device: where the staged graph and attributes live. ``None`` means CUDA,
        and raises when no CUDA device is present; pass ``"cpu"`` to run
        the plain versions of the kernels on the CPU.
      memory_budget: bytes of fast-tier memory (B_M); ``None`` = unlimited.
        It sets the SPU/DPU/MPU choice and the modelled meters, and at host
        residency what stays on the device.
      residency: ``"device"`` — what a run needs is uploaded once —,
        ``"host"`` — the budget is enforced: the edge topology it does not
        pin is copied from page-locked host memory every sweep —,
        ``"disk"`` — a session opened with :meth:`open` only: the same
        streams, read from the ``.dsss`` file's mmap views under the
        three-level budget (``memory_budget`` pins on the device,
        ``host_memory_budget`` caches in host memory, the rest is read
        from the file every sweep) — or ``"auto"``: ``"disk"`` for a
        session opened from a file, else ``"host"`` when a
        ``memory_budget`` is set and ``"device"`` otherwise.
      execution: ``"packed_kernel"`` (every sweep runs the tile-sweep
        kernel), ``"packed"`` (the same sweep with the kernel's plain
        version), ``"per_block"`` (the paper's schedules, one sub-shard at a
        time) or ``"auto"`` (packed_kernel). The ``"fused"`` strategy and
        registered custom strategies run per-block whatever is asked.
      packing: ``"adaptive"``, ``"subshard"`` or ``"auto"`` (subshard for
        ``src_sorted`` graphs, adaptive otherwise).
      Be: bytes per edge in the I/O model (+4 for weighted graphs).
      Bv: bytes per vertex id.
      staged: the graph's staged state, shared by sessions over the same
        graph object (:func:`get_session` passes it); ``None`` stages anew.
      host_memory_budget: the disk tier's host RAM bound, bytes of blocks or
        tile chunks kept in host memory after the device pins, in
        streaming order; ``None`` caches everything. Disk-backed sessions
        only.
      fault_plan: a :class:`repro_torch.reliability.FaultPlan` to inject
        (see :meth:`inject_faults`); ``None`` injects nothing.
    """

    def __init__(
        self,
        graph: DSSSGraph,
        *,
        device: str | torch.device | None = None,
        memory_budget: int | None = None,
        residency: str = "auto",
        execution: str = "auto",
        packing: str = "auto",
        Be: int = 8,
        Bv: int = 4,
        staged: "_StagedGraph | None" = None,
        host_memory_budget: int | None = None,
        fault_plan: FaultPlan | None = None,
    ):
        _check_axis("residency", residency, ("device", "host", "disk", "auto"))
        _check_axis("execution", execution, ("packed_kernel", "packed", "per_block", "auto"))
        if packing not in ("adaptive", "subshard", "auto"):
            raise ValueError(
                f"packing must be 'adaptive', 'subshard' or 'auto', got {packing!r}"
            )
        if packing == "auto":
            packing = "subshard" if graph.src_sorted else "adaptive"
        elif packing == "adaptive" and graph.src_sorted:
            raise ValueError(
                "packing='adaptive' requires destination-sorted sub-shards; "
                "src_sorted graphs support only packing='subshard'"
            )
        self.device = resolve_device(device)
        self.graph = graph
        self.memory_budget = memory_budget
        self.residency = residency
        self.execution = execution
        self.packing = packing
        self.has_weights = graph.weights is not None
        self.Be = Be + (4 if self.has_weights else 0)
        self.Bv = Bv
        self._hub_d = graph.mean_hub_in_degree()
        if staged is not None and staged.graph is not graph:
            raise ValueError("staged state belongs to another graph object")
        self._staged = staged if staged is not None else _StagedGraph(graph)
        self._store = self._staged.store
        if residency == "disk" and self._store is None:
            raise ValueError(
                "residency='disk' requires a disk-backed session: open the graph "
                "from a .dsss container with GraphSession.open(path) "
                "(see repro_torch.storage)"
            )
        if host_memory_budget is not None and self._store is None:
            raise ValueError(
                "host_memory_budget is the disk tier's RAM-cache bound and only "
                "applies to disk-backed sessions (GraphSession.open); in-memory "
                "sessions are bounded by memory_budget alone"
            )
        self.host_memory_budget = host_memory_budget
        # One live injector shared by the sweep loop, the copies and the
        # store, so a plan's fire budgets are spent once across layers.
        self._injector = None
        if fault_plan is not None:
            self.inject_faults(fault_plan)
        self._residency: dict[int, frozenset] = {}  # Ba -> resident set
        self._compiled: dict[tuple, CompiledPlan] = {}
        # Host residency: what the budget keeps on the device (one of the
        # two at a time), the stream plans, and the copy machinery.
        self._pinned: dict[tuple[int, int], dict] = {}
        self._packed_pins: tuple | None = None  # (pin_tiles, form, pins, model, actual)
        self._stream_plans: dict[tuple, PackedStreamPlan] = {}
        self._rings: dict[str, streaming.CopyRing] = {}
        self._stream = None
        # Disk tier: the host_memory_budget's caches (blocks, tile chunks),
        # built once each; the stream of each plan; the two staging slots.
        self._host_cache: dict[tuple[int, int], _BlockPayload] = {}
        self._packed_ram: dict[tuple, tuple] = {}
        self._disk_streams: dict[tuple, _DiskStream] = {}
        self._slots: streaming.HostSlots | None = None

    @classmethod
    def open(
        cls,
        path: str,
        *,
        device: str | torch.device | None = None,
        memory_budget: int | None = None,
        host_memory_budget: int | None = None,
        residency: str = "auto",
        execution: str = "auto",
        packing: str = "auto",
        Be: int = 8,
        Bv: int = 4,
        verify: bool = True,
        fault_plan: FaultPlan | None = None,
        read_policy=None,
    ) -> "GraphSession":
        """Open a ``.dsss`` container as a disk-backed session.

        The graph, its padded blocks and its stored tile layout are the
        file's read-only mmap views: nothing edge-scale is read into host
        memory until a sweep fetches it, and then only the
        ``host_memory_budget``'s cache, a chunk being built and the copy
        ring's two page-locked slots are held (no whole-layout run index,
        no page-locked copy of the whole stream). ``residency`` defaults
        (``"auto"``) to ``"disk"``. ``verify=True`` checks every segment's
        checksum first, so a truncated or bit-flipped file fails loudly;
        ``read_policy`` (a :class:`repro_torch.storage.ReadPolicy`) checks
        each segment a run reads on first touch instead, re-reading with
        backoff and quarantining a segment that stays bad. ``fault_plan``
        attaches a :class:`repro_torch.reliability.FaultPlan` to the session
        and its store (see :meth:`inject_faults`).
        """
        from repro_torch.storage.format import open_dsss

        store = open_dsss(path, verify=verify, read_policy=read_policy)
        graph = store.graph()
        return cls(
            graph,
            device=device,
            memory_budget=memory_budget,
            residency=residency,
            execution=execution,
            packing=packing,
            Be=Be,
            Bv=Bv,
            staged=_StagedGraph(graph, store=store),
            host_memory_budget=host_memory_budget,
            fault_plan=fault_plan,
        )

    @property
    def store(self):
        """The backing :class:`repro_torch.storage.DSSSStore`, or ``None``."""
        return self._store

    def inject_faults(self, plan: FaultPlan | None) -> None:
        """Attach (or clear, with ``None``) a deterministic fault plan.

        Builds one live :class:`repro_torch.reliability.FaultInjector`
        shared by the sweep loop (``"sweep"`` site), the host→device copies
        of streamed blocks and tile chunks (``"h2d"``) and the backing
        ``.dsss`` store's checksum reads (``"storage"``), so a plan's fire
        budgets are spent once across layers.
        """
        self._injector = plan.injector() if plan is not None else None
        if self._store is not None:
            self._store.attach_faults(self._injector)

    @property
    def fault_injector(self):
        """The live injector of the attached fault plan (or ``None``)."""
        return self._injector

    def _heal_store_segments(self, prefix: str) -> None:
        """Check the store segments a disk run reads, once, under its ReadPolicy.

        Block (``blk_``) or tile (``p_``) segments are checksummed on first
        touch with bounded re-reads, so a torn read heals and a segment
        that stays bad raises :class:`~repro_torch.storage.DegradedReadError`
        before any of its bytes reach the device. No-op without a policy.
        """
        store = self._store
        if store is None or store.read_policy is None:
            return
        store.ensure_segments(n for n in store.segments if n.startswith(prefix))

    @property
    def block_keys(self) -> frozenset:
        """Keys of the non-empty sub-shards."""
        return self._staged.block_keys

    @property
    def host_blocks(self) -> dict[tuple[int, int], dict]:
        """The padded numpy "shard files" (built at first use, never uploaded)."""
        return self._staged.host_blocks

    @property
    def blocks(self) -> dict[tuple[int, int], dict]:
        """The per-block path's blocks: on the device (uploaded once) at
        device residency, the padded host blocks (a store's mmap views) at
        host and disk residency (the device mirror would break the budget)."""
        if self.resolved_residency() in ("host", "disk"):
            return self._staged.host_blocks
        return self._staged.device_blocks(self.device)

    def staged_host_bytes(self) -> int:
        """Raw host bytes the staged graph holds.

        In-memory sessions: the padded host blocks (building them if
        needed). Disk-backed sessions: the mmap views hold nothing, so only
        the ``host_memory_budget``'s caches count, as they fill.
        """
        if self._store is not None:
            total = sum(p.nbytes for p in self._host_cache.values())
            total += sum(nbytes for _, _, nbytes in self._packed_ram.values())
            return int(total)
        return int(sum(_host_block_nbytes(b) for b in self.host_blocks.values()))

    def resolved_residency(self, override: str | None = None) -> str:
        """Resolve the residency axis to ``"device"``, ``"host"`` or ``"disk"``."""
        mode = override or self.residency
        if mode == "auto":
            if self._store is not None:
                mode = "disk"
            else:
                mode = "host" if self.memory_budget is not None else "device"
        if mode == "disk" and self._store is None:
            raise ValueError(
                "residency='disk' requires a disk-backed session: open the graph "
                "with GraphSession.open(path)"
            )
        return mode

    def pinned_device_bytes(self) -> tuple[float, float]:
        """(model, actual) bytes of the topology pinned on the device (host residency).

        Per-block pins (the resident blocks) or the packed tile prefix; at
        most one of the two is held. Model bytes are ``e·Be`` of the real
        edges, in the budget's units; actual bytes are what was uploaded
        (padded blocks, or the prefix's payload).
        """
        host = self._staged.host_blocks if self._pinned else {}
        model = float(sum(int(self._staged.block_e[k]) * self.Be for k in self._pinned))
        actual = float(sum(_host_block_nbytes(host[k]) for k in self._pinned))
        if self._packed_pins is not None:
            model += self._packed_pins[3]
            actual += self._packed_pins[4]
        return model, actual

    def packed_stream_plan(self, strategy: str, Ba: int) -> PackedStreamPlan:
        """Tile placement of the packed paths under host residency.

        The budget's semantics at tile granularity: for SPU the budget left
        after both attribute copies (``2·n_pad·Ba``) pins a prefix of the
        tiles; DPU/MPU pin none. The rest streams in chunks of at most
        ``min(256 KiB, budget/4)`` of tile data (never below one tile).
        A disk-backed session's ``host_memory_budget`` then keeps whole
        chunks after the prefix in host memory, in order, each costed at
        its JAX leaves' bytes (``host_tiles``). The JAX package's plan,
        field for field.
        """
        key = (strategy == "spu", Ba)
        plan = self._stream_plans.get(key)
        if plan is not None:
            return plan
        packed = self._staged.packed_host(self.packing)
        nt, T = packed.num_tiles, packed.tile_edges
        cum = np.cumsum(packed.e_valid.astype(np.int64)) * self.Be
        if self.memory_budget is None:
            pin = nt
        elif strategy == "spu":
            leftover = self.memory_budget - 2 * self.graph.n_pad * Ba
            pin = int(np.searchsorted(cum, leftover, side="right"))
        else:
            pin = 0
        pin_model = float(cum[pin - 1]) if pin else 0.0
        tile_bytes = max(T * self.Be, 1)
        target = 256 * 1024
        if self.memory_budget is not None:
            target = min(target, max(self.memory_budget // 4, tile_bytes))
        chunk = max(1, min(int(target // tile_bytes), max(nt - pin, 1)))
        max_chunk = 0.0
        for lo in range(pin, nt, chunk):
            hi = min(lo + chunk, nt)
            max_chunk = max(max_chunk, float(cum[hi - 1]) - (float(cum[lo - 1]) if lo else 0.0))
        host_tiles = 0
        if self._store is not None:
            if self.host_memory_budget is None:
                host_tiles = nt - pin
            else:
                per_edge = PACKED_SLOT_BYTES + (4 if self.has_weights else 0)
                leftover = self.host_memory_budget
                for lo in range(pin, nt, chunk):
                    hi = min(lo + chunk, nt)
                    raw = (hi - lo) * (T * per_edge + 4)
                    if leftover < raw:
                        break
                    leftover -= raw
                    host_tiles += hi - lo
        plan = PackedStreamPlan(
            pin_tiles=pin,
            chunk_tiles=chunk,
            num_tiles=nt,
            tile_edges=T,
            pin_model_bytes=pin_model,
            max_chunk_model_bytes=max_chunk,
            host_tiles=host_tiles,
        )
        self._stream_plans[key] = plan
        return plan

    def _copy_stream(self):
        """The stream host→device copies run on (``None`` off CUDA), made once."""
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _disk_slots(self) -> streaming.HostSlots:
        """The two page-locked staging slots of the disk reads, made once."""
        if self._slots is None:
            self._slots = streaming.HostSlots(self.device.type == "cuda")
        return self._slots

    def _disk_stream(self, splan: PackedStreamPlan, form: str) -> "_DiskStream":
        """The :class:`_DiskStream` of one stream plan and form, made once."""
        key = (splan, form)
        stream = self._disk_streams.get(key)
        if stream is None:
            stream = self._disk_streams[key] = _DiskStream(self, splan, form)
        return stream

    def _packed_ram_chunk(self, stream: "_DiskStream", lo: int, hi: int) -> tuple:
        """Tiles ``[lo, hi)`` of the host-cached window: ``(buf, unit, nbytes)``, built once.

        Read from the file the first time and kept page-locked, so later
        sweeps copy it with no read (and charge no ``bytes_disk_read``).
        """
        key = (lo, hi, stream.form)
        chunk = self._packed_ram.get(key)
        if chunk is None:
            chunk = self._packed_ram[key] = stream.build(lo, hi, None)[:3]
        return chunk

    def _resolve_host_cache(self, strategy: str, params: IOParams) -> frozenset:
        """The sub-shards the ``host_memory_budget`` keeps in host memory (disk only).

        Picked in row-major streaming order among the blocks the device
        budget did not pin, each costed at its padded bytes;
        ``host_memory_budget=None`` caches every one. The JAX package's set.
        """
        if self._store is None:
            return frozenset()
        resident = self._resolve_residency(strategy, params)
        if self.host_memory_budget is None:
            return frozenset(k for k in self.block_keys if k not in resident)
        host = self.host_blocks
        picked = set()
        leftover = self.host_memory_budget
        for key in sorted(self.block_keys):
            if key in resident:
                continue
            cost = _host_block_nbytes(host[key])
            if leftover >= cost:
                picked.add(key)
                leftover -= cost
        return frozenset(picked)

    def _host_cache_block(self, key: tuple[int, int]) -> _BlockPayload:
        """The page-locked copy of one host-cached block, read from the file once."""
        payload = self._host_cache.get(key)
        if payload is None:
            payload = self._host_cache[key] = _block_payload(
                self._staged.host_blocks[key], self.device.type == "cuda"
            )
        return payload

    def _copy_ring(self, form: str, nbytes: int) -> streaming.CopyRing:
        """The two-slot ring of one stream form, grown when a chunk is larger."""
        ring = self._rings.get(form)
        if ring is None or ring.nbytes < nbytes:
            ring = self._rings[form] = streaming.CopyRing(self.device, nbytes)
        return ring

    def _ensure_pinned(self, resident: frozenset) -> dict:
        """Pin exactly the resident blocks on the device (per-block host runs).

        Blocks leaving the resident set are released, so plans of other
        strategies never keep device copies past the budget; the packed
        prefix is released too (one pinning at a time). New blocks go up
        once and are reused across runs.
        """
        self._packed_pins = None
        for key in [k for k in self._pinned if k not in resident]:
            del self._pinned[key]
        todo = [k for k in sorted(resident) if k in self.block_keys and k not in self._pinned]
        if todo:
            pin = self.device.type == "cuda"
            with _TRACER.span("stage_pins", cat="staging", blocks=len(todo)):
                for key in todo:
                    # A store's blocks go up straight from the file: no
                    # page-locked copy of every block is built for them.
                    if self._store is not None:
                        p = _block_payload(self._staged.host_blocks[key], pin)
                    else:
                        p = self._staged.block_payloads(pin)[key]
                    buf, done = streaming.upload(p.buf, self.device, self._copy_stream())
                    if done is not None:
                        torch.cuda.current_stream(self.device).wait_event(done)
                    self._pinned[key] = _block_on_device(
                        streaming.typed_views(buf, p.sections), p.e, p.u, p.grouped
                    )
        return self._pinned

    def _ensure_packed_pins(self, pin_tiles: int, form: str) -> tuple:
        """Pin exactly the leading ``pin_tiles`` tiles on the device (packed host runs).

        Returns ``(pins or None, model bytes)``: for the ``"kernel"`` form
        the prefix as one tile range, ``(device payload, TileRange)`` with
        its ``run_tile`` section (a selective sweep restricts it to its
        active tiles); for ``"leaves"`` the JAX package's tile leaves as
        device tensors. Another count or form releases the previous pins,
        and the per-block pins as well.
        """
        self._pinned.clear()
        held = self._packed_pins
        if held is not None and held[0] == pin_tiles and held[1] == form:
            return held[2], held[3]
        self._packed_pins = None
        if pin_tiles <= 0:
            self._packed_pins = (0, form, None, 0.0, 0.0)
            return None, 0.0
        packed = self._staged.packed_host(self.packing)
        with _TRACER.span("stage_packed_pins", cat="staging", tiles=pin_tiles):
            host, unit, actual = self._staged.packed_prefix(
                self.packing, pin_tiles, form, self.device.type == "cuda"
            )
            buf = host.to(self.device)
        pins = (buf, unit) if form == "kernel" else streaming.typed_views(buf, unit)
        model = float(packed.e_valid[:pin_tiles].astype(np.int64).sum()) * self.Be
        self._packed_pins = (pin_tiles, form, pins, model, float(actual))
        return pins, model

    def resolved_execution(
        self, strategy: str, residency: str, override: str | None = None
    ) -> str:
        """Resolve the execution axis: ``"packed_kernel"``, ``"packed"`` or ``"per_block"``.

        ``strategy`` is resolved (not ``"auto"``) and ``residency`` is a
        resolved residency (``"device"``, ``"host"`` or ``"disk"``; every
        execution runs at each of them). The packed modes apply
        to the SPU/DPU/MPU schedules; ``"fused"`` and registered custom
        strategies run per-block even when a packed mode was asked for
        (results and meters are the same either way). ``"auto"`` is the
        kernel: the card plays the TPU's role here. ``"packed"``, the
        plain version of the tile sweep, runs only when named.
        """
        if residency not in ("device", "host", "disk"):
            raise ValueError(
                "residency must be a resolved residency ('device', 'host' or "
                f"'disk'), got {residency!r}"
            )
        mode = override or self.execution
        if strategy not in ("spu", "dpu", "mpu"):
            return "per_block"
        if mode == "auto":
            mode = "packed_kernel"
        return mode

    @classmethod
    def register_strategy(cls, name: str, iteration_fn: Callable) -> None:
        """Register a custom per-iteration schedule (e.g. a baseline).

        ``iteration_fn(ctx, attrs, active, meters) -> (attrs, active_next)``
        is called once per update sweep, on the per-block path:

        * ``ctx`` is the run's :class:`_RunContext` (session, program,
          aux and its interval views, ``valid``, ``tol``, ``K``, the block
          ``fetcher``, ``activity``, ``aux_batched``);
        * ``attrs`` is the ``(K, P, interval_size)`` tensor on
          ``session.device``, and the schedule returns the new one there;
        * ``active`` and ``active_next`` are ``(K, P)`` numpy bool: the
          intervals that changed in the previous sweep, and in this one;
        * ``meters`` is the run's :class:`Meters`, which the schedule
          charges (edge bytes are charged by ``ctx.fetcher``).

        A plan names the schedule by ``strategy=name``; it pins no
        sub-shard in the fast tier.
        """
        _STRATEGIES[name] = iteration_fn

    def fused_arrays(self) -> dict:
        """The fused path's whole-graph edge arrays, staged once per device.

        ``src``/``dst`` (int64) and ``weights`` in the flat DSSS order,
        stably sorted by destination, and ``lengths``, each destination's
        in-edge count over ``n_pad``: a float sum then folds every
        destination's edges in flat order.
        """
        fused = self._staged.fused.get(self.device)
        if fused is None:
            g = self.graph

            def up(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

            with _TRACER.span("stage_fused", cat="staging", m=int(g.m)):
                order = np.argsort(g.dst, kind="stable")
                dst = g.dst[order]
                fused = {
                    "src": up(g.src[order], np.int64),
                    "dst": up(dst, np.int64),
                    "weights": None if g.weights is None else up(g.weights[order], np.float32),
                    "lengths": up(np.bincount(dst, minlength=g.n_pad), np.int64),
                }
            self._staged.fused[self.device] = fused
        return fused

    def kernel_operands(
        self, i: int, j: int, dtype: torch.dtype, *, gather_op: str = "mul", reduce: str = "sum"
    ) -> tuple:
        """Sub-shard kernel operands of SS[i, j] on the session's device.

        ``(src_idx, hub_inv, weights, block_base)`` as
        :func:`repro_torch.kernels.ops.prepare_subshard_operands` stages
        them, from the host block, once per (sub-shard, dtype, semiring).
        Pass them to :func:`repro_torch.kernels.ops.subshard_update` with
        the source interval's values and ``u`` hub slots.
        """
        key = (i, j, str(dtype), gather_op, reduce, self.device)
        ops = self._staged.kernel_operands.get(key)
        if ops is None:
            ops = prepare_from_host_block(
                self.host_blocks[(i, j)], dtype, gather_op=gather_op,
                reduce=reduce, device=self.device,
            )
            self._staged.kernel_operands[key] = ops
        return ops

    def _interval_aux(self, aux: dict, k: int, batched: bool = False) -> dict:
        """Interval k's view of the aux dict (vertex leaves sliced, scalars as is)."""
        isz = self.graph.interval_size
        lo, hi = k * isz, (k + 1) * isz
        vertex_ndim = 2 if batched else 1
        return {
            key: (v[..., lo:hi] if v.ndim == vertex_ndim else v)
            for key, v in aux.items()
        }

    def _packed_tile_activity(self, row_active: np.ndarray) -> np.ndarray:
        """(NT,) bool: tiles holding an edge of an active source interval."""
        first, last = self._staged.packed_spans(self.packing)
        return active_tile_mask(row_active, first, last)

    def params_for(self, program: VertexProgram) -> IOParams:
        g = self.graph
        return IOParams(
            n=g.n, m=g.m, Ba=program.attr_bytes, Bv=self.Bv, Be=self.Be,
            d=self._hub_d, P=g.P,
        )

    def compile(self, plan: ExecutionPlan) -> CompiledPlan:
        """Resolve a plan's strategy, residency, execution and activity (cached)."""
        key = (
            plan.strategy, plan.program.attr_bytes, plan.residency,
            plan.execution, plan.activity, plan.program.monotone,
        )
        compiled = self._compiled.get(key)
        if compiled is None:
            params = self.params_for(plan.program)
            choice = self._resolve_choice(plan.strategy, params)
            residency = self.resolved_residency(plan.residency)
            compiled = CompiledPlan(
                params=params,
                choice=choice,
                resident=self._resolve_residency(choice.strategy, params),
                residency=residency,
                host_cached=(
                    self._resolve_host_cache(choice.strategy, params)
                    if residency == "disk"
                    else frozenset()
                ),
                execution=self.resolved_execution(choice.strategy, residency, plan.execution),
                activity=(
                    "selective"
                    if plan.program.monotone and plan.activity != "off"
                    else "off"
                ),
            )
            self._compiled[key] = compiled
        return compiled

    def _resolve_choice(self, strategy: str, params: IOParams) -> StrategyChoice:
        if strategy == "auto":
            # A disk-backed session's host cache adds the modelled disk
            # re-read to each candidate (select_strategy's host_B_M term).
            return select_strategy(
                params, self.memory_budget,
                host_B_M=self.host_memory_budget if self._store is not None else None,
            )
        if strategy in ("spu", "dpu", "mpu", "fused"):
            Q = self.graph.P
            if strategy == "dpu":
                Q = 0
            elif strategy == "mpu":
                Q = mpu_q(params, self.memory_budget or 0)
            return StrategyChoice(strategy, Q, 0.0, 0.0)
        if strategy in _STRATEGIES:
            return StrategyChoice(strategy, 0, 0.0, 0.0)
        raise ValueError(f"unknown strategy {strategy!r}")

    def _resolve_residency(self, strategy: str, params: IOParams) -> frozenset:
        """The sub-shards the memory budget pins in the fast tier.

        SPU: both attribute copies (``2·n_pad·Ba``) come first; the leftover
        pins sub-shards in row-major order. DPU/MPU pin no edge blocks.
        """
        if strategy != "spu":
            return frozenset()
        resident = self._residency.get(params.Ba)
        if resident is not None:
            return resident
        if self.memory_budget is None:
            resident = frozenset(self.block_keys)
        else:
            picked = set()
            leftover = self.memory_budget - 2 * self.graph.n_pad * params.Ba
            for key in sorted(self.block_keys):
                cost = int(self._staged.block_e[key]) * self.Be
                if leftover >= cost:
                    picked.add(key)
                    leftover -= cost
            resident = frozenset(picked)
        self._residency[params.Ba] = resident
        return resident

    # -- execution -----------------------------------------------------------
    def run(
        self,
        plan: ExecutionPlan,
        *,
        resume_from: str | bool | None = None,
        cancel: Callable[[int], None] | None = None,
    ) -> Result:
        """Execute one plan against the staged graph.

        ``resume_from`` restores a sweep snapshot and continues: a snapshot
        path, a checkpoint directory (its latest snapshot; an empty or
        missing directory starts fresh), or ``True`` for the plan's own
        ``checkpoint.directory``. The resumed run gives an uninterrupted
        run's bits and field-identical meters (``wall_seconds`` sums the
        attempts' time). ``cancel`` is called with the completed sweep
        count before every sweep; raising
        :class:`repro_torch.reliability.DeadlineExceeded` from it stops the
        run between sweeps and leaves the session reusable.
        """
        return self._execute(
            plan, [plan.kwargs_dict()], resume_from=resume_from, cancel=cancel
        ).results[0]

    def run_batch(
        self,
        plans: list[ExecutionPlan],
        *,
        resume_from: str | bool | None = None,
        cancel: Callable[[int], None] | None = None,
    ) -> BatchResult:
        """Execute K plans in one sweep sequence when they fuse, else in turn.

        Plans fuse when they share a ``batch_key()`` and their aux is
        identical or stackable; results are identical either way.
        ``resume_from`` and ``cancel`` behave as in :meth:`run`; a fused
        batch checkpoints and resumes as one unit, and only a fusable batch
        can resume.
        """
        if not plans:
            return BatchResult([], Meters(), 0, True, True)
        if self._fusable(plans):
            return self._execute(
                plans[0], [p.kwargs_dict() for p in plans],
                resume_from=resume_from, cancel=cancel,
            )
        if resume_from:
            raise ValueError(
                "resume_from requires a fusable batch (one snapshot holds "
                "the whole batch's state); these plans fall back to "
                "sequential runs — resume them individually"
            )
        meters = Meters()
        results = [self.run(p, cancel=cancel) for p in plans]
        for r in results:
            meters.merge(r.meters)
        return BatchResult(
            results=results,
            meters=meters,
            iterations=max(r.iterations for r in results),
            converged=all(r.converged for r in results),
            fused=False,
        )

    def _fusable(self, plans: list[ExecutionPlan]) -> bool:
        head = plans[0]
        if any(p.batch_key() != head.batch_key() for p in plans[1:]):
            return False
        g = self.graph
        aux0 = head.program.make_aux(g, **head.kwargs_dict())
        for p in plans[1:]:
            aux = p.program.make_aux(g, **p.kwargs_dict())
            if set(aux) != set(aux0):
                return False
            for k in aux0:
                if aux[k].shape != aux0[k].shape or aux[k].dtype != aux0[k].dtype:
                    return False
        return True

    def _resolve_resume(self, plan: ExecutionPlan, resume_from: str | bool | None) -> str | None:
        """A ``resume_from`` argument as a snapshot path, or ``None`` for a fresh start.

        A directory resumes from its latest snapshot, or starts fresh when
        it holds none; ``True`` names the plan's checkpoint directory; a
        file path must exist.
        """
        if not resume_from:
            return None
        if resume_from is True:
            if plan.checkpoint is None:
                raise ValueError(
                    "resume_from=True needs plan.checkpoint to name the snapshot directory"
                )
            resume_from = plan.checkpoint.directory
        if os.path.isdir(resume_from):
            return latest_snapshot(resume_from)
        if not os.path.exists(resume_from):
            raise SnapshotError(f"{resume_from}: no such snapshot")
        return resume_from

    def _save_sweep_snapshot(
        self, spec, plan, attrs, active, converged_at, sweeps, activity_log, meters, wall_seconds,
    ) -> None:
        """Atomically snapshot the loop state after one sweep (the JAX package's format).

        The only host copy of ``attrs`` a run makes between its sweeps, so
        it synchronizes with the device only on checkpoint sweeps.
        """
        g = self.graph
        mdict = {f.name: _plain(getattr(meters, f.name)) for f in dataclasses.fields(meters)}
        # The live meter keeps counting; the snapshot records the elapsed
        # time as of the save.
        mdict["wall_seconds"] = wall_seconds
        meta = {
            "sweeps": sweeps,
            "meters": mdict,
            "program": plan.program.name,
            "K": len(converged_at),
            "P": int(g.P),
            "interval_size": int(g.interval_size),
            "n": int(g.n),
            "m": int(g.m),
        }
        arrays = {
            "attrs": attrs.cpu().numpy(),
            "active": np.asarray(active),
            "activity_log": (
                np.stack(activity_log) if activity_log else np.zeros((0, g.P), dtype=bool)
            ),
            "converged_at": np.asarray([-1 if c is None else c for c in converged_at], np.int64),
        }
        save_snapshot(spec.directory, sweeps, arrays, meta, keep=spec.keep)

    def _restore_sweep_snapshot(self, path: str, plan: ExecutionPlan, K: int, meters: Meters):
        """Load one snapshot back into the loop state, checked against the plan."""
        arrays, meta = load_snapshot(path)
        g = self.graph
        expect = {
            "program": plan.program.name,
            "K": K,
            "P": int(g.P),
            "interval_size": int(g.interval_size),
            "n": int(g.n),
            "m": int(g.m),
        }
        for key, want in expect.items():
            got = meta.get(key)
            if got != want:
                raise SnapshotError(
                    f"{path}: snapshot has {key}={got!r} but the resuming "
                    f"plan/session needs {key}={want!r}"
                )
        # The cumulative meters, wholesale: the snapshot was taken after this
        # run's set-up charges (pins, the fused peak), so the resumed totals
        # equal the uninterrupted run's field for field.
        for name, value in meta["meters"].items():
            setattr(meters, name, value)
        attrs = torch.from_numpy(np.ascontiguousarray(arrays["attrs"])).to(self.device)
        active = np.asarray(arrays["active"])
        converged_at = [None if c < 0 else int(c) for c in arrays["converged_at"]]
        activity_log = [np.asarray(row) for row in arrays["activity_log"]]
        return attrs, active, converged_at, int(meta["sweeps"]), activity_log

    def _publish_iomodel_drift(self, compiled: CompiledPlan, meters: Meters) -> None:
        """Gauge the run's measured/modelled slow-tier bytes per sweep.

        Per direction, (model-unit bytes a sweep) / (Table II closed form);
        1.0 means the engine moved what the paper's model predicts.
        Strategies without a closed form, and zero closed forms, publish
        nothing.
        """
        iters = meters.iterations
        if not iters:
            return
        strategy = compiled.choice.strategy
        try:
            read, write = modelled_io(compiled.params, self.memory_budget, strategy)
        except ValueError:
            return
        if read > 0:
            _OBS_DRIFT.labels(direction="read", strategy=strategy).set(
                meters.bytes_read / iters / read
            )
        if write > 0:
            _OBS_DRIFT.labels(direction="write", strategy=strategy).set(
                meters.bytes_written / iters / write
            )

    def _execute(
        self,
        plan: ExecutionPlan,
        kwargs_list: list[dict],
        *,
        resume_from: str | bool | None = None,
        cancel: Callable[[int], None] | None = None,
    ) -> BatchResult:
        """Run the sweeps of one plan for ``len(kwargs_list)`` queries.

        Each sweep boundary runs, in the JAX package's order: ``cancel``,
        the injector's ``"sweep"`` check (an injected crash), the sweep,
        and on every ``checkpoint.every``-th sweep a snapshot (its own
        ``checkpoint`` span). Without a checkpoint, an injector or a cancel
        the loop adds no host work and no device synchronization.

        Observability: a plan's ``trace`` turns the tracer on for the run,
        pins and staging included, and restores it after; each sweep's span
        carries its ``bytes_h2d`` and ``bytes_disk_read`` deltas (so over a
        run they sum to the meters), the run's span its residency and
        execution. The model byte counters are published once a sweep as
        meter deltas; the physical ones where the bytes move. Spans time
        the host: a packed sweep ends in the copy of its changed map to the
        host, so its span closes after its device work.
        """
        g = self.graph
        prog = plan.program
        compiled = self.compile(plan)
        if compiled.residency == "disk":
            self._heal_store_segments("blk_" if compiled.execution == "per_block" else "p_")
        dev = self.device
        isz = g.interval_size
        K = len(kwargs_list)
        attrs = torch.stack(
            [prog.init_attrs(g, **kw).reshape(g.P, isz) for kw in kwargs_list]
        ).to(dev)
        active = np.stack([prog.init_active(g, **kw) for kw in kwargs_list])
        aux, aux_batched = _batch_aux(prog, g, kwargs_list)
        aux = {k: v.to(dev) for k, v in aux.items()}
        meters = Meters()
        tspec = plan.trace
        obs_on = _REGISTRY.enabled
        was_tracing = _TRACER.enabled
        tracing = was_tracing or tspec is not None
        trace_sweeps = tracing and (tspec is None or tspec.sweeps)
        run_id = next(_RUN_SEQ)
        mark = _TRACER.mark() if tracing else 0
        if tracing and not was_tracing:
            _TRACER.enabled = True
        try:
            # Per-block host and disk runs pin the resident set here; packed
            # ones pin a tile prefix inside the sweep. Device runs leave pins
            # as they are.
            streamed = compiled.residency in ("host", "disk")
            pinned = (
                self._ensure_pinned(compiled.resident)
                if streamed and compiled.execution == "per_block"
                else {}
            )
            fetcher = _BlockFetcher(self, compiled, meters, pinned)
            if compiled.choice.strategy == "fused":
                # The fused path holds the whole edge list on the device.
                meters.peak_device_graph_bytes = max(
                    meters.peak_device_graph_bytes, float(g.m * self.Be)
                )
            ctx = _RunContext(
                session=self,
                program=prog,
                choice=compiled.choice,
                resident=compiled.resident,
                params=compiled.params,
                aux=aux,
                aux_views=[self._interval_aux(aux, k, aux_batched) for k in range(g.P)],
                valid=(torch.arange(g.n_pad, device=dev) < g.n).reshape(g.P, isz),
                tol=torch.tensor(plan.tol, dtype=torch.float32, device=dev),
                K=K,
                fetcher=fetcher,
                activity=compiled.activity,
                aux_batched=aux_batched,
                execution=compiled.execution,
                residency=compiled.residency,
            )
            if compiled.execution in ("packed", "packed_kernel"):
                iteration = _iteration_packed
            else:
                iteration = _STRATEGIES[compiled.choice.strategy]
            converged_at: list[int | None] = [
                0 if not active[m].any() else None for m in range(K)
            ]
            sweeps = 0
            activity_log: list[np.ndarray] = []
            wall0 = 0.0
            snap_path = self._resolve_resume(plan, resume_from)
            if snap_path is not None:
                attrs, active, converged_at, sweeps, activity_log = (
                    self._restore_sweep_snapshot(snap_path, plan, K, meters)
                )
                wall0 = meters.wall_seconds
            ckpt = plan.checkpoint
            inj = self._injector
            start = time.perf_counter()
            for _ in range(sweeps, plan.max_iters):
                if not active.any():
                    break
                # Cancellation and injected crashes land on the sweep
                # boundary, never mid-sweep, so a snapshot is always whole.
                if cancel is not None:
                    cancel(sweeps)
                if inj is not None:
                    inj.check("sweep", sweeps)
                # The sweep's processed-interval bitmap, before it moves on.
                if compiled.activity == "selective":
                    activity_log.append(active.any(axis=0).copy())
                else:
                    activity_log.append(np.ones(g.P, dtype=bool))
                if obs_on or trace_sweeps:
                    s_h2d, s_disk = meters.bytes_h2d, meters.bytes_disk_read
                    s_model = [getattr(meters, f) for f, _ in _OBS_MODEL_BYTES]
                    t_sweep = time.perf_counter()
                attrs, active = iteration(ctx, attrs, active, meters)
                sweeps += 1
                meters.iterations += 1
                if obs_on:
                    _OBS_SWEEPS.inc()
                    for (f, child), before in zip(_OBS_MODEL_BYTES, s_model):
                        delta = getattr(meters, f) - before
                        if delta:
                            child.inc(delta)
                if trace_sweeps:
                    _TRACER.record(
                        "sweep", t_sweep, time.perf_counter(), cat="engine",
                        args={
                            "run": run_id,
                            "sweep": sweeps - 1,
                            "bytes_h2d": meters.bytes_h2d - s_h2d,
                            "bytes_disk_read": meters.bytes_disk_read - s_disk,
                            "active_intervals": int(activity_log[-1].sum()),
                            "intervals": int(g.P),
                        },
                    )
                for m in range(K):
                    if converged_at[m] is None and not active[m].any():
                        converged_at[m] = sweeps
                if ckpt is not None and sweeps % ckpt.every == 0:
                    t_ck = time.perf_counter()
                    self._save_sweep_snapshot(
                        ckpt, plan, attrs, active, converged_at, sweeps,
                        activity_log, meters, wall0 + (t_ck - start),
                    )
                    if tracing:
                        _TRACER.record(
                            "checkpoint", t_ck, time.perf_counter(), cat="engine",
                            args={"run": run_id, "sweep": sweeps},
                        )
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            end = time.perf_counter()
            meters.wall_seconds = wall0 + (end - start)
            if tracing:
                _TRACER.record(
                    "run", start, end, cat="engine",
                    args={
                        "run": run_id,
                        "program": prog.name,
                        "strategy": compiled.choice.strategy,
                        "residency": compiled.residency,
                        "execution": compiled.execution,
                        "K": K,
                        "n": int(g.n),
                        "m": int(g.m),
                        "P": int(g.P),
                        "sweeps": sweeps,
                        "bytes_h2d": meters.bytes_h2d,
                        "bytes_disk_read": meters.bytes_disk_read,
                        "converged": bool(not active.any()),
                    },
                )
                if tspec is not None and tspec.path:
                    _TRACER.export(tspec.path, since=mark)
        finally:
            if tracing and not was_tracing:
                _TRACER.enabled = False
        if obs_on:
            _OBS_RUNS.labels(
                program=prog.name,
                strategy=compiled.choice.strategy,
                residency=compiled.residency,
                execution=compiled.execution,
            ).inc()
            _OBS_PEAK.set(meters.peak_device_graph_bytes)
            self._publish_iomodel_drift(compiled, meters)
        host_attrs = attrs.reshape(K, -1).cpu().numpy()
        results = []
        for m in range(K):
            flat = host_attrs[m]
            # Monotone members report the sweep at which they converged.
            iterations = (
                converged_at[m]
                if prog.monotone and converged_at[m] is not None
                else sweeps
            )
            results.append(
                Result(
                    attrs=flat[: g.n].copy(),
                    output=prog.output(flat, g),
                    iterations=iterations,
                    converged=converged_at[m] is not None,
                    meters=meters,
                    strategy=compiled.choice,
                    activity_log=tuple(activity_log),
                )
            )
        return BatchResult(
            results=results,
            meters=meters,
            iterations=sweeps,
            converged=not active.any(),
            fused=True,
            activity_log=tuple(activity_log),
        )


# ---------------------------------------------------------------------------
# Identity-keyed weak LRU: the session cache below and the drivers' sharded
# graph cache (core/algorithms.py).
# ---------------------------------------------------------------------------
class IdentityLRU:
    """Small LRU keyed by ``(id(obj), *extra)`` with a weakref liveness guard.

    Keyed by identity because the cached value aliases the object's arrays;
    the weakref invalidates a slot whose object died, so a recycled id
    never serves a stale value.
    """

    def __init__(self, size: int = 8):
        self._size = size
        self._entries: OrderedDict[tuple, tuple[weakref.ref, Any]] = OrderedDict()

    def get_or_build(self, obj, extra: tuple, factory: Callable):
        key = (id(obj), *extra)
        entry = self._entries.get(key)
        if entry is not None and entry[0]() is obj:
            self._entries.move_to_end(key)
            return entry[1]
        value = factory()
        self._entries[key] = (weakref.ref(obj), value)
        while len(self._entries) > self._size:
            self._entries.popitem(last=False)
        return value

    def clear(self) -> None:
        self._entries.clear()


# One slot per graph object: its staged state and the session variants
# built over it, so a change of budget or axis never stages the graph
# again. The cache keeps the last `size` graphs staged (a cached session
# holds its graph); clear_session_cache() releases them.
_SESSION_LRU = IdentityLRU(size=8)


def get_session(
    graph: DSSSGraph,
    *,
    device: str | torch.device | None = None,
    memory_budget: int | None = None,
    host_memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    packing: str = "auto",
    Be: int = 8,
    Bv: int = 4,
) -> GraphSession:
    """The session for this graph object and variant, staged at most once (LRU of 8).

    Use it for graph objects the caller keeps alive across calls; for a
    throwaway graph construct :class:`GraphSession` directly, so the staged
    state dies with it. Variants (device, budget, residency, execution,
    packing, byte sizes: every session axis is in the key) share one
    :class:`_StagedGraph`, whose device mirrors and tile layouts are built
    once per device and packing. ``device=None`` is the CUDA card.
    ``host_memory_budget`` is keyed and forwarded, as in the JAX package:
    an in-memory graph refuses it with the session's own error (it is the
    disk tier's RAM bound; disk-backed sessions come from
    :meth:`GraphSession.open`).
    """
    dev = resolve_device(device)
    slot = _SESSION_LRU.get_or_build(
        graph, (), lambda: {"staged": _StagedGraph(graph), "variants": {}}
    )
    key = (dev, memory_budget, host_memory_budget, residency, execution, packing, Be, Bv)
    session = slot["variants"].get(key)
    if session is None:
        session = GraphSession(
            graph,
            device=dev,
            memory_budget=memory_budget,
            host_memory_budget=host_memory_budget,
            residency=residency,
            execution=execution,
            packing=packing,
            Be=Be,
            Bv=Bv,
            staged=slot["staged"],
        )
        slot["variants"][key] = session
    return session


def clear_session_cache() -> None:
    """Release every cached session (and its staged state)."""
    _SESSION_LRU.clear()


def _plain(value):
    """A meter value as a JSON number (numpy scalars become Python ones)."""
    return value.item() if isinstance(value, np.generic) else value


def _check_axis(name: str, value: str, allowed: tuple) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
