"""GraphSession — stage the graph once, run many plans (port of ``repro.core.session``).

The device-residency, packed-kernel slice of the JAX package's session. A
:class:`GraphSession` uploads the :class:`repro_torch.core.dsss.PackedSweep`
tile layout to its device once and executes any number of
:class:`repro_torch.core.plan.ExecutionPlan` jobs against it;
``run_batch`` fuses K compatible plans into one sweep sequence whose
tensors carry a leading ``(K,)`` query axis.

Each update sweep (:func:`_iteration_packed`) does four things, for SPU,
DPU and MPU alike: the per-query globals (``program.pre_iteration``), one
⊕-accumulator init, the tile sweep
(:func:`repro_torch.kernels.packed_sweep.packed_sweep_update` — the CUDA
kernel on the card, its plain version on the CPU) and one batched apply
(``_apply_all_impl``). The numeric pass is the same for every strategy,
because the tile order folds each destination's runs in ascending source
interval, the fold order of every schedule; the strategies differ in the
slow-tier traffic the paper models, which ``_charge_packed_*`` charge to
:class:`Meters` from the layout's metadata, field for field as the JAX
package does.

Selective execution: monotone programs under ``activity="auto"`` sweep
only the tiles whose source intervals changed in the previous sweep, as
an ascending tile-index list handed to the kernel; results are
bit-identical to full sweeps.

Not ported yet, and refused with :class:`NotImplementedError` naming the
ROADMAP item: host and disk residency, the ``"packed"`` (plain scan) and
``"per_block"`` execution paths, and the ``"fused"`` strategy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.dsss import DSSSGraph, active_tile_mask, tile_source_spans
from repro_torch.core.identities import reduce_identity
from repro_torch.core.iomodel import (
    IOParams,
    StrategyChoice,
    mpu_q,
    select_strategy,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.vertex_programs import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.kernels.packed_sweep import packed_sweep_update, prepare_packed_tiles

__all__ = [
    "GraphSession",
    "Meters",
    "MODEL_METER_FIELDS",
    "Result",
    "BatchResult",
    "CompiledPlan",
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

_NOT_PORTED = {
    "host": "residency='host' is not ported yet (ROADMAP A8)",
    "disk": "residency='disk' is not ported yet (ROADMAP A9)",
    "packed": "execution='packed' is not ported yet (ROADMAP A4)",
    "per_block": "execution='per_block' is not ported yet (ROADMAP A8)",
    "fused": "strategy='fused' is not ported yet (ROADMAP A8)",
}


@dataclasses.dataclass
class Meters:
    """Slow-tier byte counters (paper Table II, model units) + scheduling stats.

    ``peak_device_graph_bytes`` is the device-held edge topology in model
    units: at device residency, the whole graph.
    """

    bytes_read_edges: float = 0.0
    bytes_read_intervals: float = 0.0
    bytes_read_hubs: float = 0.0
    bytes_written_hubs: float = 0.0
    bytes_written_intervals: float = 0.0
    peak_device_graph_bytes: float = 0.0
    iterations: int = 0
    blocks_processed: int = 0
    blocks_skipped: int = 0
    edges_processed: int = 0
    wall_seconds: float = 0.0

    def model_dict(self) -> dict:
        """The modelled fields only (see :data:`MODEL_METER_FIELDS`)."""
        return {f: getattr(self, f) for f in MODEL_METER_FIELDS}

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
    fast tier; at device residency it drives the modelled meters only.
    """

    params: IOParams
    choice: StrategyChoice
    resident: frozenset
    residency: str = "device"
    execution: str = "packed_kernel"
    # "selective" iff the program is monotone and activity != "off".
    activity: str = "off"


@dataclasses.dataclass
class _RunContext:
    session: "GraphSession"
    program: VertexProgram
    choice: StrategyChoice
    resident: frozenset
    params: IOParams
    aux: dict
    valid: torch.Tensor  # (P, isz) bool
    tol: torch.Tensor
    K: int
    activity: str = "off"
    aux_batched: bool = False

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
    active tiles go to the kernel as an ascending index list (ascending
    keeps the full sweep's fold order), and an all-False window is a no-op.
    """
    sess, prog = ctx.session, ctx.program
    if window is None or window.all():
        return packed_sweep_update(
            prog, attrs_flat, acc, ctx.aux, tiles, row_active,
            sess.has_weights, ctx.aux_batched,
        )
    local = np.flatnonzero(window)
    if local.size == 0:
        return acc
    idx = torch.from_numpy(local.astype(np.int32)).to(sess.device)
    return packed_sweep_update(
        prog, attrs_flat, acc, ctx.aux, tiles, row_active, sess.has_weights,
        ctx.aux_batched, idx, int(local.size),
    )


def _iteration_packed(ctx: _RunContext, attrs, active, meters: Meters):
    """One update sweep for any of SPU/DPU/MPU.

    Meters from metadata → pre-iteration globals → accumulator init → tile
    sweep (compacted to the active tiles under selective execution) →
    batched apply. Returns the new ``(K, P, isz)`` attrs and the ``(K, P)``
    numpy map of changed intervals.
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
    # The JAX package's _pre_iteration vmaps over queries; the programs'
    # pre_iteration already reduces over the last axis, giving (K,) leaves.
    globals_ = prog.pre_iteration(attrs_flat, ctx.aux)
    ident = reduce_identity(prog.reduce, prog.dtype)
    acc = torch.full((K, g.n_pad), ident.item(), dtype=prog.dtype, device=sess.device)
    row_mask = np.zeros(g.P, dtype=bool)
    row_mask[rows] = True
    row_active = torch.from_numpy(row_mask).to(sess.device)
    selective = ctx.activity == "selective" and not row_mask.all()
    tile_active = sess._packed_tile_activity(row_mask) if selective else None
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


class _StagedGraph:
    """Staged state that is a pure function of the graph.

    Per-sub-shard edge and hub counts (the meters' metadata), and, per
    packing mode, the host :class:`PackedSweep`, its per-tile source spans
    and its device tiles (uploaded once per device).
    """

    def __init__(self, graph: DSSSGraph):
        self.graph = graph
        self.block_e = graph.density_matrix()
        self.block_u = graph.hub_counts()
        self.block_keys = frozenset(
            (int(i), int(j)) for i, j in zip(*np.nonzero(self.block_e))
        )
        self._packed_host: dict[str, Any] = {}
        self._packed_tiles: dict[tuple[str, torch.device], dict] = {}
        self._packed_spans: dict[str, tuple] = {}

    def packed_host(self, mode: str):
        """The host-side :class:`PackedSweep`, built once per mode."""
        packed = self._packed_host.get(mode)
        if packed is None:
            packed = self._packed_host[mode] = self.graph.packed_sweep(mode)
        return packed

    def packed_tiles(self, mode: str, device: torch.device) -> dict:
        """Device tile leaves and run index of one layout, uploaded once."""
        tiles = self._packed_tiles.get((mode, device))
        if tiles is None:
            packed = self.packed_host(mode)
            tiles = prepare_packed_tiles(
                packed, has_weights=packed.weights is not None, device=device
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


class GraphSession:
    """Staged graph state shared by every run.

    Args:
      graph: sharded :class:`DSSSGraph`.
      device: where the tiles and attributes live. ``None`` means CUDA,
        and raises when no CUDA device is present; pass ``"cpu"`` to run
        the plain versions of the kernels on the CPU.
      memory_budget: bytes of fast-tier memory (B_M); ``None`` = unlimited.
        It sets the SPU/DPU/MPU choice and the modelled meters.
      residency: ``"device"`` — the tile layout is uploaded once — or
        ``"auto"``, which means ``"host"`` when a ``memory_budget`` is set
        (not ported yet) and ``"device"`` otherwise.
      execution: ``"packed_kernel"`` or ``"auto"`` (the same): every sweep
        runs the tile-sweep kernel.
      packing: ``"adaptive"``, ``"subshard"`` or ``"auto"`` (subshard for
        ``src_sorted`` graphs, adaptive otherwise).
      Be: bytes per edge in the I/O model (+4 for weighted graphs).
      Bv: bytes per vertex id.
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
    ):
        _check_axis("residency", residency, ("device", "auto"), ("host", "disk"))
        _check_axis(
            "execution", execution, ("packed_kernel", "auto"), ("packed", "per_block")
        )
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
        self._staged = _StagedGraph(graph)
        self._residency: dict[int, frozenset] = {}  # Ba -> resident set
        self._compiled: dict[tuple, CompiledPlan] = {}

    @property
    def block_keys(self) -> frozenset:
        """Keys of the non-empty sub-shards."""
        return self._staged.block_keys

    def resolved_residency(self, override: str | None = None) -> str:
        """Resolve the residency axis; only ``"device"`` is ported."""
        mode = override or self.residency
        if mode == "auto":
            mode = "host" if self.memory_budget is not None else "device"
        if mode != "device":
            raise NotImplementedError(_NOT_PORTED.get(mode, mode))
        return mode

    def resolved_execution(self, strategy: str, override: str | None = None) -> str:
        """Resolve the execution axis; only ``"packed_kernel"`` is ported."""
        if strategy not in ("spu", "dpu", "mpu"):
            raise NotImplementedError(_NOT_PORTED.get(strategy, strategy))
        mode = override or self.execution
        if mode == "auto":
            mode = "packed_kernel"
        if mode != "packed_kernel":
            raise NotImplementedError(_NOT_PORTED.get(mode, mode))
        return mode

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
                execution=self.resolved_execution(choice.strategy, plan.execution),
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
            return select_strategy(params, self.memory_budget)
        if strategy in ("spu", "dpu", "mpu", "fused"):
            Q = self.graph.P
            if strategy == "dpu":
                Q = 0
            elif strategy == "mpu":
                Q = mpu_q(params, self.memory_budget or 0)
            return StrategyChoice(strategy, Q, 0.0, 0.0)
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
    def run(self, plan: ExecutionPlan) -> Result:
        """Execute one plan against the staged graph."""
        return self._execute(plan, [plan.kwargs_dict()]).results[0]

    def run_batch(self, plans: list[ExecutionPlan]) -> BatchResult:
        """Execute K plans in one sweep sequence when they fuse, else in turn.

        Plans fuse when they share a ``batch_key()`` and their aux is
        identical or stackable; results are identical either way.
        """
        if not plans:
            return BatchResult([], Meters(), 0, True, True)
        if self._fusable(plans):
            return self._execute(plans[0], [p.kwargs_dict() for p in plans])
        meters = Meters()
        results = [self.run(p) for p in plans]
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

    def _execute(self, plan: ExecutionPlan, kwargs_list: list[dict]) -> BatchResult:
        g = self.graph
        prog = plan.program
        compiled = self.compile(plan)
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
        # Device residency: the whole topology is on the device.
        meters.peak_device_graph_bytes = float(
            sum(int(self._staged.block_e[k]) for k in self.block_keys) * self.Be
        )
        ctx = _RunContext(
            session=self,
            program=prog,
            choice=compiled.choice,
            resident=compiled.resident,
            params=compiled.params,
            aux=aux,
            valid=(torch.arange(g.n_pad, device=dev) < g.n).reshape(g.P, isz),
            tol=torch.tensor(plan.tol, dtype=torch.float32, device=dev),
            K=K,
            activity=compiled.activity,
            aux_batched=aux_batched,
        )
        converged_at: list[int | None] = [
            0 if not active[m].any() else None for m in range(K)
        ]
        sweeps = 0
        activity_log: list[np.ndarray] = []
        start = time.perf_counter()
        for _ in range(plan.max_iters):
            if not active.any():
                break
            # The sweep's processed-interval bitmap, before it moves on.
            if compiled.activity == "selective":
                activity_log.append(active.any(axis=0).copy())
            else:
                activity_log.append(np.ones(g.P, dtype=bool))
            attrs, active = _iteration_packed(ctx, attrs, active, meters)
            sweeps += 1
            meters.iterations += 1
            for m in range(K):
                if converged_at[m] is None and not active[m].any():
                    converged_at[m] = sweeps
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        meters.wall_seconds = time.perf_counter() - start
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


def _check_axis(name: str, value: str, ported: tuple, later: tuple) -> None:
    if value in ported:
        return
    if value in later:
        raise NotImplementedError(_NOT_PORTED[value])
    raise ValueError(f"{name} must be one of {ported + later}, got {value!r}")
