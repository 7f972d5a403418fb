"""Baseline update strategies the paper compares against (§III-C, §IV-B1; port of ``repro.core.baselines``).

1. **TurboGraph-like** (GridGraph's scheme too): no hubs; for every
   destination interval, *all* source intervals are loaded again from the
   slow tier. With the I/O-optimal partitioning ``P ≈ 2n·Ba/B_M`` a sweep
   reads ``m·Be + n·P·Ba`` and writes ``n·Ba``: linear in P, the scaling
   weakness of paper Fig. 6.

2. **GraphChi-like** (source-sorted, coarse-grained): the same engine over
   sub-shards that keep GraphChi's source-major edge order (the paper's
   Table IV ablation). :func:`build_graphchi_like` builds it; it runs
   through the normal session, tile-sweep kernel included.

The TurboGraph-like schedule is a registered custom strategy of
:class:`~repro_torch.core.session.GraphSession`, so it batches over
queries and meters like the native schedules. Its per-destination fold
order is SPU's (ascending source interval, each block through its hub
partial), so its results are SPU's, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsss import DSSSGraph, build_dsss
from repro_torch.core.engine import Meters, NXGraphEngine
from repro_torch.core.identities import reduce_identity
from repro_torch.core.session import (
    GraphSession,
    _apply_interval,
    _block_gather_reduce,
    _changed_map,
    _pre_iteration,
    _rows_to_process,
)
from repro_torch.graph.preprocess import EdgeList

__all__ = ["TurboGraphLikeEngine", "turbograph_like_partitions", "build_graphchi_like"]


def turbograph_like_partitions(n: int, Ba: int, B_M: int) -> int:
    """The strategy's I/O-optimal P: the smallest P with 2·(n/P)·Ba ≤ B_M."""
    return max(1, int(np.ceil(2 * n * Ba / max(B_M, 1))))


def build_graphchi_like(el: EdgeList, P: int) -> DSSSGraph:
    """Source-sorted sub-shards (GraphChi's PSW layout), the Table IV ablation."""
    return build_dsss(el, P, src_sorted=True)


def _iteration_turbograph(ctx, attrs, active, meters: Meters):
    """Column-major block-load schedule: every destination interval loads
    all of its source intervals again, the ``n·P·Ba`` term of §III-C."""
    sess, prog = ctx.session, ctx.program
    g = sess.graph
    isz = g.interval_size
    K = ctx.K
    globals_ = _pre_iteration(prog, attrs.reshape(K, -1), ctx.aux)
    ident = reduce_identity(prog.reduce, prog.dtype).item()
    rows = _rows_to_process(ctx, active)
    iv_bytes = isz * ctx.params.Ba * K
    # Column-major order; nothing is resident for this baseline, so the
    # fetcher charges every block every sweep.
    order = [(i, j) for j in range(g.P) for i in rows if (i, j) in ctx.block_keys]
    fetch = ctx.fetcher.begin(order)
    new_cols = []
    changed = {}
    for j in range(g.P):
        acc = torch.full((K, isz), ident, dtype=prog.dtype, device=sess.device)
        touched = False
        meters.bytes_read_intervals += iv_bytes  # load the destination interval
        for i in rows:
            if (i, j) not in ctx.block_keys:
                continue
            blk = fetch()
            # The source interval is loaded again for every (i, j) pair.
            meters.bytes_read_intervals += iv_bytes
            meters.blocks_processed += 1
            meters.edges_processed += blk["e"]
            acc = _block_gather_reduce(
                prog, attrs[:, i], ctx.aux_views[i],
                ctx.aux_views[j] if prog.needs_dst_aux else {},
                blk, acc, sess.has_weights, ctx.aux_batched,
            )
            touched = True
        if not touched and prog.monotone:
            new_cols.append(attrs[:, j])
            continue
        new_j, changed[j] = _apply_interval(
            prog, attrs[:, j], acc, ctx.aux_views[j], globals_,
            ctx.valid[j], ctx.tol, ctx.aux_batched,
        )
        new_cols.append(new_j)
        meters.bytes_written_intervals += iv_bytes
    return torch.stack(new_cols, dim=1), _changed_map(ctx, changed)


GraphSession.register_strategy("turbograph-like", _iteration_turbograph)


class TurboGraphLikeEngine(NXGraphEngine):
    """TurboGraph/GridGraph-style block-load schedule (paper §III-C).

    Walks the destination intervals; for each, loads every source interval
    and the sub-shard joining them. Gives SPU's results (same semiring, same
    fold order) and meters the strategy's ``n·P·Ba`` interval re-reads.
    ``memory_budget`` only parameterizes its modelled I/O formula.
    """

    def __init__(
        self,
        graph: DSSSGraph,
        program,
        *,
        memory_budget: int | None = None,
        Be: int | None = None,
        Bv: int | None = None,
        session: GraphSession | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__(
            graph,
            program,
            strategy="turbograph-like",
            memory_budget=None,
            Be=Be,
            Bv=Bv,
            session=session,
            device=device,
        )
        # One schedule, nothing resident between blocks.
        self.memory_budget = memory_budget
