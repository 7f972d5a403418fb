"""Graph algorithms on the Session/Plan API (paper §IV tasks; port of ``repro.core.algorithms``).

``pagerank``, ``bfs``, ``wcc`` and ``sssp`` stage the graph into a cached
:class:`~repro_torch.core.session.GraphSession` (:func:`get_session`) and
run one :class:`~repro_torch.core.plan.ExecutionPlan`; repeated calls on
the same graph object re-use the staged state. ``multi_bfs`` and
``multi_sssp`` run K sources in one sweep sequence (``run_batch``).
``scc`` is the forward-backward colouring driver (trim, max-label forward
propagation, backward reachability): its repeated runs over two staged
sessions are the "stage once, run many" pattern the session exists for.

Every driver runs on the CUDA card unless ``device="cpu"`` is passed. A
``memory_budget`` under the default ``residency="auto"`` means host
residency: the budget is enforced and the edge topology it does not pin
streams from host memory every sweep (``residency="device"`` keeps the
budget a modelled one). ``multi_bfs``/``multi_sssp`` with ``server=`` (a
:class:`repro_torch.serving.GraphServer`) submit the K sources as point
queries to the server's micro-batcher, which fuses them back onto
``run_batch``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsss import DSSSGraph, build_dsss
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import (
    BatchResult,
    GraphSession,
    IdentityLRU,
    Result,
    get_session,
)
from repro_torch.core.vertex_programs import (
    BFS,
    INF_DEPTH,
    SSSP,
    WCC,
    MaxLabelForward,
    PageRank,
    ReachBackward,
)
from repro_torch.graph.preprocess import EdgeList

__all__ = ["pagerank", "bfs", "wcc", "sssp", "scc", "multi_bfs", "multi_sssp"]

Device = str | torch.device | None

# Sharded graphs by edge-list identity and P, so repeated driver calls on
# one EdgeList reach one DSSSGraph object, and so one cached session.
_DSSS_LRU = IdentityLRU(size=8)


def _as_graph(g: EdgeList | DSSSGraph, P: int) -> DSSSGraph:
    if isinstance(g, DSSSGraph):
        return g
    return _DSSS_LRU.get_or_build(g, (P,), lambda: build_dsss(g, P))


def _session(
    g, P: int, memory_budget, residency: str, execution: str, device: Device
) -> GraphSession:
    # Every axis is in get_session's variant key, so drivers called with
    # other knobs never share a session wrongly.
    return get_session(
        _as_graph(g, P),
        device=device,
        memory_budget=memory_budget,
        residency=residency,
        execution=execution,
    )


def pagerank(
    g: EdgeList | DSSSGraph,
    *,
    P: int = 8,
    iters: int = 20,
    damping: float = 0.85,
    tol: float = 0.0,
    strategy: str = "auto",
    memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    device: Device = None,
) -> Result:
    sess = _session(g, P, memory_budget, residency, execution, device)
    # tol=0 runs a fixed number of sweeps (the paper runs 10 PageRank sweeps).
    return sess.run(
        ExecutionPlan(
            PageRank(damping=damping), strategy=strategy, max_iters=iters, tol=tol
        )
    )


def bfs(
    g: EdgeList | DSSSGraph,
    root: int = 0,
    *,
    P: int = 8,
    strategy: str = "auto",
    memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    device: Device = None,
) -> Result:
    sess = _session(g, P, memory_budget, residency, execution, device)
    return sess.run(
        ExecutionPlan(
            BFS(),
            strategy=strategy,
            max_iters=sess.graph.n + 1,
            program_kwargs={"root": root},
        )
    )


def _multi(program, g, sources, P, strategy, memory_budget, residency, execution, server, device):
    sess = _session(g, P, memory_budget, residency, execution, device)
    plans = [
        ExecutionPlan(
            program,
            strategy=strategy,
            max_iters=sess.graph.n + 1,
            program_kwargs={"root": int(r)},
        )
        for r in sources
    ]
    if server is not None:
        # The server's pool opens its own session with the same axes and
        # device (it never picks the device itself).
        return server.serve_plans(
            sess.graph, plans, memory_budget=memory_budget, residency=residency,
            execution=execution, device=device,
        )
    return sess.run_batch(plans)


def multi_bfs(
    g: EdgeList | DSSSGraph,
    sources,
    *,
    P: int = 8,
    strategy: str = "auto",
    memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    server=None,
    device: Device = None,
) -> BatchResult:
    """BFS from K sources in one batched sweep sequence.

    The K depth frontiers advance together: each sweep reads the edges once
    (``meters.bytes_read_edges`` is one query's cost, not K×) and updates
    K attribute rows. With ``server=`` (a
    :class:`repro_torch.serving.GraphServer`) the K sources go through the
    server's queue and micro-batcher instead, and come back in the same
    ``BatchResult`` shape with identical per-query results.
    """
    return _multi(BFS(), g, sources, P, strategy, memory_budget, residency,
                  execution, server, device)


def wcc(
    g: EdgeList | DSSSGraph,
    *,
    P: int = 8,
    strategy: str = "auto",
    memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    device: Device = None,
) -> Result:
    """Weakly connected components by min-label propagation.

    WCC is defined on the undirected graph, so it runs on a symmetrized
    edge set. An :class:`EdgeList` is symmetrized here before sharding; a
    :class:`DSSSGraph` must be symmetric already (``build_dsss(
    el.symmetrized(), P)``), and an asymmetric one raises
    :class:`ValueError` rather than give per-direction pseudo-components.
    """
    if isinstance(g, EdgeList):
        # Built per call: a throwaway session, not an LRU slot, so the
        # staged state dies with the call.
        graph = build_dsss(g.symmetrized(), P)
        sess = GraphSession(
            graph,
            device=device,
            memory_budget=memory_budget,
            residency=residency,
            execution=execution,
        )
    else:
        graph = g
        if not np.array_equal(graph.in_degree, graph.out_degree):
            raise ValueError(
                "wcc requires a symmetrized graph; this DSSSGraph has "
                "in_degree != out_degree. Build it with "
                "build_dsss(edge_list.symmetrized(), P), or pass the "
                "EdgeList itself and let wcc symmetrize."
            )
        sess = get_session(
            graph,
            device=device,
            memory_budget=memory_budget,
            residency=residency,
            execution=execution,
        )
    return sess.run(ExecutionPlan(WCC(), strategy=strategy, max_iters=graph.n + 1))


def sssp(
    g: EdgeList | DSSSGraph,
    root: int = 0,
    *,
    P: int = 8,
    strategy: str = "auto",
    memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    device: Device = None,
) -> Result:
    sess = _session(g, P, memory_budget, residency, execution, device)
    return sess.run(
        ExecutionPlan(
            SSSP(),
            strategy=strategy,
            max_iters=sess.graph.n + 1,
            program_kwargs={"root": root},
        )
    )


def multi_sssp(
    g: EdgeList | DSSSGraph,
    sources,
    *,
    P: int = 8,
    strategy: str = "auto",
    memory_budget: int | None = None,
    residency: str = "auto",
    execution: str = "auto",
    server=None,
    device: Device = None,
) -> BatchResult:
    """Shortest paths from K sources in one batched sweep sequence.

    ``server=`` routes the K sources through the serving micro-batcher
    (see :func:`multi_bfs`).
    """
    return _multi(SSSP(), g, sources, P, strategy, memory_budget, residency,
                  execution, server, device)


def scc(
    el: EdgeList,
    *,
    P: int = 8,
    strategy: str = "auto",
    memory_budget: int | None = None,
    max_rounds: int = 10_000,
    device: Device = None,
) -> np.ndarray:
    """Strongly connected components by trim and forward-backward colouring.

    Returns ``labels (n,)``: ``labels[v]`` is the id of a canonical vertex
    of v's SCC (the largest id reaching v within its component).

    Rounds:
      0. *Trim*: peel vertices with no in- or out-edge within the live
         subgraph (each is its own SCC) until none is left (numpy, host).
      1. *Colour*: forward max-label propagation; ``color(v)`` is the
         largest live id that reaches v.
      2. *Roots*: the vertices with ``color(v) == v``.
      3. *Reach*: backward propagation (on the transpose) of a reach flag
         from the roots along same-colour edges. The reached vertices of
         colour c are exactly SCC(c); take them out and go to 0.

    Both graphs are staged once; every round re-uses the two sessions.
    """
    fwd = build_dsss(el, P)
    bwd = build_dsss(el.reversed(), P)
    n, n_pad = fwd.n, fwd.n_pad
    # Both graphs are built per call, so the sessions are local too.
    sess_fwd = GraphSession(fwd, device=device, memory_budget=memory_budget)
    sess_bwd = GraphSession(bwd, device=device, memory_budget=memory_budget)

    src, dst = el.src, el.dst
    mask = np.zeros(n_pad, np.int32)
    mask[:n] = 1
    labels = np.full(n, -1, np.int64)

    for _ in range(max_rounds):
        live = mask[:n].astype(bool)
        if not live.any():
            break
        # -- trim --------------------------------------------------------------
        while True:
            live_edge = live[src] & live[dst]
            out_deg = np.bincount(src[live_edge], minlength=n)
            in_deg = np.bincount(dst[live_edge], minlength=n)
            trivial = live & ((out_deg == 0) | (in_deg == 0))
            if not trivial.any():
                break
            ids = np.nonzero(trivial)[0]
            labels[ids] = ids
            live[ids] = False
        mask[:n] = live.astype(np.int32)
        if not live.any():
            break
        # -- colour ------------------------------------------------------------
        init_labels = np.full(n_pad, -INF_DEPTH, np.int32)
        init_labels[:n][live] = np.nonzero(live)[0].astype(np.int32)
        res = sess_fwd.run(
            ExecutionPlan(
                MaxLabelForward(),
                strategy=strategy,
                max_iters=n + 1,
                program_kwargs={"labels": init_labels, "mask": mask},
            )
        )
        colors = np.full(n_pad, -1, np.int32)
        colors[:n] = res.attrs
        # -- roots and backward reach ------------------------------------------
        seed = np.zeros(n_pad, np.int32)
        root_ids = np.nonzero(live & (colors[:n] == np.arange(n)))[0]
        seed[root_ids] = 1
        res_b = sess_bwd.run(
            ExecutionPlan(
                ReachBackward(),
                strategy=strategy,
                max_iters=n + 1,
                program_kwargs={"reach": seed, "colors": colors, "mask": mask},
            )
        )
        reached = (res_b.attrs > 0) & live
        labels[reached] = colors[:n][reached]
        live[reached] = False
        mask[:n] = live.astype(np.int32)
    if not (labels >= 0).all():
        raise RuntimeError(f"SCC driver did not finish within max_rounds={max_rounds}")
    return labels
