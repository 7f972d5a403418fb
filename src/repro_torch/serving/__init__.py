"""repro_torch.serving — async graph-query serving on top of GraphSession.

Port of ``repro.serving``: a bounded request queue, a dynamic
micro-batcher that fuses compatible point queries (BFS reachability,
personalized PageRank, SSSP distances) into single
:meth:`~repro_torch.core.session.GraphSession.run_batch` passes — each one
sweep sequence through kernel B1 on the card — admission control against
the three-level memory budget, and a multi-graph :class:`SessionPool`
whose cold graphs page in from ``.dsss`` containers.

Quickstart::

    pool = SessionPool(capacity_bytes=1 << 30)
    pool.register("tw", "twitter.dsss", memory_budget=1 << 28)
    server = GraphServer(pool, max_batch=16, max_wait_ms=2.0)
    results = server.serve(
        [QueryRequest("tw", ExecutionPlan(BFS(), program_kwargs={"root": r}))
         for r in roots]
    )
    print(server.stats().qps, server.stats().mean_occupancy)

Sessions open on the CUDA card unless a graph is registered with
``device="cpu"``; the pool and the server pass ``device`` through and
never choose it. Every delivered result is bit-identical to a solo
``session.run(plan)`` and carries this request's exact share of the fused
batch's meters.

Degradation knobs: ``QueryRequest(deadline_s=..., max_retries=...)``
sheds/cancels past-deadline requests at sweep boundaries
(:class:`~repro_torch.reliability.faults.DeadlineExceeded` to the waiter,
``ServerStats.timeouts``) and re-runs transiently faulted batches with
backoff; ``SessionPool(breaker_threshold=...)`` sheds persistently
failing graphs via :class:`CircuitOpenError` until a cooldown expires.

The LM token-generation demo lives in :mod:`repro_torch.serving.llm_demo`
(import it explicitly); this package's public API is graph serving only.
"""
from repro_torch.reliability.faults import DeadlineExceeded, TransientFault
from repro_torch.serving.api import (
    AdmissionError,
    QueryRequest,
    QueryResult,
    RequestTiming,
    ServerStats,
    split_meters,
)
from repro_torch.serving.pool import CircuitOpenError, PoolStats, SessionPool
from repro_torch.serving.server import GraphServer, estimate_inflight_bytes

__all__ = [
    "AdmissionError",
    "CircuitOpenError",
    "DeadlineExceeded",
    "GraphServer",
    "PoolStats",
    "QueryRequest",
    "QueryResult",
    "RequestTiming",
    "ServerStats",
    "SessionPool",
    "TransientFault",
    "estimate_inflight_bytes",
    "split_meters",
]
