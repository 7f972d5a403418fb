"""Request/result schema for graph-query serving (port of ``repro.serving.api``).

A :class:`QueryRequest` names a graph (a :class:`~repro_torch.serving.pool.
SessionPool` key, or a :class:`~repro_torch.core.dsss.DSSSGraph` object that the
pool auto-registers) and carries one frozen
:class:`~repro_torch.core.plan.ExecutionPlan` — the same hashable job
description ``session.run`` takes, so anything runnable solo is servable.
The server answers with a :class:`QueryResult`: the per-query
:class:`~repro_torch.core.session.Result` (bit-identical to a solo
``session.run(plan)``), this request's *share* of the fused batch's
:class:`~repro_torch.core.session.Meters`, the occupancy of the batch it rode,
and its enqueue→dispatch→complete timing.

Meter shares (:func:`split_meters`): ``run_batch`` charges edge bytes once
for the shared streamed pass and interval/hub bytes K× (each query owns
its attribute state), all into one batch-level ``Meters``. A share divides
every additive field by K such that the K shares recombine *exactly* —
integer fields by ``divmod`` (the first ``remainder`` shares carry one
extra), byte fields (integral floats) the same way, and residual float
fields (``wall_seconds``) by assigning the last share the exact remainder
of the running sum. ``peak_device_graph_bytes`` is a high-water mark, not
a flow: every share reports the batch peak, and ``Meters.merge`` (which
maxes that field) reconstructs the batch meters field-for-field.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import Meters, Result

__all__ = [
    "AdmissionError",
    "QueryRequest",
    "QueryResult",
    "RequestTiming",
    "ServerStats",
    "split_meters",
]


class AdmissionError(RuntimeError):
    """The server refused a request (queue full under the reject policy)."""


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One point query: which graph, and what job to run on it.

    ``graph`` is a pool key (``str``) or a ``DSSSGraph`` object —
    object-valued graphs are auto-registered in the server's pool by
    identity. ``plan`` is the frozen job description; requests whose
    ``(graph, plan.batch_key())`` agree are candidates for fusion into one
    ``run_batch`` pass (they may differ only in Initialize kwargs, e.g.
    BFS roots).

    ``deadline_s`` is a soft per-request budget measured from enqueue:
    once exceeded the server sheds the request from the queue, or — if it
    is already riding a batch — cancels the batch cooperatively at the
    next sweep boundary and re-runs the surviving members. The waiter
    receives :class:`~repro_torch.reliability.faults.DeadlineExceeded`;
    ``ServerStats.timeouts`` counts it. ``max_retries`` bounds how many
    times the server re-runs this request's batch after a
    :class:`~repro_torch.reliability.faults.TransientFault` (a fused batch
    retries under the *smallest* member budget).
    """

    graph: Any
    plan: ExecutionPlan
    deadline_s: float | None = None
    max_retries: int = 0

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be ≥ 0")


@dataclasses.dataclass
class RequestTiming:
    """Monotonic timestamps of one request's life cycle (seconds)."""

    enqueued: float = 0.0
    dispatched: float = 0.0
    completed: float = 0.0

    @property
    def queue_s(self) -> float:
        """Time spent waiting in the batcher's queue."""
        return self.dispatched - self.enqueued

    @property
    def run_s(self) -> float:
        """Dispatch→complete time of the batch this request rode."""
        return self.completed - self.dispatched

    @property
    def total_s(self) -> float:
        return self.completed - self.enqueued


@dataclasses.dataclass
class QueryResult:
    """A served query: the solo-identical result plus serving metadata."""

    request_id: int
    graph: str  # resolved pool key
    result: Result  # bit-identical to session.run(plan)
    meters: Meters  # this request's share of the batch meters
    batch_size: int  # occupancy of the dispatched batch
    fused: bool  # False if the batch fell back to sequential runs
    timing: RequestTiming

    @property
    def output(self):
        return self.result.output

    @property
    def attrs(self):
        return self.result.attrs


@dataclasses.dataclass
class ServerStats:
    """A point-in-time snapshot of the server's counters.

    ``qps`` is completed requests over the first-enqueue→last-completion
    window; ``mean_occupancy`` is requests-per-dispatched-batch (the
    micro-batching win: occupancy K means edge bytes were paid once for K
    queries). ``meters`` accumulates every batch's meters via
    ``Meters.merge`` — its edge bytes divided by ``completed`` is the
    served cost per query. ``peak_inflight_bytes`` is the admission
    controller's high-water mark of concurrently admitted in-flight
    bytes (device topology + attribute state, model units) and stays
    ≤ ``inflight_capacity`` whenever every batch fits capacity alone
    (``admission_overflows`` counts the documented solo-run exceptions).
    """

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    timeouts: int = 0  # requests shed/cancelled past their deadline_s
    retries: int = 0  # batch re-runs after a TransientFault
    breaker_sheds: int = 0  # requests shed by an open circuit breaker
    slow_batches: int = 0  # batches the straggler watchdog flagged
    batches: int = 0
    fused_batches: int = 0
    batched_requests: int = 0
    max_occupancy: int = 0
    queue_depth: int = 0
    inflight_bytes: float = 0.0
    peak_inflight_bytes: float = 0.0
    admission_overflows: int = 0
    qps: float = 0.0
    mean_queue_s: float = 0.0
    mean_run_s: float = 0.0
    mean_total_s: float = 0.0
    max_total_s: float = 0.0
    # Estimated from the server's fixed-bucket latency histogram
    # (repro_torch.obs.DEFAULT_LATENCY_BUCKETS) — exact at bucket edges.
    p50_total_s: float = 0.0
    p95_total_s: float = 0.0
    p99_total_s: float = 0.0
    meters: Meters = dataclasses.field(default_factory=Meters)
    pool: Any = None  # PoolStats of the backing SessionPool

    #: Monotone request/batch tallies — published as ``repro_serving_
    #: <field>_total`` counters.
    COUNTER_FIELDS = (
        "submitted", "completed", "rejected", "failed", "timeouts",
        "retries", "breaker_sheds", "slow_batches", "batches",
        "fused_batches", "batched_requests", "admission_overflows",
    )
    #: Point-in-time levels/derived rates — published as ``repro_serving_
    #: <field>`` gauges.
    GAUGE_FIELDS = (
        "max_occupancy", "queue_depth", "inflight_bytes",
        "peak_inflight_bytes", "qps", "mean_queue_s", "mean_run_s",
        "mean_total_s", "max_total_s", "p50_total_s", "p95_total_s",
        "p99_total_s",
    )

    @property
    def mean_occupancy(self) -> float:
        return self.batched_requests / self.batches if self.batches else 0.0

    def to_metrics(self, registry=None) -> None:
        """Publish this snapshot into ``registry`` (default: process-wide).

        Snapshot-set semantics: every serving series is *set* to the
        snapshot's value rather than incremented, so a ``/metrics``
        scrape taken right after ``to_metrics`` reads numbers equal to
        this object field-for-field (``GraphServer`` wires this as the
        telemetry endpoint's ``on_scrape`` hook — the CI consistency
        gate relies on the equality). The accumulated serving ``meters``
        go out as ``repro_serving_meters_total{field=...}``, one series
        per :class:`~repro_torch.core.session.Meters` field, so per-request
        ``split_meters`` shares provably re-sum to the scraped totals.
        """
        from repro_torch.obs.registry import REGISTRY

        reg = registry if registry is not None else REGISTRY
        for f in self.COUNTER_FIELDS:
            reg.counter(
                f"repro_serving_{f}_total", f"ServerStats.{f} snapshot"
            ).set(getattr(self, f))
        for f in self.GAUGE_FIELDS:
            reg.gauge(
                f"repro_serving_{f}", f"ServerStats.{f} snapshot"
            ).set(getattr(self, f))
        reg.gauge(
            "repro_serving_mean_occupancy", "Requests per dispatched batch"
        ).set(self.mean_occupancy)
        meters_fam = reg.counter(
            "repro_serving_meters_total",
            "Accumulated serving Meters, by field",
            ("field",),
        )
        for f in dataclasses.fields(Meters):
            meters_fam.labels(field=f.name).set(
                float(getattr(self.meters, f.name))
            )
        if self.pool is not None and hasattr(self.pool, "to_metrics"):
            self.pool.to_metrics(reg)


def _split_integral(total: int, k: int) -> list[int]:
    q, r = divmod(int(total), k)
    return [q + 1 if i < r else q for i in range(k)]


def split_meters(total: Meters, k: int) -> list[Meters]:
    """Split one batch-level ``Meters`` into K per-request shares.

    Recombining the shares with ``Meters.merge`` reproduces ``total``
    exactly for every integer field and every byte field (bytes are
    integral floats — ``e·Be`` / ``interval_size·Ba`` charges — and split
    by ``divmod``, whose parts sum exactly); the
    ``peak_device_graph_bytes`` high-water mark is replicated (``merge``
    maxes it). The only non-integral field, ``wall_seconds``, gives the
    last share the remainder of the running sum — exact up to one final
    rounding.
    """
    if k <= 0:
        raise ValueError("k must be positive")
    shares = [Meters() for _ in range(k)]
    for f in dataclasses.fields(Meters):
        v = getattr(total, f.name)
        if f.name == "peak_device_graph_bytes":
            for s in shares:
                setattr(s, f.name, v)
        elif isinstance(v, int):
            for s, part in zip(shares, _split_integral(v, k)):
                setattr(s, f.name, part)
        elif float(v).is_integer() and abs(v) < 2**53:
            for s, part in zip(shares, _split_integral(int(v), k)):
                setattr(s, f.name, float(part))
        else:
            per = v / k
            acc = 0.0
            for s in shares[:-1]:
                setattr(s, f.name, per)
                acc += per
            setattr(shares[-1], f.name, v - acc)
    return shares
