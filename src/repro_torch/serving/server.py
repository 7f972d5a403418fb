"""GraphServer — asyncio request queue, dynamic micro-batching, admission
(port of ``repro.serving.server``).

The serving loop that feeds :meth:`GraphSession.run_batch`:

* **Queue**: ``submit`` places a :class:`~repro_torch.serving.api.QueryRequest`
  into a compatibility bucket keyed by ``(graph, plan.batch_key())`` —
  reusing :class:`~repro_torch.core.plan.ExecutionPlan` hashability — and
  returns a future. The queue is bounded (``max_queue``): beyond it,
  ``queue_policy="reject"`` raises :class:`AdmissionError` (shed load),
  ``"wait"`` backpressures the submitter until a slot frees.
* **Micro-batcher**: a dispatcher task drains the *largest* bucket first
  (maximizing fused occupancy, like the seed LLM batcher), waiting up to
  ``max_wait_ms`` for a partially filled bucket to grow before cutting a
  batch of ≤ ``max_batch`` requests. Each batch is one
  ``session.run_batch(plans)`` call — K point queries ride one streamed
  pass, edge bytes paid once (``run_batch`` itself re-verifies aux-level
  fusability and falls back to sequential runs if e.g. two PageRank
  plans froze different damping aux; results are identical either way).
* **Admission control**: before a batch runs, its in-flight byte estimate
  (:func:`estimate_inflight_parts` — the session's three-level-budget
  resident set / packed stream plan for device topology, plus
  ``2·n_pad·Ba·K`` attribute state) must fit ``inflight_capacity``
  alongside already-running batches, or the batch waits. The topology
  term is charged *once per graph* across concurrently admitted batches
  (the pinned tiles / stream ring are shared session staging), so
  frontier-bounded point queries on one graph don't each reserve the
  full placement and spuriously serialize. A batch larger than the whole
  capacity runs *alone* (counted in ``admission_overflows``) — capacity
  bounds concurrency; the per-run working set is already bounded by each
  session's ``memory_budget``.
* **Sessions**: graphs come from a :class:`~repro_torch.serving.pool.
  SessionPool`; a per-graph lock serializes batches on one session
  (``GraphSession`` run state is not reentrant) while different graphs
  run concurrently, up to ``max_concurrent`` executor threads. On the
  card each thread queues on its own current stream, and every copy
  stream, ring and staging slot belongs to one session; the first thread
  to touch a kernel builds it while the others wait on the build lock.

* **Graceful degradation**: requests may carry a ``deadline_s`` budget
  (measured from enqueue) and a ``max_retries`` transient-fault budget.
  Expired requests are shed from the queue before dispatch; a request
  that expires *mid-run* cancels its batch cooperatively at the next
  sweep boundary (``session.run`` checks a ``cancel`` callback between
  sweeps — no partial sweep is ever observable) and the surviving
  members re-run. :class:`~repro_torch.reliability.faults.TransientFault`
  escalating out of the fetch layer's own bounded retries triggers a
  batch re-run with backoff, up to the smallest member budget. Failures
  feed the pool's per-graph circuit breaker
  (:class:`~repro_torch.serving.pool.CircuitOpenError` sheds instantly while
  open), and a :class:`~repro_torch.reliability.faults.StragglerWatchdog`
  flags anomalously slow batches into ``ServerStats.slow_batches``.

``serve(requests)`` is the synchronous convenience wrapper (start →
submit all → gather → drain → stop); long-running callers use
``async with GraphServer(...) as srv: await srv.submit(...)``.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import functools
import time
from collections import OrderedDict
from typing import Sequence

from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import BatchResult, GraphSession, Meters
from repro_torch.obs.http import TelemetryServer
from repro_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    HistogramValue,
    REGISTRY as _REGISTRY,
)
from repro_torch.obs.trace import TRACER as _TRACER
from repro_torch.reliability.faults import (
    DeadlineExceeded,
    StragglerWatchdog,
    TransientFault,
)
from repro_torch.serving.api import (
    AdmissionError,
    QueryRequest,
    QueryResult,
    RequestTiming,
    ServerStats,
    split_meters,
)
from repro_torch.serving.pool import CircuitOpenError, SessionPool

__all__ = ["GraphServer", "estimate_inflight_bytes", "estimate_inflight_parts"]

# Process-wide end-to-end request latency (enqueue → completion); each
# GraphServer additionally owns an ungated per-server HistogramValue for
# its own p50/p95/p99 so stats are not polluted across servers.
_OBS_LATENCY = _REGISTRY.histogram(
    "repro_serving_request_latency_seconds",
    "End-to-end serving request latency (enqueue to completion)",
)


def estimate_inflight_parts(
    session: GraphSession, plan: ExecutionPlan, k: int
) -> tuple[float, float]:
    """Model ``(topology, attribute)`` bytes a K-query batch keeps in flight.

    The split matters for admission: the topology term is a property of the
    *graph placement*, shared by every batch concurrently running on the
    same session (pinned tiles and stream buffers are staged once, not per
    batch), while the attribute term is genuinely per-batch state. The
    server therefore charges topology once per graph across concurrently
    admitted batches (see :meth:`GraphServer._admit`) — without the split,
    two frontier-bounded point queries on one big host-resident graph
    would each reserve the full pinned prefix and spuriously serialize.

    Topology follows the session's resolved placement — the same
    accounting that drives ``peak_device_graph_bytes``:

    * streamed residencies ("host"/"disk"), packed execution: the
      budget-pinned tile prefix plus the ≤2-chunk double-buffer ring
      (:meth:`GraphSession.packed_stream_plan`);
    * streamed residencies, per-block execution: the pinned resident set
      plus a two-block ring of the largest streamed block
      (:meth:`GraphSession._resolve_residency` semantics);
    * "device": the whole staged topology (``m·Be``).

    Attribute state is ``2·n_pad·Ba·K`` (ping-pong copies per query).
    All quantities are model units (``e·Be`` real edges), the same units
    as ``memory_budget`` and the meters, so admission accounting composes
    with the session's own budget enforcement. Both terms are upper
    bounds: a frontier-bounded selective run streams fewer chunks, never
    more.
    """
    compiled = session.compile(plan)
    g = session.graph
    ba = plan.program.attr_bytes
    attr = 2.0 * g.n_pad * ba * k
    if compiled.residency in ("host", "disk"):
        if compiled.execution in ("packed", "packed_kernel"):
            splan = session.packed_stream_plan(compiled.choice.strategy, ba)
            topo = splan.pin_model_bytes + 2.0 * splan.max_chunk_model_bytes
        else:
            host = session.host_blocks
            be = session.Be
            topo = float(
                sum(host[key]["e"] * be for key in compiled.resident)
            )
            streamed = [
                h["e"] * be
                for key, h in host.items()
                if key not in compiled.resident
            ]
            topo += 2.0 * max(streamed, default=0)
    else:
        topo = float(g.m * session.Be)
    return topo, attr


def estimate_inflight_bytes(
    session: GraphSession, plan: ExecutionPlan, k: int
) -> float:
    """Model bytes a K-query batch of ``plan`` keeps in flight on device.

    The standalone (single-batch) estimate:
    ``sum(estimate_inflight_parts(...))``. The server's admission ledger
    uses the parts directly so same-graph batches share the topology term.
    """
    topo, attr = estimate_inflight_parts(session, plan, k)
    return attr + topo


@dataclasses.dataclass
class _Pending:
    request: QueryRequest
    graph_key: str
    future: asyncio.Future
    timing: RequestTiming
    deadline_at: float | None = None  # perf_counter deadline, None = no budget


class GraphServer:
    """Async graph-query server over a :class:`SessionPool`.

    ``telemetry_port`` (e.g. ``0`` for an ephemeral port) attaches a
    scrapeable :class:`repro_torch.obs.TelemetryServer` for the server's
    lifetime: ``GET /metrics`` publishes a fresh :class:`ServerStats`/
    ``PoolStats`` snapshot and renders the process registry as Prometheus
    text; ``GET /healthz`` reports breaker state and queue depth (HTTP
    503 when degraded). ``None`` (default) starts no endpoint.
    """

    def __init__(
        self,
        pool: SessionPool | None = None,
        *,
        max_batch: int = 16,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        queue_policy: str = "reject",
        inflight_capacity: float | None = None,
        max_concurrent: int = 2,
        retry_backoff_s: float = 0.005,
        watchdog: StragglerWatchdog | None = None,
        telemetry_port: int | None = None,
        telemetry_host: str = "127.0.0.1",
    ):
        if queue_policy not in ("reject", "wait"):
            raise ValueError(
                f"queue_policy must be 'reject' or 'wait', got {queue_policy!r}"
            )
        if max_batch < 1 or max_queue < 1 or max_concurrent < 1:
            raise ValueError("max_batch, max_queue, max_concurrent must be ≥ 1")
        if retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be ≥ 0")
        self.pool = pool if pool is not None else SessionPool()
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.queue_policy = queue_policy
        self.inflight_capacity = inflight_capacity
        self.max_concurrent = max_concurrent
        self.retry_backoff_s = retry_backoff_s
        self.watchdog = watchdog if watchdog is not None else StragglerWatchdog()
        # Buckets: compatibility key -> FIFO of pending requests. Insertion
        # order of the OrderedDict breaks largest-bucket ties (oldest wins).
        self._buckets: "OrderedDict[tuple, list[_Pending]]" = OrderedDict()
        self._pending = 0
        self._next_id = 0
        self._running = False
        # Loop-bound runtime state (created in start(), per event loop).
        self._wakeup: asyncio.Event | None = None
        self._space: asyncio.Condition | None = None
        self._admit_cv: asyncio.Condition | None = None
        self._exec_sem: asyncio.Semaphore | None = None
        self._dispatcher: asyncio.Task | None = None
        self._tasks: set[asyncio.Task] = set()
        self._locks: dict[str, asyncio.Lock] = {}
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        # Counters (survive across start/stop cycles).
        self._inflight_bytes = 0.0
        # graph_key -> number of admitted batches currently holding that
        # graph's topology reservation. The first batch on a graph charges
        # the topology term; concurrent same-graph batches charge only
        # their attribute state (the pinned tiles / stream ring are shared
        # session staging, not per-batch allocations).
        self._graph_inflight: dict[str, int] = {}
        self._stats = ServerStats()
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._lat_queue = 0.0
        self._lat_run = 0.0
        self._lat_total = 0.0
        self._lat_max = 0.0
        # Per-server latency histogram (ungated standalone — always
        # records) backing stats().p50/p95/p99_total_s.
        self._lat_hist = HistogramValue(DEFAULT_LATENCY_BUCKETS)
        # Scrape endpoint: created here, not in start(), so /metrics and
        # /healthz survive serve() start/stop waves — CI curls counters
        # after a fault-injection wave has completed. Each scrape runs
        # publish_metrics first, so scraped serving series equal the
        # ServerStats snapshot by construction. telemetry_port=0 binds an
        # ephemeral port (read it back from server.telemetry.address).
        self.telemetry: TelemetryServer | None = None
        if telemetry_port is not None:
            self.telemetry = TelemetryServer(
                health_fn=self._health,
                on_scrape=self.publish_metrics,
                host=telemetry_host,
                port=telemetry_port,
            ).start()

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "GraphServer":
        if self._running:
            raise RuntimeError("server already started")
        self._running = True
        self._wakeup = asyncio.Event()
        self._space = asyncio.Condition()
        self._admit_cv = asyncio.Condition()
        self._exec_sem = asyncio.Semaphore(self.max_concurrent)
        self._locks = {}
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.max_concurrent, thread_name_prefix="graph-serve"
        )
        self._dispatcher = asyncio.create_task(self._dispatch_loop())
        return self

    async def stop(self) -> None:
        """Drain the queue, wait for in-flight batches, stop the dispatcher."""
        if not self._running:
            return
        self._running = False
        self._wakeup.set()
        await self._dispatcher
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        self._executor.shutdown(wait=True)
        self._dispatcher = None
        self._executor = None

    async def __aenter__(self) -> "GraphServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission ----------------------------------------------------------
    async def submit(self, request: QueryRequest) -> asyncio.Future:
        """Enqueue one request; resolves to a :class:`QueryResult`.

        Raises :class:`AdmissionError` immediately when the bounded queue
        is full under ``queue_policy="reject"``; awaits a slot under
        ``"wait"``.
        """
        if not self._running:
            raise RuntimeError("server is not started (use start()/serve())")
        if self._pending >= self.max_queue:
            if self.queue_policy == "reject":
                self._stats.rejected += 1
                raise AdmissionError(
                    f"queue full ({self._pending}/{self.max_queue} pending)"
                )
            async with self._space:
                await self._space.wait_for(lambda: self._pending < self.max_queue)
        graph_key = self.pool.resolve(request.graph)
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        pending = _Pending(
            request=request,
            graph_key=graph_key,
            future=asyncio.get_running_loop().create_future(),
            timing=RequestTiming(enqueued=now),
            deadline_at=(
                now + request.deadline_s
                if request.deadline_s is not None
                else None
            ),
        )
        key = (graph_key, request.plan.batch_key())
        self._buckets.setdefault(key, []).append(pending)
        self._pending += 1
        self._stats.submitted += 1
        self._wakeup.set()
        return pending.future

    def serve(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        """Synchronous convenience: run a fresh event loop over the batch.

        Submits every request (so the micro-batcher sees them together),
        gathers all results, drains and stops. Raises the first submit
        rejection / execution error.
        """

        async def _run():
            async with self:
                futures = [await self.submit(r) for r in requests]
                return list(await asyncio.gather(*futures))

        return asyncio.run(_run())

    # -- stats ---------------------------------------------------------------
    def stats(self) -> ServerStats:
        s = self._stats
        done = s.completed
        window = (
            (self._t_last - self._t_first)
            if (self._t_first is not None and self._t_last is not None)
            else 0.0
        )
        return dataclasses.replace(
            s,
            queue_depth=self._pending,
            inflight_bytes=self._inflight_bytes,
            qps=(done / window) if window > 0 else 0.0,
            mean_queue_s=self._lat_queue / done if done else 0.0,
            mean_run_s=self._lat_run / done if done else 0.0,
            mean_total_s=self._lat_total / done if done else 0.0,
            max_total_s=self._lat_max,
            p50_total_s=self._lat_hist.quantile(0.50),
            p95_total_s=self._lat_hist.quantile(0.95),
            p99_total_s=self._lat_hist.quantile(0.99),
            meters=dataclasses.replace(s.meters),
            pool=self.pool.stats(),
        )

    def publish_metrics(self, registry=None) -> ServerStats:
        """Snapshot-set this server's stats into the metrics registry.

        Wired as the telemetry endpoint's ``on_scrape`` hook, so every
        ``/metrics`` scrape reads serving counters equal to
        :meth:`stats` field-for-field. Returns the published snapshot.
        """
        snap = self.stats()
        snap.to_metrics(registry)
        return snap

    def _health(self) -> dict:
        """The ``/healthz`` document: degraded on open breakers or a
        saturated queue, ok otherwise."""
        pool = self.pool.stats()
        saturated = self._pending >= self.max_queue
        status = (
            "degraded" if (pool.breakers_open or saturated) else "ok"
        )
        return {
            "status": status,
            "running": self._running,
            "queue_depth": self._pending,
            "max_queue": self.max_queue,
            "breakers_open": pool.breakers_open,
            "inflight_bytes": self._inflight_bytes,
        }

    def shutdown_telemetry(self) -> None:
        """Stop the scrape endpoint (if one was started)."""
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None

    # -- dispatcher ----------------------------------------------------------
    def _largest_bucket_key(self) -> tuple | None:
        best, best_len = None, 0
        for key, bucket in self._buckets.items():
            if len(bucket) > best_len:
                best, best_len = key, len(bucket)
        return best

    async def _dispatch_loop(self) -> None:
        while True:
            if self._pending == 0:
                if not self._running:
                    return
                self._wakeup.clear()
                # Re-check under the cleared flag: a submit between the
                # check above and clear() has already re-set the event.
                if self._pending == 0 and not self._running:
                    return
                await self._wakeup.wait()
                continue
            key = self._largest_bucket_key()
            bucket = self._buckets[key]
            if (
                self._running
                and len(bucket) < self.max_batch
                and self.max_wait_ms > 0
            ):
                # Batching window: let co-submitted compatible requests
                # land before cutting the batch. One bounded sleep — the
                # queue keeps filling while previous batches execute, so
                # saturated servers cut full batches without waiting.
                await asyncio.sleep(self.max_wait_ms / 1000.0)
                key = self._largest_bucket_key()
                bucket = self._buckets[key]
            batch = bucket[: self.max_batch]
            del bucket[: len(batch)]
            if not bucket:
                del self._buckets[key]
            self._pending -= len(batch)
            if _TRACER.enabled:
                _TRACER.instant(
                    "batch_cut",
                    cat="serving",
                    args={
                        "graph": key[0],
                        "size": len(batch),
                        "pending": self._pending,
                    },
                )
            async with self._space:
                self._space.notify_all()
            task = asyncio.create_task(self._run_one_batch(key[0], batch))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    # -- admission -----------------------------------------------------------
    async def _admit(self, graph_key: str, topo: float, attr: float) -> float:
        """Reserve in-flight bytes for one batch; returns the charged amount.

        The charge is graph-aware: the topology term is charged only by the
        first concurrently admitted batch on ``graph_key`` — later
        same-graph batches ride the existing reservation and charge only
        their attribute state. ``charge()`` is re-evaluated inside the wait
        predicate *and* at charge time under the same condition lock, so a
        batch that waited while the topology holder finished correctly
        re-charges topology itself (no double-charge, no free ride).
        """

        def charge() -> float:
            shared = self._graph_inflight.get(graph_key, 0) > 0
            return attr + (0.0 if shared else topo)

        async with self._admit_cv:
            if self.inflight_capacity is not None:
                await self._admit_cv.wait_for(
                    lambda: self._inflight_bytes == 0.0
                    or self._inflight_bytes + charge() <= self.inflight_capacity
                )
                if charge() > self.inflight_capacity:
                    self._stats.admission_overflows += 1
            estimate = charge()
            self._graph_inflight[graph_key] = (
                self._graph_inflight.get(graph_key, 0) + 1
            )
            self._inflight_bytes += estimate
            self._stats.peak_inflight_bytes = max(
                self._stats.peak_inflight_bytes, self._inflight_bytes
            )
            return estimate

    async def _release(self, graph_key: str, estimate: float) -> None:
        async with self._admit_cv:
            left = self._graph_inflight.get(graph_key, 0) - 1
            if left > 0:
                self._graph_inflight[graph_key] = left
            else:
                self._graph_inflight.pop(graph_key, None)
            self._inflight_bytes -= estimate
            self._admit_cv.notify_all()

    # -- execution -----------------------------------------------------------
    def _session_lock(self, graph_key: str) -> asyncio.Lock:
        lock = self._locks.get(graph_key)
        if lock is None:
            lock = self._locks[graph_key] = asyncio.Lock()
        return lock

    def _shed_expired(self, batch: list[_Pending]) -> list[_Pending]:
        """Resolve every past-deadline member with ``DeadlineExceeded``;
        return the still-live remainder."""
        now = time.perf_counter()
        alive = []
        for p in batch:
            if p.deadline_at is not None and now >= p.deadline_at:
                self._stats.timeouts += 1
                if not p.future.done():
                    p.future.set_exception(
                        DeadlineExceeded(
                            f"request on {p.graph_key!r} exceeded its "
                            f"{p.request.deadline_s}s deadline"
                        )
                    )
            else:
                alive.append(p)
        return alive

    @staticmethod
    def _deadline_cancel(batch: list[_Pending]):
        """A between-sweeps ``cancel`` callback for the batch's soonest
        deadline (None when no member carries one).

        ``session.run`` invokes it on every sweep boundary — vertex state
        is always a whole number of sweeps, so a cancelled batch leaves
        nothing torn and its surviving members re-run bit-identically.
        """
        deadlines = [p.deadline_at for p in batch if p.deadline_at is not None]
        if not deadlines:
            return None
        soonest = min(deadlines)

        def cancel(sweep: int) -> None:
            if time.perf_counter() >= soonest:
                raise DeadlineExceeded(
                    f"deadline reached at sweep boundary {sweep}"
                )

        return cancel

    async def _run_one_batch(self, graph_key: str, batch: list[_Pending]) -> None:
        loop = asyncio.get_running_loop()
        estimate = 0.0
        admitted = False
        locked = False
        lock = self._session_lock(graph_key)
        try:
            batch = self._shed_expired(batch)
            if not batch:
                return  # everything expired while queued — no work to run
            async with self._exec_sem:
                # Open (or page in) the session off-loop: staging a cold
                # graph is real work. Pin it against pool eviction.
                try:
                    session = await loop.run_in_executor(
                        self._executor, self.pool.acquire, graph_key
                    )
                except CircuitOpenError as exc:
                    self._stats.breaker_sheds += len(batch)
                    for p in batch:
                        if not p.future.done():
                            p.future.set_exception(exc)
                    return
                try:
                    plans = [p.request.plan for p in batch]
                    topo, attr = estimate_inflight_parts(
                        session, plans[0], len(plans)
                    )
                    estimate = await self._admit(graph_key, topo, attr)
                    admitted = True
                    await lock.acquire()
                    locked = True
                    attempt = 0
                    while True:
                        batch = self._shed_expired(batch)
                        if not batch:
                            return  # every member expired while retrying
                        plans = [p.request.plan for p in batch]
                        t_dispatch = time.perf_counter()
                        for p in batch:
                            if p.timing.dispatched == 0.0:
                                p.timing.dispatched = t_dispatch
                        try:
                            bres = await loop.run_in_executor(
                                self._executor,
                                functools.partial(
                                    session.run_batch,
                                    plans,
                                    cancel=self._deadline_cancel(batch),
                                ),
                            )
                            break
                        except DeadlineExceeded:
                            # The soonest-deadline member expired mid-run;
                            # the sweep-boundary cancel threw the whole
                            # batch away cleanly. Loop: shed it, re-run
                            # the survivors from scratch.
                            continue
                        except TransientFault:
                            self.pool.record_failure(graph_key)
                            budget = min(
                                p.request.max_retries for p in batch
                            )
                            if attempt >= budget:
                                raise
                            attempt += 1
                            self._stats.retries += 1
                            await asyncio.sleep(self.retry_backoff_s * attempt)
                finally:
                    self.pool.release(graph_key)
            t_done = time.perf_counter()
            if _TRACER.enabled:
                _TRACER.record(
                    "serve_batch",
                    t_dispatch,
                    t_done,
                    cat="serving",
                    args={
                        "graph": graph_key,
                        "size": len(batch),
                        "fused": bres.fused,
                    },
                )
            self.pool.record_success(graph_key)
            if self.watchdog.update(self._stats.batches, t_done - t_dispatch):
                self._stats.slow_batches += 1
            self._t_last = t_done
            if bres.fused:
                shares = split_meters(bres.meters, len(batch))
            else:
                # Sequential fallback: each member already owns its run's
                # meters (their merge is exactly the batch meters).
                shares = [r.meters for r in bres.results]
            self._stats.batches += 1
            self._stats.fused_batches += int(bres.fused)
            self._stats.batched_requests += len(batch)
            self._stats.max_occupancy = max(
                self._stats.max_occupancy, len(batch)
            )
            self._stats.meters.merge(bres.meters)
            for i, p in enumerate(batch):
                p.timing.completed = t_done
                self._stats.completed += 1
                self._lat_queue += p.timing.queue_s
                self._lat_run += p.timing.run_s
                self._lat_total += p.timing.total_s
                self._lat_max = max(self._lat_max, p.timing.total_s)
                self._lat_hist.observe(p.timing.total_s)
                _OBS_LATENCY.observe(p.timing.total_s)
                self._next_id += 1
                result = QueryResult(
                    request_id=self._next_id,
                    graph=graph_key,
                    result=bres.results[i],
                    meters=shares[i],
                    batch_size=len(batch),
                    fused=bres.fused,
                    timing=p.timing,
                )
                if not p.future.done():
                    p.future.set_result(result)
        except Exception as exc:  # propagate to every waiter, keep serving
            if not isinstance(exc, TransientFault):
                # Transient faults already fed the breaker per attempt.
                self.pool.record_failure(graph_key)
            self._stats.failed += len(batch)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
        finally:
            if locked:
                lock.release()
            if admitted:
                await self._release(graph_key, estimate)

    # -- driver integration ----------------------------------------------------
    def serve_plans(
        self, graph, plans: Sequence[ExecutionPlan], **session_kwargs
    ):
        """Serve K plans against one graph; returns a ``BatchResult``.

        The driver-facing entry (``multi_bfs(..., server=...)``): each plan
        becomes an individual :class:`QueryRequest`, flows through the
        queue/batcher/admission machinery, and the delivered results are
        re-assembled into the same :class:`~repro_torch.core.session.BatchResult`
        shape ``session.run_batch`` returns — per-request meter shares
        merge back into the batch-level meters.
        """
        key = (
            self.pool.resolve(graph)
            if isinstance(graph, str)
            else self.pool.ensure(graph, **session_kwargs)
        )
        served = self.serve(
            [QueryRequest(graph=key, plan=plan) for plan in plans]
        )
        meters = Meters()
        for q in served:
            meters.merge(q.meters)
        return BatchResult(
            results=[q.result for q in served],
            meters=meters,
            iterations=max((q.result.iterations for q in served), default=0),
            converged=all(q.result.converged for q in served),
            fused=all(q.fused for q in served),
        )
