"""The port's graph serving (``repro_torch.serving``) against the JAX package's.

The cases of ``tests/test_serving.py`` and the serving and pool cases of
``tests/test_reliability.py``, on the same seeded graphs (n = 130, m = 800,
P = 4, weighted; a second unweighted one). Every graph is registered with
``device="cpu"``: the pool and the server pass it through to their sessions
and never pick a device themselves.

* Served results equal solo ``session.run`` bitwise, programs ×
  {spu, dpu} × {device, host, disk}; ``multi_bfs``/``multi_sssp`` with
  ``server=`` equal the direct batch; BFS/SSSP served equal the JAX
  package's solo runs.
* ``split_meters`` recombines exactly and equals the JAX package's shares.
* The batcher, admission (``estimate_inflight_parts`` equal to the JAX
  package's at each residency and execution), the session pool and its
  circuit breaker, deadlines and retries behave as the reference's tests
  require.
"""
import asyncio
import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro.serving as jsv  # noqa: E402
import repro.storage as js  # noqa: E402
from repro.core.session import Meters as JMeters  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402
from repro.serving.server import estimate_inflight_parts as j_parts  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core.algorithms import multi_bfs, multi_sssp  # noqa: E402
from repro_torch.core.session import MODEL_METER_FIELDS, Meters, get_session  # noqa: E402
from repro_torch.graph.generators import erdos_renyi as t_er  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify as t_densify  # noqa: E402
from repro_torch.reliability import FaultPlan  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionError,
    CircuitOpenError,
    DeadlineExceeded,
    GraphServer,
    QueryRequest,
    SessionPool,
    TransientFault,
    estimate_inflight_bytes,
    split_meters,
)
from repro_torch.serving.server import estimate_inflight_parts  # noqa: E402

CPU = {"device": "cpu"}
SERVE_KW = dict(residency="host", execution="per_block", memory_budget=4096, device="cpu")


def _pair(n=130, m=800, seed=7, P=4, weighted=True):
    """(JAX graph, port graph) from the same seeded edges."""
    src, dst = j_er(n, m, seed=seed)
    w = None
    if weighted:
        w = np.random.default_rng(seed).uniform(0.1, 2.0, size=len(src)).astype(np.float32)
    jg = jc.build_dsss(j_densify(src, dst, weights=w, drop_self_loops=True), P)
    tg = rt.build_dsss(t_densify(*t_er(n, m, seed=seed), weights=w, drop_self_loops=True), P)
    np.testing.assert_array_equal(jg.src, tg.src)
    return jg, tg


def _graph(**kw):
    return _pair(**kw)[1]


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def graph(pair):
    return pair[1]


@pytest.fixture(scope="module")
def graph2():
    return _graph(n=90, m=500, seed=11, weighted=False)


@pytest.fixture(scope="module")
def dsss_path(pair, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serving") / "g.dsss")
    js.write_dsss(pair[0], path)
    return path


def _plans(program, roots, max_iters, pkg=rt):
    if isinstance(program, (rt.PageRank, jc.PageRank)):
        return [pkg.ExecutionPlan(program, max_iters=5, tol=0.0) for _ in roots]
    return [pkg.ExecutionPlan(program, max_iters=max_iters, program_kwargs={"root": int(r)})
            for r in roots]


# ---------------------------------------------------------------------------
# Bit-identity: served ≡ solo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("residency", ["device", "host", "disk"])
@pytest.mark.parametrize("strategy", ["spu", "dpu"])
@pytest.mark.parametrize("program", [rt.PageRank(), rt.BFS(), rt.SSSP()], ids=["pagerank", "bfs", "sssp"])
def test_served_equals_solo(graph, dsss_path, residency, strategy, program):
    pool = SessionPool()
    budget = int(graph.m * 12 * 0.5)  # stream roughly half the topology
    if residency == "disk":
        pool.register("g", dsss_path, memory_budget=budget, host_memory_budget=budget, **CPU)
    else:
        pool.register("g", graph, memory_budget=budget, residency=residency, **CPU)
    server = GraphServer(pool, max_batch=8, max_wait_ms=1.0)
    plans = [dataclasses.replace(p, strategy=strategy) for p in _plans(program, [0, 3, 17, 42], graph.n + 1)]
    served = server.serve([QueryRequest("g", p) for p in plans])
    session = pool.session("g")
    assert session.resolved_residency() == residency and session.device.type == "cpu"
    for plan, q in zip(plans, served):
        solo = session.run(plan)
        np.testing.assert_array_equal(solo.attrs, q.result.attrs)
        assert solo.iterations == q.result.iterations and solo.converged == q.result.converged
    st = server.stats()
    assert st.completed == len(plans) and st.fused_batches >= 1


@pytest.mark.parametrize("program", ["bfs", "sssp"])
def test_served_equals_the_reference_solo(pair, program):
    jg, tg = pair
    roots = [0, 3, 17, 42]
    pool = SessionPool()
    key = pool.ensure(tg, **CPU)
    served = GraphServer(pool, max_batch=8, max_wait_ms=1.0).serve(
        [QueryRequest(key, p) for p in _plans(getattr(rt, program.upper())(), roots, tg.n + 1)])
    j_sess = jc.GraphSession(jg)
    for q, p in zip(served, _plans(getattr(jc, program.upper())(), roots, jg.n + 1, pkg=jc)):
        j = j_sess.run(p)
        np.testing.assert_array_equal(q.result.attrs, j.attrs)
        assert q.result.iterations == j.iterations


@pytest.mark.parametrize("driver", [multi_bfs, multi_sssp])
def test_multi_drivers_through_server_match_direct(graph, driver):
    roots = [1, 5, 9]
    direct = driver(graph, roots, P=graph.P, device="cpu")
    server = GraphServer(max_batch=8, max_wait_ms=1.0)
    via = driver(graph, roots, P=graph.P, device="cpu", server=server)
    assert len(via) == len(direct) and via.fused
    for a, b in zip(direct, via):
        np.testing.assert_array_equal(a.attrs, b.attrs)
        assert a.iterations == b.iterations
    # The server's pool opened the session on the device it was given.
    (name,) = server.pool.names()
    assert server.pool.session(name).device.type == "cpu"


# ---------------------------------------------------------------------------
# Meter shares
# ---------------------------------------------------------------------------
_TOTAL = dict(
    bytes_read_edges=70001.0, bytes_read_intervals=333.0, bytes_read_hubs=17.0,
    bytes_written_hubs=5.0, bytes_written_intervals=999.0, bytes_h2d=123457.0,
    bytes_disk_read=31.0, peak_device_graph_bytes=4096.0, iterations=7,
    blocks_processed=23, blocks_skipped=3, edges_processed=5471, wall_seconds=0.3,
)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_split_meters_exact_recombination(k):
    total = Meters(**_TOTAL)
    shares = split_meters(total, k)
    merged = Meters()
    for s in shares:
        merged.merge(s)
        assert s.peak_device_graph_bytes == total.peak_device_graph_bytes
    for f in dataclasses.fields(Meters):
        a, b = getattr(merged, f.name), getattr(total, f.name)
        if f.name == "wall_seconds":
            assert a == pytest.approx(b, rel=1e-12)
        else:
            assert a == b, f.name
    its = [s.iterations for s in shares]
    assert max(its) - min(its) <= 1
    # Share for share, the JAX package's split.
    j_shares = jsv.split_meters(JMeters(**_TOTAL), k)
    assert [dataclasses.asdict(s) for s in shares] == [dataclasses.asdict(s) for s in j_shares]
    with pytest.raises(ValueError):
        split_meters(total, 0)


def test_served_shares_sum_to_fused_batch(graph):
    pool = SessionPool()
    pool.register("g", graph, memory_budget=int(graph.m * 12 * 0.4), **CPU)
    server = GraphServer(pool, max_batch=8, max_wait_ms=1.0)
    served = server.serve([QueryRequest("g", p) for p in _plans(rt.BFS(), [0, 4, 8, 12, 16], graph.n + 1)])
    assert all(q.fused for q in served) and len({q.batch_size for q in served}) == 1
    batch_meters = served[0].result.meters
    assert batch_meters.bytes_h2d > 0  # a budget under "auto": host residency streams
    merged = Meters()
    for q in served:
        merged.merge(q.meters)
    for f in MODEL_METER_FIELDS + ("bytes_h2d", "bytes_disk_read"):
        assert getattr(merged, f) == getattr(batch_meters, f), f
    assert merged.peak_device_graph_bytes == batch_meters.peak_device_graph_bytes
    assert merged.wall_seconds == pytest.approx(batch_meters.wall_seconds, rel=1e-9)
    assert sum(q.meters.bytes_read_edges for q in served) == batch_meters.bytes_read_edges
    st = server.stats()
    assert st.meters.bytes_h2d == batch_meters.bytes_h2d


# ---------------------------------------------------------------------------
# Micro-batching
# ---------------------------------------------------------------------------
def _server(graph, **kw):
    pool = SessionPool()
    return GraphServer(pool, **kw), pool.ensure(graph, **CPU)


def test_compatible_queries_fuse(graph):
    server, key = _server(graph, max_batch=16, max_wait_ms=5.0)
    served = server.serve([QueryRequest(key, p) for p in _plans(rt.BFS(), range(8), graph.n + 1)])
    st = server.stats()
    assert st.batches == 1 and st.fused_batches == 1 and st.mean_occupancy == 8.0
    assert all(q.batch_size == 8 for q in served)


def test_max_batch_is_honored(graph):
    server, key = _server(graph, max_batch=4, max_wait_ms=1.0)
    served = server.serve([QueryRequest(key, p) for p in _plans(rt.BFS(), range(10), graph.n + 1)])
    assert all(q.batch_size <= 4 for q in served)
    assert server.stats().batches >= 3


def test_incompatible_queries_do_not_fuse(graph):
    server, key = _server(graph, max_batch=16, max_wait_ms=5.0)
    reqs = [QueryRequest(key, p) for p in _plans(rt.BFS(), [0, 1, 2], graph.n + 1)] + [
        QueryRequest(key, rt.ExecutionPlan(rt.PageRank(), max_iters=4, tol=0.0))]
    served = server.serve(reqs)
    assert server.stats().batches == 2  # one BFS bucket, one PageRank bucket
    assert served[0].batch_size == 3 and served[-1].batch_size == 1
    for q in served:
        assert q.timing.enqueued <= q.timing.dispatched <= q.timing.completed


def test_singleton_batch_reports_fused(graph):
    server, key = _server(graph, max_batch=4, max_wait_ms=0.0)
    [q] = server.serve([QueryRequest(key, rt.ExecutionPlan(rt.PageRank(), max_iters=3, tol=0.0))])
    assert q.fused and q.batch_size == 1


def test_checkpoint_keeps_requests_apart(graph, tmp_path):
    """The checkpoint spec is part of batch_key, so the batcher buckets by it."""
    server, key = _server(graph, max_batch=8, max_wait_ms=5.0)
    plans = _plans(rt.BFS(), [0, 1], graph.n + 1)
    ck = rt.CheckpointSpec(str(tmp_path / "c"), every=1)
    served = server.serve([QueryRequest(key, plans[0]),
                           QueryRequest(key, dataclasses.replace(plans[1], checkpoint=ck))])
    assert [q.batch_size for q in served] == [1, 1] and server.stats().batches == 2
    assert os.listdir(ck.directory)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------
def test_bounded_queue_rejects(graph):
    server, key = _server(graph, max_batch=4, max_wait_ms=500.0, max_queue=2)
    plans = _plans(rt.BFS(), range(3), graph.n + 1)

    async def scenario():
        async with server:
            f1 = await server.submit(QueryRequest(key, plans[0]))
            f2 = await server.submit(QueryRequest(key, plans[1]))
            with pytest.raises(AdmissionError):
                await server.submit(QueryRequest(key, plans[2]))
            return await asyncio.gather(f1, f2)

    r1, r2 = asyncio.run(scenario())
    assert r1.result.converged and r2.result.converged
    assert server.stats().rejected == 1


def test_bounded_queue_wait_policy_backpressures(graph):
    server, key = _server(graph, max_batch=2, max_wait_ms=0.0, max_queue=1, queue_policy="wait")
    plans = _plans(rt.BFS(), range(4), graph.n + 1)

    async def scenario():
        async with server:
            futures = [await server.submit(QueryRequest(key, p)) for p in plans]
            return await asyncio.gather(*futures)

    assert len(asyncio.run(scenario())) == 4
    assert server.stats().rejected == 0


def test_inflight_capacity_bounds_mixed_graph_load(graph, graph2):
    budget1 = int(graph.m * 12 * 0.25)
    budget2 = int(graph2.m * 8 * 0.25)
    pool = SessionPool()
    pool.register("a", graph, memory_budget=budget1, residency="host", **CPU)
    pool.register("b", graph2, memory_budget=budget2, residency="host", **CPU)
    k = 4
    plans_a = _plans(rt.BFS(), range(k), graph.n + 1)
    plans_b = _plans(rt.BFS(), range(k), graph2.n + 1)
    est_a = estimate_inflight_bytes(pool.session("a"), plans_a[0], k)
    est_b = estimate_inflight_bytes(pool.session("b"), plans_b[0], k)
    capacity = max(est_a, est_b) * 1.5  # too small for both at once
    server = GraphServer(pool, max_batch=k, max_wait_ms=1.0, inflight_capacity=capacity, max_concurrent=2)
    served = server.serve([QueryRequest("a", p) for p in plans_a] + [QueryRequest("b", p) for p in plans_b])
    st = server.stats()
    assert st.completed == 2 * k and st.admission_overflows == 0
    assert st.peak_inflight_bytes <= capacity
    for name, plans, est in (("a", plans_a, est_a), ("b", plans_b, est_b)):
        session = pool.session(name)
        attr = 2.0 * session.graph.n_pad * plans[0].program.attr_bytes * k
        for q in served:
            if q.graph == name:
                assert q.result.meters.peak_device_graph_bytes + attr <= est + 1e-9
    solo = pool.session("a").run(plans_a[0])
    np.testing.assert_array_equal(solo.attrs, served[0].result.attrs)


def test_same_graph_batches_charge_topology_once(graph):
    pool = SessionPool()
    pool.register("g", graph, memory_budget=int(graph.m * 12 * 0.5), residency="host", **CPU)
    server = GraphServer(pool, max_batch=1, max_wait_ms=0.0, max_concurrent=2)
    plans = _plans(rt.BFS(), [0, 3], graph.n + 1)
    served = server.serve([QueryRequest("g", p) for p in plans])
    assert len(served) == 2 and all(q.result.converged for q in served)
    topo, attr = estimate_inflight_parts(pool.session("g"), plans[0], 1)
    st = server.stats()
    assert st.batches == 2
    assert st.peak_inflight_bytes <= topo + 2 * attr + 1e-6
    assert st.inflight_bytes == 0.0


def test_oversized_batch_runs_alone(graph):
    pool = SessionPool()
    pool.register("g", graph, memory_budget=int(graph.m * 12 * 0.25), **CPU)
    server = GraphServer(pool, max_batch=4, max_wait_ms=1.0, inflight_capacity=1.0)
    served = server.serve([QueryRequest("g", p) for p in _plans(rt.BFS(), range(4), graph.n + 1)])
    assert len(served) == 4 and server.stats().admission_overflows >= 1


@pytest.mark.parametrize("residency", ["device", "host", "disk"])
@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_estimate_inflight_parts_equals_the_reference(pair, dsss_path, residency, execution):
    """Model units (e·Be): the JAX package's estimate at every residency, whatever B1 ships."""
    jg, tg = pair
    budget = int(tg.m * 12 * 0.3)
    j_exec = "packed" if execution == "packed_kernel" else execution
    if residency == "disk":
        t = rt.GraphSession.open(dsss_path, device="cpu", memory_budget=budget,
                                 host_memory_budget=budget // 2, execution=execution)
        j = jc.GraphSession.open(dsss_path, memory_budget=budget, host_memory_budget=budget // 2,
                                 execution=j_exec)
    else:
        t = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency=residency,
                            execution=execution)
        j = jc.GraphSession(jg, memory_budget=budget, residency=residency, execution=j_exec)
    for strategy in ("spu", "dpu", "mpu"):
        for prog, j_prog in ((rt.PageRank(), jc.PageRank()), (rt.BFS(), jc.BFS())):
            for k in (1, 8):
                got = estimate_inflight_parts(t, rt.ExecutionPlan(prog, strategy=strategy), k)
                want = j_parts(j, jc.ExecutionPlan(j_prog, strategy=strategy), k)
                assert got == want, (strategy, prog.name, k)
                assert estimate_inflight_bytes(t, rt.ExecutionPlan(prog, strategy=strategy), k) == sum(want)


# ---------------------------------------------------------------------------
# Session pool
# ---------------------------------------------------------------------------
def test_lazy_open_and_hits(graph):
    pool = SessionPool()
    pool.register("g", graph, **CPU)
    assert pool.stats().open_sessions == 0
    s1, s2 = pool.session("g"), pool.session("g")
    assert s1 is s2
    st = pool.stats()
    assert st.opens == 1 and st.hits == 1 and st.open_sessions == 1


def test_capacity_evicts_lru(graph, graph2):
    pool = SessionPool(capacity_bytes=1)
    pool.register("a", graph, **CPU)
    pool.register("b", graph2, **CPU)
    sa = pool.session("a")
    assert pool.stats().open_sessions == 1
    pool.session("b")
    st = pool.stats()
    assert st.evictions == 1 and st.open_sessions == 1
    assert pool.session("b").graph is graph2
    assert pool.session("a") is not sa
    assert pool.stats().opens == 3


def test_dsss_graph_pages_back_in_after_eviction(dsss_path):
    pool = SessionPool(capacity_bytes=None)
    pool.register("d", dsss_path, **CPU)
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=3, tol=0.0)
    before = pool.session("d").run(plan)
    assert pool.session("d").resolved_residency() == "disk"
    assert pool.evict("d") and pool.stats().open_sessions == 0
    after = pool.session("d").run(plan)
    np.testing.assert_array_equal(before.attrs, after.attrs)
    assert pool.stats().opens == 2


def test_in_use_sessions_are_never_evicted(graph, graph2):
    pool = SessionPool(capacity_bytes=1)
    pool.register("a", graph, **CPU)
    pool.register("b", graph2, **CPU)
    pool.acquire("a")
    pool.session("b")
    assert pool.stats().open_sessions == 2
    assert not pool.evict("a")
    pool.release("a")
    assert pool._entries["a"].session is None
    assert not pool.evict("a")


def test_max_open_bound():
    pool = SessionPool(max_open=2)
    for i in range(3):
        pool.register(f"g{i}", _graph(n=40, m=150, seed=i, P=2, weighted=False), **CPU)
        pool.session(f"g{i}")
    assert pool.stats().open_sessions == 2 and pool.stats().evictions == 1


def test_register_rejects_duplicates_and_bad_sources(graph):
    pool = SessionPool()
    pool.register("g", graph, **CPU)
    with pytest.raises(ValueError):
        pool.register("g", graph)
    with pytest.raises(TypeError):
        pool.register("bad", 123)
    with pytest.raises(KeyError):
        pool.resolve("missing")
    with pytest.raises(TypeError):
        pool.resolve(3.5)
    with pytest.raises(ValueError):
        SessionPool(breaker_threshold=0)
    assert pool.ensure(graph, **CPU) == pool.ensure(graph, **CPU) != pool.ensure(graph, device="cpu",
                                                                                 residency="host")


def test_staged_bytes_accounting(graph, dsss_path):
    pool = SessionPool()
    pool.register("mem", graph, **CPU)
    pool.register("disk", dsss_path, **CPU)
    mem_bytes = pool.session("mem").staged_host_bytes()
    assert mem_bytes > 0
    disk_sess = pool.session("disk")
    assert disk_sess.staged_host_bytes() <= mem_bytes
    assert pool.staged_bytes() == mem_bytes + disk_sess.staged_host_bytes()


def test_pool_stats_and_server_stats_publish(graph):
    """Snapshot-set publishing: the registry reads the stats field for field."""
    from repro_torch.obs import REGISTRY

    server, key = _server(graph, max_batch=4, max_wait_ms=0.0)
    server.serve([QueryRequest(key, p) for p in _plans(rt.BFS(), range(2), graph.n + 1)])
    snap = server.publish_metrics()
    assert REGISTRY.value("repro_serving_completed_total") == snap.completed == 2
    assert REGISTRY.value("repro_pool_open_sessions") == snap.pool.open_sessions == 1
    assert REGISTRY.value("repro_serving_meters_total", field="iterations") == snap.meters.iterations
    health = server._health()
    assert health["status"] == "ok" and health["queue_depth"] == 0


# ---------------------------------------------------------------------------
# get_session keying
# ---------------------------------------------------------------------------
def test_distinct_axes_get_distinct_sessions(graph):
    base = get_session(graph, **CPU)
    assert get_session(graph, **CPU) is base
    assert get_session(graph, residency="device", **CPU) is not base
    assert (get_session(graph, residency="device", execution="per_block", **CPU)
            is not get_session(graph, residency="device", **CPU))
    assert get_session(graph, memory_budget=1 << 16, **CPU) is not base


def test_host_memory_budget_is_keyed_and_validated(graph):
    with pytest.raises(ValueError, match="host_memory_budget"):
        get_session(graph, host_memory_budget=1 << 20, **CPU)


# ---------------------------------------------------------------------------
# Degradation: deadlines, retries, the circuit breaker
# ---------------------------------------------------------------------------
def test_expired_request_is_shed(graph):
    pool = SessionPool()
    key = pool.ensure(graph, **SERVE_KW)
    srv = GraphServer(pool)
    with pytest.raises(DeadlineExceeded):
        srv.serve([QueryRequest(key, rt.ExecutionPlan(rt.PageRank(), max_iters=50, tol=0.0),
                                deadline_s=1e-6)])
    st = srv.stats()
    assert st.timeouts == 1 and st.failed == 0


def test_midrun_cancel_leaves_others_unaffected(graph):
    pool = SessionPool()
    key = pool.ensure(graph, **SERVE_KW)

    async def go():
        async with GraphServer(pool, max_batch=1, max_wait_ms=0.0) as srv:
            doomed = await srv.submit(QueryRequest(
                key, rt.ExecutionPlan(rt.PageRank(), max_iters=5000, tol=0.0), deadline_s=0.05))
            fine = await srv.submit(QueryRequest(key, rt.ExecutionPlan(rt.BFS(), program_kwargs={"root": 0})))
            got = await asyncio.gather(doomed, fine, return_exceptions=True)
            return got, srv.stats()

    (doomed, fine), st = asyncio.run(go())
    assert isinstance(doomed, DeadlineExceeded) and not isinstance(fine, Exception)
    ref = rt.GraphSession(graph, **SERVE_KW).run(rt.ExecutionPlan(rt.BFS(), program_kwargs={"root": 0}))
    np.testing.assert_array_equal(fine.result.attrs, ref.attrs)
    assert st.timeouts == 1 and st.failed == 0


def test_transient_fault_retries_to_identical_result(graph):
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=4, tol=0.0)
    ref = rt.GraphSession(graph, **SERVE_KW).run(plan)
    pool = SessionPool()
    key = pool.ensure(graph, **SERVE_KW)
    # A burst deeper than the copy's own retry budget escapes to the
    # server's retry loop.
    pool.session(key).inject_faults(FaultPlan.h2d_transient(rate=1.0, times=5, seed=3))
    srv = GraphServer(pool)
    out = srv.serve([QueryRequest(key, plan, max_retries=3)])
    st = srv.stats()
    assert st.retries >= 1 and st.completed == 1 and st.failed == 0
    np.testing.assert_array_equal(out[0].result.attrs, ref.attrs)


def test_retry_budget_exhaustion_fails(graph):
    pool = SessionPool()
    key = pool.ensure(graph, **SERVE_KW)
    pool.session(key).inject_faults(FaultPlan.h2d_transient(rate=1.0, times=None, seed=1))
    srv = GraphServer(pool)
    with pytest.raises(TransientFault):
        srv.serve([QueryRequest(key, rt.ExecutionPlan(rt.PageRank(), max_iters=3), max_retries=1)])
    st = srv.stats()
    assert st.retries == 1 and st.failed == 1


def test_circuit_breaker_trips_and_recovers(graph):
    pool = SessionPool(breaker_threshold=2, breaker_cooldown_s=0.15)
    key = pool.ensure(graph, **SERVE_KW)
    sess = pool.session(key)
    sess.inject_faults(FaultPlan.h2d_transient(rate=1.0, times=None, seed=1))
    srv = GraphServer(pool)
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=3)
    for _ in range(2):
        with pytest.raises(TransientFault):
            srv.serve([QueryRequest(key, plan)])
    assert pool.breaker_open(key)
    with pytest.raises(CircuitOpenError):
        srv.serve([QueryRequest(key, plan)])
    assert srv.stats().breaker_sheds == 1 and pool.stats().breakers_open == 1
    assert srv._health()["status"] == "degraded"
    time.sleep(0.2)
    sess.inject_faults(None)  # the graph recovers
    assert len(srv.serve([QueryRequest(key, plan)])) == 1  # the half-open trial
    assert pool.stats().breakers_open == 0


def test_failed_halfopen_trial_retrips(graph):
    pool = SessionPool(breaker_threshold=2, breaker_cooldown_s=0.05)
    key = pool.ensure(graph, **SERVE_KW)
    pool.session(key).inject_faults(FaultPlan.h2d_transient(rate=1.0, times=None, seed=1))
    srv = GraphServer(pool)
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=3)
    for _ in range(2):
        with pytest.raises(TransientFault):
            srv.serve([QueryRequest(key, plan)])
    time.sleep(0.08)
    with pytest.raises(TransientFault):
        srv.serve([QueryRequest(key, plan)])
    assert pool.breaker_open(key)


def test_request_and_server_validation():
    for bad in (dict(deadline_s=0.0), dict(max_retries=-1)):
        with pytest.raises(ValueError):
            QueryRequest("g", rt.ExecutionPlan(rt.PageRank()), **bad)
    for bad in (dict(queue_policy="drop"), dict(max_batch=0), dict(retry_backoff_s=-1.0)):
        with pytest.raises(ValueError):
            GraphServer(**bad)


# ---------------------------------------------------------------------------
# Pool regressions: pinning, deferred eviction, race atomicity
# ---------------------------------------------------------------------------
def test_pinned_session_never_evicted(graph):
    pool = SessionPool(max_open=1)
    a = pool.ensure(graph, residency="host", **CPU)
    b = pool.ensure(_graph(seed=12), residency="host", **CPU)
    sess_a = pool.acquire(a)
    pool.session(b)
    assert pool._entries[a].session is sess_a
    pool.release(a)
    assert pool.stats().open_sessions == 1 and pool._entries[a].session is None


def test_release_drops_stale_staged_bytes(graph):
    pool = SessionPool(max_open=1)
    a = pool.ensure(graph, residency="host", **CPU)
    b = pool.ensure(_graph(seed=13), residency="host", **CPU)
    pool.acquire(a)
    pool.acquire(b)
    assert pool.stats().open_sessions == 2
    pool.release(a)
    assert pool.stats().open_sessions == 1 and pool._entries[b].session is not None


def test_double_release_raises_and_evict_respects_pin(graph):
    pool = SessionPool()
    a = pool.ensure(graph, **CPU)
    pool.acquire(a)
    assert pool.evict(a) is False
    pool.release(a)
    with pytest.raises(RuntimeError):
        pool.release(a)
    assert pool.evict(a) is True and pool.evict(a) is False


def test_acquire_evict_race_is_atomic():
    pool = SessionPool(max_open=1)
    keys = [pool.ensure(_graph(n=60, m=300, seed=20 + i), residency="host", **CPU) for i in range(3)]
    errors = []

    def hammer(key):
        try:
            for _ in range(25):
                s = pool.acquire(key)
                assert s is not None and pool._entries[key].session is s
                pool.release(key)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in keys]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert all(e.in_use == 0 for e in pool._entries.values())
    assert pool.stats().open_sessions <= 1


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------
def test_import_serving_is_cheap():
    """Graph serving drags in neither the LM stack nor JAX nor ``repro``."""
    code = (
        "import sys; import repro_torch.serving; "
        "assert 'repro_torch.models' not in sys.modules, 'models imported'; "
        "assert 'repro_torch.configs' not in sys.modules, 'configs imported'; "
        "assert 'repro_torch.serving.llm_demo' not in sys.modules, 'llm demo imported'; "
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=src))
