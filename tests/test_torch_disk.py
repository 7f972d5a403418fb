"""Disk residency: the port against the JAX package's disk runs and its own device runs.

The matrix of ``tests/test_storage.py``'s disk tests, on one ``.dsss`` file
written by the JAX package and opened by both: SPU/DPU/MPU ×
``per_block``/``packed``/``packed_kernel`` (B1's plain version on the CPU),
``memory_budget=720`` (streaming, and a strict 0 < Q < P MPU split) and
``host_memory_budget=3000`` (part of the stream cached, part read).

* attrs bitwise equal to the port's device and host residency, PageRank
  included; BFS/SSSP/WCC bitwise equal to the JAX package's disk run,
  PageRank within ``rtol=1e-5`` over a fixed number of sweeps (the JAX
  package runs its ``"packed"`` scan: its fused kernel does not trace on
  the installed jax);
* model meters field-identical to the JAX package's, ``bytes_disk_read``
  equal to its and to the closed forms ``disk_read_bytes`` and
  ``packed_disk_bytes``; ``bytes_h2d`` equal to host residency's;
* an unlimited host cache reads nothing from the file; disk residency
  needs a store; a host override on a disk session charges no disk bytes;
  ``get_session(host_memory_budget=)`` and ``NXGraphEngine`` over a disk
  session; nothing edge-scale is held beyond the cache and the two slots.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro.storage as js  # noqa: E402
from repro.core.session import _host_block_nbytes as j_block_nbytes  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import iomodel as tio  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.kernels import packed_sweep as ps  # noqa: E402

BUDGET = 720
HOST_BUDGET = 3000
ITERS = 4


def _raw(weighted=True):
    src, dst = j_er(150, 900, seed=3)
    src = np.concatenate([src, src[:40], np.arange(8)])
    dst = np.concatenate([dst, dst[:40], np.arange(8)])
    w = None
    if weighted:
        w = np.random.default_rng(3).uniform(0.1, 2.0, size=len(src)).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """(JAX graph, the file's path, the port's graph from the file)."""
    src, dst, w = _raw()
    jg = jc.build_dsss(j_densify(src, dst, weights=w, drop_self_loops=True), 5)
    path = str(tmp_path_factory.mktemp("disk") / "g.dsss")
    js.write_dsss(jg, path)
    tg = rt.GraphSession.open(path, device="cpu").graph
    return jg, path, tg


def _open(path, **kw):
    return rt.GraphSession.open(path, device="cpu", **kw)


_J_RUNS: dict = {}


def _j_disk(path, plan_kw, host_budget=HOST_BUDGET):
    plan = jc.ExecutionPlan(**plan_kw)
    key = (path, plan, host_budget)
    if key not in _J_RUNS:
        sess = jc.GraphSession.open(path, memory_budget=BUDGET, host_memory_budget=host_budget)
        _J_RUNS[key] = (sess, sess.run(plan))
    return _J_RUNS[key]


def _model(m):
    return {k: v for k, v in dataclasses.asdict(m).items() if k in tsession.MODEL_METER_FIELDS}


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("execution", ["per_block", "packed", "packed_kernel"])
def test_pagerank_disk_matrix(staged, strategy, execution):
    jg, path, tg = staged
    plan = rt.ExecutionPlan(
        rt.PageRank(), strategy=strategy, max_iters=ITERS, tol=0.0, execution=execution
    )
    dev = rt.GraphSession(tg, device="cpu", memory_budget=BUDGET, residency="device").run(plan)
    host = rt.GraphSession(tg, device="cpu", memory_budget=BUDGET, residency="host").run(plan)
    sess = _open(path, memory_budget=BUDGET, host_memory_budget=HOST_BUDGET)
    assert sess.resolved_residency() == "disk"
    disk = sess.run(plan)
    np.testing.assert_array_equal(dev.attrs.view(np.int32), disk.attrs.view(np.int32))
    np.testing.assert_array_equal(host.attrs.view(np.int32), disk.attrs.view(np.int32))
    assert _model(dev.meters) == _model(host.meters) == _model(disk.meters)
    assert host.meters.bytes_h2d == disk.meters.bytes_h2d > 0
    assert dev.meters.bytes_disk_read == host.meters.bytes_disk_read == 0
    assert disk.meters.peak_device_graph_bytes == host.meters.peak_device_graph_bytes
    # The JAX package's disk run: the same model meters and disk bytes.
    j_exec = "per_block" if execution == "per_block" else "packed"
    jsess, jres = _j_disk(
        path, dict(program=jc.PageRank(), strategy=strategy, max_iters=ITERS, tol=0.0,
                   execution=j_exec),
    )
    assert _model(jres.meters) == _model(disk.meters)
    assert jres.meters.bytes_disk_read == disk.meters.bytes_disk_read > 0
    np.testing.assert_allclose(disk.attrs, jres.attrs, rtol=1e-5, atol=1e-8)
    # ... and the closed forms, exactly.
    compiled = sess.compile(plan)
    jc_compiled = jsess.compile(jc.ExecutionPlan(jc.PageRank(), strategy=strategy,
                                                 execution=j_exec))
    assert compiled.resident == jc_compiled.resident
    assert compiled.host_cached == jc_compiled.host_cached
    if execution == "per_block":
        nbytes = {k: tsession._host_block_nbytes(h) for k, h in sess.host_blocks.items()}
        assert nbytes == {k: j_block_nbytes(h) for k, h in jsess.host_blocks.items()}
        expect = tio.disk_read_bytes(nbytes, compiled.resident, compiled.host_cached)
    else:
        splan = sess.packed_stream_plan(compiled.choice.strategy, compiled.params.Ba)
        jplan = jsess.packed_stream_plan(compiled.choice.strategy, compiled.params.Ba)
        assert dataclasses.asdict(splan) == dataclasses.asdict(jplan)
        assert 0 < splan.host_tiles < splan.num_tiles - splan.pin_tiles
        expect = tio.packed_disk_bytes(
            splan.num_tiles - splan.pin_tiles - splan.host_tiles, splan.tile_edges,
            weighted=sess.has_weights,
        )
    assert disk.meters.bytes_disk_read == expect * disk.meters.iterations


@pytest.mark.parametrize("execution", ["per_block", "packed", "packed_kernel"])
@pytest.mark.parametrize(
    "program,kwargs",
    [("BFS", {"root": 0}), ("SSSP", {"root": 3}), ("WCC", {})],
)
def test_monotone_programs_bitwise_vs_the_reference_disk_run(staged, program, kwargs, execution):
    jg, path, tg = staged
    j_exec = "per_block" if execution == "per_block" else "packed"
    _, jres = _j_disk(
        path,
        dict(program=getattr(jc, program)(), strategy="mpu", max_iters=100,
             program_kwargs=kwargs, execution=j_exec),
        host_budget=0,
    )
    sess = _open(path, memory_budget=BUDGET, host_memory_budget=0)
    res = sess.run(rt.ExecutionPlan(
        getattr(rt, program)(), strategy="mpu", max_iters=100, program_kwargs=kwargs,
        execution=execution,
    ))
    np.testing.assert_array_equal(res.attrs.view(np.int32), np.asarray(jres.attrs).view(np.int32))
    assert _model(res.meters) == _model(jres.meters)
    assert res.meters.bytes_disk_read == jres.meters.bytes_disk_read > 0
    assert len(res.activity_log) == len(jres.activity_log)
    assert all(np.array_equal(a, b) for a, b in zip(res.activity_log, jres.activity_log))
    assert (res.iterations, res.converged) == (jres.iterations, jres.converged)


def test_bfs_batch_on_disk_equals_device(staged):
    _, path, tg = staged
    plans = [rt.ExecutionPlan(rt.BFS(), max_iters=100, program_kwargs={"root": r})
             for r in (0, 5, 9, 40)]
    disk = _open(path, memory_budget=0, host_memory_budget=0).run_batch(plans)
    dev = rt.GraphSession(tg, device="cpu", residency="device").run_batch(plans)
    assert disk.fused
    for a, b in zip(disk, dev):
        np.testing.assert_array_equal(a.attrs, b.attrs)


def test_unlimited_host_cache_reads_nothing_from_the_file(staged):
    _, path, _ = staged
    for execution in ("per_block", "packed_kernel"):
        sess = _open(path, memory_budget=BUDGET)
        res = sess.run(rt.ExecutionPlan(
            rt.PageRank(), strategy="dpu", max_iters=2, tol=0.0, execution=execution
        ))
        assert res.meters.bytes_disk_read == 0
        assert res.meters.bytes_h2d > 0  # still streamed host -> device
        assert sess.staged_host_bytes() > 0  # the cache filled


def test_disk_requires_a_store(staged):
    jg, path, tg = staged
    with pytest.raises(ValueError, match="disk"):
        rt.GraphSession(tg, device="cpu", residency="disk")
    with pytest.raises(ValueError, match="disk"):
        rt.GraphSession(tg, device="cpu").run(
            rt.ExecutionPlan(rt.PageRank(), max_iters=1, residency="disk")
        )
    with pytest.raises(ValueError, match="host_memory_budget"):
        rt.GraphSession(tg, device="cpu", host_memory_budget=10)
    # fault_plan= is ported (ROADMAP A10, second part): the session and its
    # store share one injector.
    from repro_torch.reliability import FaultPlan

    sess = _open(path, fault_plan=FaultPlan.storage_corrupt("p_dst", times=1))
    assert sess.fault_injector is not None and sess.store._injector is sess.fault_injector


@pytest.mark.parametrize("execution", ["per_block", "packed_kernel"])
def test_host_override_on_a_disk_session(staged, execution):
    _, path, tg = staged
    sess = _open(path, memory_budget=BUDGET)
    plan = rt.ExecutionPlan(
        rt.PageRank(), strategy="spu", max_iters=2, tol=0.0, residency="host",
        execution=execution,
    )
    ref = rt.GraphSession(tg, device="cpu", memory_budget=BUDGET, residency="host").run(plan)
    got = sess.run(plan)
    np.testing.assert_array_equal(ref.attrs, got.attrs)
    assert got.meters.bytes_disk_read == 0
    assert got.meters.bytes_h2d == ref.meters.bytes_h2d
    dev = sess.run(dataclasses.replace(plan, residency="device"))
    np.testing.assert_array_equal(dev.attrs, got.attrs)


def test_get_session_and_engine_on_disk(staged):
    jg, path, tg = staged
    # get_session keys and forwards host_memory_budget: an in-memory graph
    # refuses it with the session's own error, as the JAX package's does.
    with pytest.raises(ValueError, match="host_memory_budget"):
        rt.get_session(tg, device="cpu", host_memory_budget=1 << 20)
    with pytest.raises(ValueError, match="host_memory_budget"):
        jc.get_session(jg, host_memory_budget=1 << 20)
    assert rt.get_session(tg, device="cpu") is rt.get_session(tg, device="cpu")
    sess = _open(path, memory_budget=BUDGET, host_memory_budget=HOST_BUDGET)
    eng = rt.NXGraphEngine(sess.graph, rt.PageRank(), strategy="dpu", residency="disk",
                           session=sess)
    res = eng.run(ITERS, tol=0.0)
    ref = rt.GraphSession(tg, device="cpu", memory_budget=BUDGET, residency="device").run(
        rt.ExecutionPlan(rt.PageRank(), strategy="dpu", max_iters=ITERS, tol=0.0)
    )
    np.testing.assert_array_equal(res.attrs, ref.attrs)
    assert res.meters.bytes_disk_read > 0
    with pytest.raises(ValueError, match="residency"):
        rt.NXGraphEngine(sess.graph, rt.PageRank(), residency="device", session=sess)


def test_open_defaults_to_the_card(staged, monkeypatch):
    _, path, _ = staged
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.GraphSession.open(path)


def test_select_strategy_host_term_matches_the_reference(staged):
    jg, path, _ = staged
    sess = _open(path, memory_budget=BUDGET, host_memory_budget=HOST_BUDGET)
    jsess = jc.GraphSession.open(path, memory_budget=BUDGET, host_memory_budget=HOST_BUDGET)
    for prog, jprog in ((rt.PageRank(), jc.PageRank()), (rt.BFS(), jc.BFS())):
        a = sess.compile(rt.ExecutionPlan(prog)).choice
        b = jsess.compile(jc.ExecutionPlan(jprog)).choice
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    p = tio.IOParams(n=1000, m=20000, Ba=4, P=8)
    for B_M in (None, 0, 5000, 100_000):
        for host in (None, 0, 30_000, 10**9):
            a = tio.select_strategy(p, B_M, host_B_M=host)
            b = jc.select_strategy(jc.IOParams(n=1000, m=20000, Ba=4, P=8), B_M, host_B_M=host)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_compare_measured_and_calibration_match_the_reference(staged):
    _, path, tg = staged
    sess = _open(path, memory_budget=BUDGET, host_memory_budget=0)
    plan = rt.ExecutionPlan(rt.PageRank(), strategy="dpu", max_iters=2, tol=0.0,
                            execution="per_block")
    res = sess.run(plan)
    p = sess.params_for(plan.program)
    jp = jc.IOParams(**dataclasses.asdict(p))
    per = res.meters.per_iteration()
    assert per.bytes_disk_read == res.meters.bytes_disk_read / 2
    a = tio.compare_measured(per, p, "dpu", BUDGET, slack_bytes=64.0)
    b = jc.compare_measured(per, jp, "dpu", BUDGET, slack_bytes=64.0)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert a.within_slack == b.within_slack
    assert tio.calibrate_edge_bytes(p, res.meters) == jc.calibrate_edge_bytes(jp, res.meters)
    assert tio.calibrate_edge_bytes(p, tsession.Meters()) == p.Be


def test_disk_holds_nothing_edge_scale_outside_the_cache(staged, monkeypatch):
    """No whole-layout run index, no staged stream, no block payloads."""
    _, path, _ = staged
    calls = []
    monkeypatch.setattr(tsession, "run_index", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tsession, "tile_ranges", lambda *a, **k: calls.append(1))
    sess = _open(path, memory_budget=0, host_memory_budget=0)
    for execution in ("packed_kernel", "packed", "per_block"):
        sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="dpu", max_iters=2, tol=0.0,
                                  execution=execution))
    st = sess._staged
    assert not calls and not st._packed_streams and not st._block_payloads
    assert not st._packed_index and not st._packed_tiles and not st._device_blocks
    assert sess.staged_host_bytes() == 0
    assert sess._slots.nbytes > 0  # the two staging slots
    assert isinstance(st.packed_host(sess.packing).src, np.memmap)


def test_disk_ranges_equal_the_host_stream(staged):
    """The disk stream's B1 payloads equal host residency's, chunk for chunk."""
    _, path, tg = staged
    sess = _open(path, memory_budget=0, host_memory_budget=0)
    splan = sess.packed_stream_plan("dpu", 8)
    stream = sess._disk_stream(splan, "kernel")
    host = rt.GraphSession(tg, device="cpu", memory_budget=0, residency="host")
    hstream = host._staged.packed_stream(host.packing, 0, splan.chunk_tiles, "kernel", False)
    assert stream.bounds == hstream.bounds and stream.edges == hstream.edges
    assert stream.max_runs >= hstream.max_runs and stream.max_nbytes >= hstream.max_nbytes
    meters = tsession.Meters()
    for c in range(len(stream.bounds)):
        buf, unit, nbytes, slot = stream.fetch(c, meters)
        assert unit == hstream.units[c] and nbytes == hstream.nbytes[c]
        assert torch.equal(buf, hstream.host[c])
    assert meters.bytes_disk_read == tio.packed_disk_bytes(
        splan.num_tiles, splan.tile_edges, weighted=True
    )
    assert ps.launches == 0


@pytest.mark.parametrize("execution", ["packed_kernel", "per_block"])
def test_src_sorted_file_on_disk(tmp_path, execution):
    """A src_sorted layout (runs reached through perm) streamed from a file:
    the layout's perm is found by scanning the file's run slots, and the
    ranges, bits and bytes are host residency's."""
    src, dst, w = _raw()
    g = rt.build_dsss(rt.degree_and_densify(src, dst, w, drop_self_loops=True), 4, src_sorted=True)
    path = str(tmp_path / "s.dsss")
    from repro_torch.storage import write_dsss

    write_dsss(g, path)
    plan = rt.ExecutionPlan(rt.PageRank(), strategy="dpu", max_iters=3, tol=0.0, execution=execution)
    disk = _open(path, memory_budget=0, host_memory_budget=0)
    got = disk.run(plan)
    host = rt.GraphSession(g, device="cpu", memory_budget=0, residency="host").run(plan)
    dev = rt.GraphSession(g, device="cpu", memory_budget=0, residency="device").run(plan)
    np.testing.assert_array_equal(got.attrs.view(np.int32), dev.attrs.view(np.int32))
    assert got.meters.bytes_h2d == host.meters.bytes_h2d
    assert got.meters.model_dict() == dev.meters.model_dict()
    if execution == "packed_kernel":
        assert disk._staged.layout_permuted(disk.packing) is True
        assert not disk._staged._packed_index  # found without a whole-layout index
