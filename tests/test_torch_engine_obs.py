"""The engine's observability wiring in the port (the checks of
``tests/test_obs.py`` that need no checkpoint).

* Registry byte deltas over a run equal ``Result.meters`` field for field,
  and the sweep and run counters move with them, over device/host/disk ×
  ``per_block``/``packed``/``packed_kernel``; each delta also equals the
  JAX package's registry delta for the same run.
* ``REPRO_OBS`` off (``set_enabled(False)``) freezes every counter.
* The drift gauge is the reference's formula.
* A traced disk run's Chrome JSON loads, its ``sweep`` spans sum to the
  byte meters, its ``run`` span names the residency, and
  ``trace_analysis.run_summaries`` reads it; ``TraceSpec(sweeps=False)``
  keeps only the run; ``batch_key`` excludes ``trace``; ``trace="x"``
  raises ``TypeError``; the plan-scoped tracer is restored.
"""
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro.storage as js  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402
from repro.obs import REGISTRY as J_REGISTRY  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import iomodel as tio  # noqa: E402
from repro_torch.obs import REGISTRY, TRACER, TraceSpec  # noqa: E402
from repro_torch.runtime import trace_analysis  # noqa: E402

_BYTE_KINDS = (
    ("h2d", "bytes_h2d"),
    ("disk_read", "bytes_disk_read"),
    ("read_edges", "bytes_read_edges"),
    ("read_intervals", "bytes_read_intervals"),
    ("read_hubs", "bytes_read_hubs"),
    ("written_hubs", "bytes_written_hubs"),
    ("written_intervals", "bytes_written_intervals"),
)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    src, dst = j_er(130, 800, seed=7)
    jg = jc.build_dsss(j_densify(src, dst, drop_self_loops=True), 4)
    path = str(tmp_path_factory.mktemp("obs") / "g.dsss")
    js.write_dsss(jg, path)
    tg = rt.GraphSession.open(path, device="cpu").graph
    return jg, tg, path


def _budget(g):
    return int(g.total_edge_bytes(8) * 0.3)


def _session(staged, residency, mod=rt):
    jg, tg, path = staged
    g = jg if mod is jc else tg
    kw = {} if mod is jc else {"device": "cpu"}
    budget = _budget(g)
    if residency == "disk":
        return mod.GraphSession.open(path, memory_budget=budget, host_memory_budget=2 * budget, **kw)
    return mod.GraphSession(g, memory_budget=budget, residency=residency, **kw)


def _snap(reg):
    return {kind: reg.value("repro_engine_bytes_total", kind=kind) for kind, _ in _BYTE_KINDS}


@pytest.mark.parametrize("residency", ["device", "host", "disk"])
@pytest.mark.parametrize("execution", ["per_block", "packed", "packed_kernel"])
def test_registry_deltas_equal_meters(staged, residency, execution):
    sess = _session(staged, residency)
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=3, tol=0.0, execution=execution)
    before = _snap(REGISTRY)
    s_sweeps = REGISTRY.value("repro_engine_sweeps_total")
    res = sess.run(plan)
    after = _snap(REGISTRY)
    for kind, field in _BYTE_KINDS:
        assert after[kind] - before[kind] == getattr(res.meters, field), (residency, kind)
    assert REGISTRY.value("repro_engine_sweeps_total") - s_sweeps == res.meters.iterations
    labels = dict(
        program="pagerank", strategy=res.strategy.strategy,
        residency=sess.resolved_residency(),
        execution=sess.resolved_execution(
            res.strategy.strategy, sess.resolved_residency(), execution
        ),
    )
    assert REGISTRY.value("repro_engine_runs_total", **labels) >= 1
    assert REGISTRY.value("repro_engine_peak_device_graph_bytes") == (
        res.meters.peak_device_graph_bytes
    )
    if residency != "device":
        assert res.meters.bytes_h2d > 0
    if residency == "disk":
        assert res.meters.bytes_disk_read > 0
    # The JAX package's registry moves by the same model bytes on the same run
    # (and the same physical bytes, but for B1's own payload under packed_kernel).
    jsess = _session(staged, residency, jc)
    j_before = _snap(J_REGISTRY)
    jsess.run(jc.ExecutionPlan(
        jc.PageRank(), max_iters=3, tol=0.0,
        execution="packed" if execution == "packed_kernel" else execution,
    ))
    j_after = _snap(J_REGISTRY)
    for kind, _ in _BYTE_KINDS:
        if kind == "h2d" and execution == "packed_kernel":
            continue
        assert j_after[kind] - j_before[kind] == after[kind] - before[kind], kind


def test_disabled_registry_freezes_engine_counters(staged):
    sess = _session(staged, "disk")
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0)
    sess.run(plan)  # the series exist
    before = _snap(REGISTRY)
    s_sweeps = REGISTRY.value("repro_engine_sweeps_total")
    s_runs = REGISTRY.value(
        "repro_engine_runs_total", program="pagerank", strategy="dpu",
        residency="disk", execution="packed_kernel",
    )
    REGISTRY.set_enabled(False)
    try:
        res = sess.run(plan)
    finally:
        REGISTRY.set_enabled(True)
    assert res.meters.bytes_disk_read > 0
    assert _snap(REGISTRY) == before
    assert REGISTRY.value("repro_engine_sweeps_total") == s_sweeps
    assert REGISTRY.value(
        "repro_engine_runs_total", program="pagerank", strategy="dpu",
        residency="disk", execution="packed_kernel",
    ) == s_runs


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
def test_iomodel_drift_gauge_is_the_reference_formula(staged, strategy):
    jg, tg, _ = staged
    budget = _budget(tg)
    sess = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency="host")
    plan = rt.ExecutionPlan(rt.PageRank(), strategy=strategy, max_iters=4, tol=0.0)
    res = sess.run(plan)
    read, write = tio.modelled_io(sess.params_for(plan.program), budget, strategy)
    jres = jc.GraphSession(jg, memory_budget=budget, residency="host").run(
        jc.ExecutionPlan(jc.PageRank(), strategy=strategy, max_iters=4, tol=0.0)
    )
    for direction, total, ref in (
        ("read", read, res.meters.bytes_read), ("write", write, res.meters.bytes_written)
    ):
        if total <= 0:
            continue
        got = REGISTRY.value("repro_iomodel_drift_ratio", direction=direction, strategy=strategy)
        assert got == pytest.approx(ref / res.meters.iterations / total)
        want = J_REGISTRY.value("repro_iomodel_drift_ratio", direction=direction,
                                strategy=strategy)
        assert got == want
        assert jres.meters.bytes_read == res.meters.bytes_read
        assert 0.2 < got < 5.0


@pytest.mark.parametrize("execution", ["per_block", "packed_kernel"])
def test_traced_disk_run_sums_and_valid_chrome(staged, tmp_path, execution):
    sess = _session(staged, "disk")
    path = str(tmp_path / "run.json")
    plan = rt.ExecutionPlan(
        rt.PageRank(), max_iters=4, tol=0.0, execution=execution, trace=TraceSpec(path=path)
    )
    res = sess.run(plan)
    assert not TRACER.enabled  # the plan-scoped enable was restored
    doc = json.load(open(path))
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    sweeps = [e for e in xs if e["name"] == "sweep"]
    assert len(sweeps) == res.meters.iterations == 4
    assert sum(e["args"]["bytes_h2d"] for e in sweeps) == res.meters.bytes_h2d
    assert sum(e["args"]["bytes_disk_read"] for e in sweeps) == res.meters.bytes_disk_read > 0
    (run_span,) = [e for e in xs if e["name"] == "run"]
    assert run_span["args"]["bytes_h2d"] == res.meters.bytes_h2d
    assert run_span["args"]["residency"] == "disk"
    assert run_span["args"]["execution"] == execution
    (summary,) = trace_analysis.run_summaries(trace_analysis.load_events(path))
    assert summary["sweeps"] == 4 and summary["residency"] == "disk"
    assert summary["bytes_disk_read"] == res.meters.bytes_disk_read
    assert summary["bytes_h2d"] == res.meters.bytes_h2d
    assert "| disk |" in trace_analysis.fmt_run_table([summary])


def test_trace_records_staging(staged, tmp_path):
    _, tg, _ = staged
    sess = rt.GraphSession(tg, device="cpu")  # fresh: the first packed run stages
    path = str(tmp_path / "staging.jsonl")
    sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0, trace=TraceSpec(path=path)))
    spans = [json.loads(line) for line in open(path)]
    assert any(s["cat"] == "staging" for s in spans)
    assert {s["name"] for s in spans} >= {"run", "sweep", "stage_packed_tiles"}


def test_tracespec_sweeps_off_and_batch_key_exclusion(staged, tmp_path):
    _, tg, _ = staged
    path = str(tmp_path / "nosweeps.json")
    spec = TraceSpec(path=path, sweeps=False)
    plan = rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0, trace=spec)
    bare = rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0)
    assert plan.batch_key() == bare.batch_key()  # traced requests fuse
    assert plan.compatible_with(bare)
    rt.GraphSession(tg, device="cpu").run(plan)
    xs = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    assert all(e["name"] != "sweep" for e in xs)
    assert any(e["name"] == "run" for e in xs)
    batch = rt.GraphSession(tg, device="cpu").run_batch(
        [rt.ExecutionPlan(rt.BFS(), max_iters=50, program_kwargs={"root": r},
                          trace=TraceSpec() if r else None) for r in range(3)]
    )
    assert batch.fused


def test_trace_type_validated():
    with pytest.raises(TypeError, match="TraceSpec"):
        rt.ExecutionPlan(rt.PageRank(), trace="run.json")


def test_untraced_run_records_nothing_and_global_tracing_is_kept(staged):
    _, tg, _ = staged
    sess = rt.GraphSession(tg, device="cpu")
    mark = TRACER.mark()
    sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0))
    assert TRACER.spans(since=mark) == []
    TRACER.enabled = True
    try:
        sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0,
                                  trace=TraceSpec(sweeps=False)))
        assert TRACER.enabled
        names = [s.name for s in TRACER.spans(since=mark)]
        assert names.count("run") == 1 and "sweep" not in names
    finally:
        TRACER.enabled = False
        TRACER.clear()
    np.testing.assert_array_equal(  # tracing changes no result
        sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0)).attrs,
        sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0,
                                  trace=TraceSpec())).attrs,
    )
