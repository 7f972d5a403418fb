"""Host residency: the port against the JAX package, and against itself at device residency.

Same graphs (built by the JAX package, carried over as arrays), same
plans, ``residency="host"`` under budgets that pin nothing, part or all of
the edge topology. Against the JAX package's host runs:

* attrs bitwise for the min/max programs; PageRank within ``rtol=1e-5,
  atol=1e-8`` over a fixed number of sweeps (the dangling-mass sum's order
  is pinned on neither side, XLA fuses the apply's arithmetic, and the JAX
  package's per-block float sums fold into the accumulator in another
  order, see ``test_torch_per_block.py``);
* ``MODEL_METER_FIELDS``, ``peak_device_graph_bytes``, ``iterations``,
  ``converged`` and ``activity_log`` identical;
* ``bytes_h2d`` equal on ``"per_block"`` and ``"packed"`` (the same padded
  blocks and tile leaves are shipped); on ``"packed_kernel"`` the port
  ships kernel B1's payload instead, and ``bytes_h2d`` equals the port's
  closed form :func:`repro_torch.core.iomodel.packed_kernel_h2d_bytes`;
* the packed stream plan field for field, and the pinned model bytes.

Against the port's own device residency (the JAX package's own residency
invariants, ``tests/test_residency_property.py``, ``test_packed_sweep.py``
and ``test_selective_property.py``): host equals device bitwise, PageRank
included, on every execution path; a zero budget streams everything, a
full one nothing; pins stay within the budget and are released when the
strategy changes; K queries stream the edges once; ``bytes_h2d`` equals its
closed form, selective or not. (B1's tile ranges alone:
``test_torch_tile_ranges.py``.)
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.convert import dsss_from_arrays  # noqa: E402
from repro_torch.core import iomodel as tio  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.kernels import packed_sweep as ps  # noqa: E402

_GRAPHS: dict = {}


def _graphs(kind: str):
    """(JAX graph, port graph) of one kind, built once."""
    if kind not in _GRAPHS:
        if kind.startswith("er"):
            el = j_densify(*j_er(300, 2400, seed=6), drop_self_loops=True)
            jg = jc.build_dsss(el, 5, src_sorted=kind == "er-src-sorted")
        else:
            scale = 12 if kind == "rmat12" else 10
            src, dst = j_rmat(scale, edge_factor=8, seed=42)
            w = None
            if kind == "weighted":
                w = np.random.default_rng(9).random(src.shape[0]).astype(np.float32) + 0.05
            el = j_densify(src, dst, w, drop_self_loops=True)
            if kind == "symmetrized":
                el = el.symmetrized()
            jg = jc.build_dsss(el, 8)
        fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
        fields["edgelist"] = vars(jg.edgelist)
        _GRAPHS[kind] = (jg, dsss_from_arrays(fields))
    return _GRAPHS[kind]


def _budget(g, frac: float, Ba: int = 4) -> int:
    """frac of both attribute copies plus every edge byte: 0 pins nothing, >= 1 everything."""
    Be = 12 if g.weights is not None else 8
    return int((2 * g.n_pad * Ba + g.m * Be) * frac)


PR_SWEEPS = 8  # PageRank runs a fixed number of sweeps against the JAX package

# name: (graph kind, JAX program, port program, per-query kwargs, max_iters, tol)
WORKLOADS = {
    "pagerank": ("plain", jc.PageRank(), rt.PageRank(), [{}], PR_SWEEPS, 0.0),
    "bfs-batch": ("plain", jc.BFS(), rt.BFS(), [{"root": r} for r in (0, 3, 9)], 1000, 1e-10),
    "sssp-weighted": ("weighted", jc.SSSP(), rt.SSSP(), [{"root": 1}], 1000, 1e-10),
    "wcc-src-sorted": ("er-src-sorted", jc.WCC(), rt.WCC(), [{}], 1000, 1e-10),
}


def _run(sess, mod, prog, kws, strategy, iters, tol, execution=None):
    plans = [
        mod.ExecutionPlan(prog, strategy=strategy, max_iters=iters, tol=tol,
                          execution=execution, program_kwargs=kw)
        for kw in kws
    ]
    if len(plans) == 1:
        r = sess.run(plans[0])
        return [r], r
    b = sess.run_batch(plans)
    assert b.fused
    return list(b), b


_JAX_RUNS: dict = {}


def _jax_host(workload, strategy, execution, frac):
    """The JAX package's host run (its "packed" stands in for "packed_kernel")."""
    jexec = "per_block" if execution == "per_block" else "packed"
    key = (workload, strategy, jexec, frac)
    if key not in _JAX_RUNS:
        kind, jprog, _, kws, iters, tol = WORKLOADS[workload]
        jg, _ = _graphs(kind)
        sess = jc.GraphSession(jg, memory_budget=_budget(jg, frac), residency="host", execution=jexec)
        _JAX_RUNS[key] = (sess, *_run(sess, jc, jprog, kws, strategy, iters, tol))
    return _JAX_RUNS[key]


def _port_host(workload, strategy, execution, frac):
    kind, _, tprog, kws, iters, tol = WORKLOADS[workload]
    _, tg = _graphs(kind)
    sess = rt.GraphSession(
        tg, device="cpu", memory_budget=_budget(tg, frac), residency="host", execution=execution
    )
    return (sess, *_run(sess, rt, tprog, kws, strategy, iters, tol))


def _streamed_ranges(sess, splan, tile_active=None):
    """The closed form's counts over the streamed ranges of a stream plan, from the layout."""
    packed = sess._staged.packed_host(sess.packing)
    tile_of_row = ps.run_index(packed)["chunks"][:, 5]
    counts = dict(streamed_tiles=0, ranges=0, runs=0, chunk_rows=0, touched=0, perm_edges=0)
    for lo in range(splan.pin_tiles, splan.num_tiles, splan.chunk_tiles):
        hi = min(lo + splan.chunk_tiles, splan.num_tiles)
        if tile_active is not None and not tile_active[lo:hi].any():
            continue
        dests = np.concatenate([packed.run_dst[t, : packed.u[t]] for t in range(lo, hi)])
        counts["streamed_tiles"] += hi - lo
        counts["ranges"] += 1
        counts["runs"] += int(packed.u[lo:hi].sum())
        counts["chunk_rows"] += int(((tile_of_row >= lo) & (tile_of_row < hi)).sum())
        counts["touched"] += int(np.unique(dests).shape[0])
        if sess.graph.src_sorted:
            counts["perm_edges"] += int(packed.e_valid[lo:hi].sum())
    return counts


def _kernel_h2d(sess, splan, tile_active=None) -> float:
    c = _streamed_ranges(sess, splan, tile_active)
    tiles = c.pop("streamed_tiles")
    return tio.packed_kernel_h2d_bytes(
        tiles, splan.tile_edges, weighted=sess.has_weights, **c
    )


def _expected_h2d(sess, compiled, res) -> float:
    """bytes_h2d of a host run from the closed forms over its activity log."""
    strategy, Ba = compiled.choice.strategy, compiled.params.Ba
    total = 0.0
    for rows in res.activity_log:
        full = bool(np.all(rows)) or compiled.activity != "selective"
        if compiled.execution == "per_block":
            nbytes = {k: tsession._host_block_nbytes(h) for k, h in sess.host_blocks.items()}
            total += tio.streamed_block_bytes(nbytes, compiled.resident, None if full else rows)
            continue
        splan = sess.packed_stream_plan(strategy, Ba)
        act = None if full else sess._packed_tile_activity(rows)
        if compiled.execution == "packed":
            tiles = (
                splan.num_tiles - splan.pin_tiles if act is None
                else tio.selective_streamed_tiles(act, splan.pin_tiles, splan.chunk_tiles)
            )
            total += tio.packed_h2d_bytes(tiles, splan.tile_edges, weighted=sess.has_weights)
        else:
            total += _kernel_h2d(sess, splan, act)
    return total


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frac", [0.0, 0.5])
@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_host_matches_jax_host(workload, strategy, execution, frac):
    jsess, j_list, j = _jax_host(workload, strategy, execution, frac)
    tsess, t_list, t = _port_host(workload, strategy, execution, frac)
    for a, b in zip(t_list, j_list):
        if workload == "pagerank":
            np.testing.assert_allclose(a.attrs, b.attrs, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_array_equal(a.attrs, b.attrs)
        assert a.iterations == b.iterations and a.converged == b.converged
    assert t.meters.model_dict() == {f: getattr(j.meters, f) for f in tsession.MODEL_METER_FIELDS}
    assert t.meters.peak_device_graph_bytes == j.meters.peak_device_graph_bytes
    assert len(t.activity_log) == len(j.activity_log)
    for a, b in zip(t.activity_log, j.activity_log):
        np.testing.assert_array_equal(a, b)
    compiled = tsess.compile(rt.ExecutionPlan(WORKLOADS[workload][2], strategy=strategy))
    assert compiled.residency == "host" and compiled.execution == execution
    if execution == "packed_kernel":
        assert t.meters.bytes_h2d == _expected_h2d(tsess, compiled, t)
    else:
        assert t.meters.bytes_h2d == j.meters.bytes_h2d
    assert tsess.pinned_device_bytes()[0] == jsess.pinned_device_bytes()[0]
    if execution != "packed_kernel":
        assert tsess.pinned_device_bytes() == jsess.pinned_device_bytes()


@pytest.mark.parametrize("frac", [0.0, 0.2, 0.5, 0.9, 1.5])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("kind", ["plain", "weighted", "er-src-sorted", "rmat12"])
def test_stream_plan_matches_jax(kind, strategy, frac):
    jg, tg = _graphs(kind)
    for Ba in (4, 8):
        j = jc.GraphSession(jg, memory_budget=_budget(jg, frac, Ba), residency="host")
        t = rt.GraphSession(tg, device="cpu", memory_budget=_budget(tg, frac, Ba), residency="host")
        assert dataclasses.asdict(t.packed_stream_plan(strategy, Ba)) == dataclasses.asdict(
            j.packed_stream_plan(strategy, Ba)
        )
    j = jc.GraphSession(jg, residency="host")  # no budget: everything pinned
    t = rt.GraphSession(tg, device="cpu", residency="host")
    assert dataclasses.asdict(t.packed_stream_plan(strategy, 4)) == dataclasses.asdict(
        j.packed_stream_plan(strategy, 4)
    )


def test_selective_host_matches_jax_and_closed_forms():
    """A narrow BFS frontier skips chunks and blocks: the JAX package's bytes, exactly."""
    jg, tg = _graphs("plain")
    for execution in ("packed", "per_block", "packed_kernel"):
        jexec = "per_block" if execution == "per_block" else "packed"
        runs = {}
        for activity in ("auto", "off"):
            plan_kw = dict(strategy="spu", max_iters=1000, tol=1e-10, activity=activity,
                           program_kwargs={"root": 3})
            j = jc.GraphSession(jg, memory_budget=0, residency="host", execution=jexec).run(
                jc.ExecutionPlan(jc.BFS(), **plan_kw))
            tsess = rt.GraphSession(tg, device="cpu", memory_budget=0, residency="host", execution=execution)
            plan = rt.ExecutionPlan(rt.BFS(), **plan_kw)
            t = tsess.run(plan)
            np.testing.assert_array_equal(t.attrs, j.attrs)
            assert t.meters.model_dict() == {f: getattr(j.meters, f) for f in tsession.MODEL_METER_FIELDS}
            if execution != "packed_kernel":
                assert t.meters.bytes_h2d == j.meters.bytes_h2d
            assert t.meters.bytes_h2d == _expected_h2d(tsess, tsess.compile(plan), t)
            runs[activity] = t
        np.testing.assert_array_equal(runs["auto"].attrs, runs["off"].attrs)
        assert 0 < runs["auto"].meters.bytes_h2d < runs["off"].meters.bytes_h2d


# ---------------------------------------------------------------------------
# The port's host residency against its device residency
# ---------------------------------------------------------------------------
PROGRAMS = {
    "pagerank": (rt.PageRank(), {}, 8, 0.0),
    "bfs": (rt.BFS(), {"root": 0}, 1000, 1e-10),
    "wcc": (rt.WCC(), {}, 1000, 1e-10),
    "sssp": (rt.SSSP(), {"root": 2}, 1000, 1e-10),
}


@pytest.mark.parametrize("frac", [0.0, 0.4, 1.5])
@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_host_bitwise_equals_device(execution, strategy, program, frac):
    _, g = _graphs("er")
    prog, kw, iters, tol = PROGRAMS[program]
    budget = _budget(g, frac)
    plan = rt.ExecutionPlan(prog, strategy=strategy, max_iters=iters, tol=tol,
                            execution=execution, program_kwargs=kw)
    dev = rt.GraphSession(g, device="cpu", memory_budget=budget, residency="device").run(plan)
    sess = rt.GraphSession(g, device="cpu", memory_budget=budget, residency="host")
    host = sess.run(plan)
    np.testing.assert_array_equal(host.attrs.view(np.int32), dev.attrs.view(np.int32))
    assert host.iterations == dev.iterations and host.converged == dev.converged
    assert host.meters.model_dict() == dev.meters.model_dict()
    assert dev.meters.bytes_h2d == 0.0
    assert host.meters.bytes_h2d == _expected_h2d(sess, sess.compile(plan), host)
    # A host run stages nothing of the device residency's mirrors.
    assert sess._staged._packed_tiles == {} and sess._staged._device_blocks == {}


@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_zero_budget_streams_everything_every_sweep(execution):
    _, g = _graphs("er")
    sess = rt.GraphSession(g, device="cpu", memory_budget=0, residency="host", execution=execution)
    res = sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="spu", max_iters=3, tol=0.0))
    assert sess.pinned_device_bytes() == (0.0, 0.0)
    assert res.meters.bytes_read_edges == res.iterations * g.m * sess.Be
    assert res.meters.bytes_h2d > 0
    per = res.meters.per_iteration()
    assert per.bytes_h2d * res.iterations == res.meters.bytes_h2d


@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_full_budget_streams_nothing(execution):
    _, g = _graphs("er")
    sess = rt.GraphSession(g, device="cpu", memory_budget=_budget(g, 2.0), residency="host",
                           execution=execution)
    res = sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="spu", max_iters=3, tol=0.0))
    assert res.meters.bytes_h2d == 0.0 and res.meters.bytes_read_edges == 0.0
    assert sess.pinned_device_bytes()[0] == g.m * sess.Be
    assert res.meters.peak_device_graph_bytes == g.m * sess.Be


@pytest.mark.parametrize("frac", [0.1, 0.4, 0.7, 1.1])
@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_pins_within_budget_and_ring_bounded(execution, frac):
    _, g = _graphs("plain")
    Ba = rt.PageRank().attr_bytes
    budget = _budget(g, frac, Ba)
    sess = rt.GraphSession(g, device="cpu", memory_budget=budget, residency="host", execution=execution)
    res = sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="spu", max_iters=2, tol=0.0))
    pinned_model, pinned_actual = sess.pinned_device_bytes()
    if pinned_model > 0:
        assert pinned_model + 2 * g.n_pad * Ba <= budget
        assert pinned_actual >= pinned_model
    if execution == "per_block":
        unit = max(int(e) for e in sess._staged.block_e.ravel()) * sess.Be
    else:
        unit = sess.packed_stream_plan("spu", Ba).max_chunk_model_bytes
    assert res.meters.peak_device_graph_bytes <= pinned_model + 2 * unit


@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_pins_released_when_strategy_changes(execution):
    _, g = _graphs("plain")
    sess = rt.GraphSession(g, device="cpu", memory_budget=_budget(g, 0.8), residency="host",
                           execution=execution)
    sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="spu", max_iters=2, tol=0.0))
    assert sess.pinned_device_bytes()[0] > 0
    sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="dpu", max_iters=2, tol=0.0))
    assert sess.pinned_device_bytes() == (0.0, 0.0)


@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
def test_batched_queries_stream_the_edges_once(execution):
    _, g = _graphs("er")
    sess = rt.GraphSession(g, device="cpu", memory_budget=0, residency="host", execution=execution)
    plans = [
        rt.ExecutionPlan(rt.BFS(), strategy="dpu", max_iters=1000, activity="off",
                         program_kwargs={"root": r})
        for r in (0, 3, 7, 11)
    ]
    batch = sess.run_batch(plans)
    assert batch.fused
    single = sess.run(plans[0])
    per_b, per_s = batch.meters.per_iteration(), single.meters.per_iteration()
    assert per_b.bytes_read_edges == per_s.bytes_read_edges > 0
    assert per_b.bytes_h2d == per_s.bytes_h2d > 0
    device = rt.GraphSession(g, device="cpu", residency="device")
    for res, plan in zip(batch, plans):
        np.testing.assert_array_equal(res.attrs, device.run(plan).attrs)


def test_fused_and_registered_strategies_under_host():
    """fused keeps the whole edge list on the device; a registered schedule streams every block."""
    from repro_torch.core.baselines import TurboGraphLikeEngine

    _, g = _graphs("plain")
    budget = _budget(g, 0.5)
    host = rt.GraphSession(g, device="cpu", memory_budget=budget, residency="host")
    dev = rt.GraphSession(g, device="cpu", memory_budget=budget, residency="device")
    plan = rt.ExecutionPlan(rt.PageRank(), strategy="fused", max_iters=4, tol=0.0)
    h, d = host.run(plan), dev.run(plan)
    np.testing.assert_array_equal(h.attrs.view(np.int32), d.attrs.view(np.int32))
    assert h.meters.peak_device_graph_bytes == g.m * host.Be and h.meters.bytes_h2d == 0.0
    assert host.compile(plan).execution == "per_block"
    eng = TurboGraphLikeEngine(g, rt.PageRank(), session=host)
    tg_host = eng.run(4, tol=0.0)
    tg_dev = TurboGraphLikeEngine(g, rt.PageRank(), session=dev).run(4, tol=0.0)
    np.testing.assert_array_equal(tg_host.attrs.view(np.int32), tg_dev.attrs.view(np.int32))
    assert tg_host.meters.model_dict() == tg_dev.meters.model_dict()
    nbytes = {k: tsession._host_block_nbytes(b) for k, b in host.host_blocks.items()}
    assert tg_host.meters.bytes_h2d == 4 * tio.streamed_block_bytes(nbytes, frozenset())


def test_plan_level_residency_override_and_the_shim():
    _, g = _graphs("er")
    sess = rt.GraphSession(g, device="cpu", memory_budget=_budget(g, 0.3), residency="device")
    base = rt.ExecutionPlan(rt.PageRank(), strategy="dpu", max_iters=4, tol=0.0)
    dev = sess.run(base)
    host = sess.run(dataclasses.replace(base, residency="host"))
    np.testing.assert_array_equal(host.attrs.view(np.int32), dev.attrs.view(np.int32))
    assert dev.meters.bytes_h2d == 0.0 and host.meters.bytes_h2d > 0
    auto = rt.GraphSession(g, device="cpu", memory_budget=_budget(g, 0.5))  # auto → host
    assert auto.resolved_residency() == "host"
    eng = rt.NXGraphEngine(g, rt.PageRank(), residency="host", session=auto)
    assert eng.session is auto
    with pytest.raises(ValueError, match="residency"):
        rt.NXGraphEngine(g, rt.PageRank(), residency="device", session=auto)
    got = eng.run(4, tol=0.0)
    assert got.meters.bytes_h2d > 0


@pytest.mark.parametrize("driver", ["pagerank", "bfs", "sssp", "multi_bfs"])
def test_drivers_with_a_budget_run_host_residency(driver):
    from repro_torch.core import algorithms as talg

    rt.clear_session_cache()
    _, g = _graphs("er")
    budget = _budget(g, 0.4)
    call = {
        "pagerank": lambda **kw: talg.pagerank(g, iters=5, device="cpu", **kw),
        "bfs": lambda **kw: talg.bfs(g, 3, device="cpu", **kw),
        "sssp": lambda **kw: talg.sssp(g, 3, device="cpu", **kw),
        "multi_bfs": lambda **kw: talg.multi_bfs(g, [0, 3, 9], device="cpu", **kw),
    }[driver]
    host = call(memory_budget=budget)
    dev = call(memory_budget=budget, residency="device")
    assert host.meters.bytes_h2d > 0 and dev.meters.bytes_h2d == 0
    for a, b in zip(host if driver == "multi_bfs" else [host], dev if driver == "multi_bfs" else [dev]):
        np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
    assert host.meters.model_dict() == dev.meters.model_dict()


def test_disk_residency_and_host_memory_budget_still_raise():
    # Disk residency is ported (tests/test_torch_disk.py); over an in-memory
    # graph it and host_memory_budget raise the JAX package's ValueError.
    _, g = _graphs("er")
    with pytest.raises(ValueError, match="disk-backed session"):
        rt.GraphSession(g, device="cpu", residency="disk")
    sess = rt.GraphSession(g, device="cpu", memory_budget=1000)
    with pytest.raises(ValueError, match="disk-backed session"):
        sess.run(rt.ExecutionPlan(rt.BFS(), max_iters=4, residency="disk"))
    with pytest.raises(ValueError, match="host_memory_budget"):
        rt.get_session(g, device="cpu", memory_budget=1000, host_memory_budget=10_000)


def test_meters_carry_bytes_h2d():
    a = tsession.Meters(bytes_h2d=300.0, iterations=3)
    b = tsession.Meters(bytes_h2d=100.0, iterations=1)
    assert a.per_iteration().bytes_h2d == 100.0
    assert a.merge(b).bytes_h2d == 400.0
    assert "bytes_h2d" not in tsession.MODEL_METER_FIELDS
