"""The port's per-block path against the JAX package's, and against its own packed path.

Same graphs (built by the JAX package, carried over as arrays), same
plans, device residency. Compared:

* the padded host blocks ("shard files") and sub-shard views, byte for byte;
* staged kernel operands, bitwise, and cached;
* the block primitives on the same blocks, bitwise;
* ``execution="per_block"`` sessions for SPU/DPU/MPU/fused, with
  ``activity`` auto and off and a budget giving ``0 < Q < P``, against the
  JAX package's per-block sessions: attrs bitwise for the min/max
  programs, PageRank within ``rtol=1e-5`` (the dangling-mass sum order is
  pinned on neither side, and XLA fuses the apply's arithmetic), and
  ``MODEL_METER_FIELDS``, the peak, ``iterations``, ``converged`` and
  ``activity_log`` identical. PageRank runs a fixed :data:`JAX_PR_SWEEPS`
  sweeps there: at ``tol=0`` a run stops at the bitwise fixed point, whose
  sweep count follows the last bits, and the JAX package's per-block float
  sums differ from its packed path's in the last bits (XLA folds a direct
  block's edges straight into the accumulator), so it stops at another
  sweep (22 against 27 for this graph's SPU);
* fused PageRank within ``rtol=1e-6`` of SPU (it folds each destination in
  one run, SPU per sub-shard first), as the JAX package's own test holds it;
* the port's per-block and packed_kernel runs, bitwise in attrs and
  identical in model meters (the execution-backend parity invariant).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.convert import dsss_from_arrays  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402

_GRAPHS: dict = {}


def _carry(jg):
    fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
    fields["edgelist"] = vars(jg.edgelist)
    return dsss_from_arrays(fields)


def _graphs(kind: str):
    """(JAX graph, port graph) of one kind, built once."""
    if kind not in _GRAPHS:
        if kind.startswith("er"):
            el = j_densify(*j_er(300, 2400, seed=6), drop_self_loops=True)
            jg = jc.build_dsss(el, 5, src_sorted=kind == "er-src-sorted")
        else:
            src, dst = j_rmat(10, edge_factor=8, seed=42)
            w = None
            if kind == "weighted":
                w = np.random.default_rng(9).random(src.shape[0]).astype(np.float32) + 0.05
            el = j_densify(src, dst, w, drop_self_loops=True)
            if kind == "symmetrized":
                el = el.symmetrized()
            jg = jc.build_dsss(el, 8)
        _GRAPHS[kind] = (jg, _carry(jg))
    return _GRAPHS[kind]


def _budget(g, prog) -> int:
    """Room for P/2 ping-pong intervals: MPU with 0 < Q < P."""
    return 2 * g.interval_size * prog.attr_bytes * (g.P // 2)


# name: (graph kind, JAX program, port program, per-query kwargs, max_iters, tol)
WORKLOADS = {
    "pagerank": ("plain", jc.PageRank(), rt.PageRank(), [{}], 30, 0.0),
    "ppr-batch": ("plain", jc.PageRank(), rt.PageRank(),
                  [{"personalize": v} for v in (0, 5, 17)], 20, 0.0),
    "bfs-batch": ("plain", jc.BFS(), rt.BFS(), [{"root": r} for r in (0, 3, 9, 40)], 1000, 1e-10),
    "sssp-weighted": ("weighted", jc.SSSP(), rt.SSSP(), [{"root": 1}], 1000, 1e-10),
    "wcc-symmetrized": ("symmetrized", jc.WCC(), rt.WCC(), [{}], 1000, 1e-10),
}
PAGERANK = ("pagerank", "ppr-batch")
JAX_PR_SWEEPS = 15  # below either side's bitwise fixed point (see the docstring)


def _plans(mod, prog, kws, strategy, iters, tol, activity, execution):
    return [
        mod.ExecutionPlan(prog, strategy=strategy, max_iters=iters, tol=tol,
                          activity=activity, execution=execution, program_kwargs=kw)
        for kw in kws
    ]


def _run(sess, mod, prog, kws, strategy, iters, tol, activity, execution=None):
    plans = _plans(mod, prog, kws, strategy, iters, tol, activity, execution)
    if len(plans) == 1:
        r = sess.run(plans[0])
        return [r], r
    b = sess.run_batch(plans)
    assert b.fused
    return list(b), b


def _port_run(workload, strategy, activity, execution):
    kind, _, tprog, kws, iters, tol = WORKLOADS[workload]
    _, tg = _graphs(kind)
    sess = rt.GraphSession(
        tg, device="cpu", memory_budget=_budget(tg, tprog), residency="device",
        execution=execution,
    )
    return _run(sess, rt, tprog, kws, strategy, iters, tol, activity)


def _same_meters_and_logs(t, j):
    assert t.meters.model_dict() == j.meters.model_dict()
    assert t.meters.peak_device_graph_bytes == j.meters.peak_device_graph_bytes
    assert len(t.activity_log) == len(j.activity_log)
    for a, b in zip(t.activity_log, j.activity_log):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Layout and staging
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["plain", "weighted", "er-src-sorted"])
def test_host_blocks_byte_identical_to_jax(kind):
    jg, tg = _graphs(kind)
    jb, tb = jg.host_blocks(), tg.host_blocks()
    assert list(tb) == list(jb)
    for key, jblk in jb.items():
        tblk = tb[key]
        assert set(tblk) == set(jblk)
        for name, want in jblk.items():
            got = tblk[name]
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (key, name)
            else:
                assert got == want, (key, name)
    for i in range(jg.P):
        assert tg.interval_bounds(i) == jg.interval_bounds(i)
        for j in range(jg.P):
            assert tg.subshard_edge_count(i, j) == jg.subshard_edge_count(i, j)
            js, ts = jg.subshard(i, j), tg.subshard(i, j)
            assert (ts.num_edges, ts.num_unique_dst, ts.src_sorted) == (
                js.num_edges, js.num_unique_dst, js.src_sorted)
            for name in ("src_local", "dst_local", "hub_dst", "hub_inv"):
                assert getattr(ts, name).tobytes() == getattr(js, name).tobytes()
    assert tg.total_edge_bytes(12) == jg.total_edge_bytes(12)
    jsess = jc.GraphSession(jg)
    tsess = rt.GraphSession(tg, device="cpu")
    assert tsess.staged_host_bytes() == jsess.staged_host_bytes()


def test_host_blocks_are_built_lazily():
    _, tg = _graphs("plain")
    sess = rt.GraphSession(tg, device="cpu")
    sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0))
    assert sess._staged._host_blocks is None  # a packed run never builds them
    assert not sess._staged._device_blocks
    sess.run(rt.ExecutionPlan(rt.PageRank(), max_iters=2, tol=0.0, execution="per_block"))
    assert sess._staged._host_blocks is not None
    assert set(sess.blocks) == set(sess.block_keys)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gather_op,reduce", [("mul", "sum"), ("add", "min"), ("add", "max")])
def test_kernel_operands_cached_and_equal_to_jax(gather_op, reduce, dtype):
    jg, tg = _graphs("weighted")
    jsess = jc.GraphSession(jg)
    tsess = rt.GraphSession(tg, device="cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for i, j in sorted(tsess.block_keys)[::7]:
        ops1 = tsess.kernel_operands(i, j, tdt, gather_op=gather_op, reduce=reduce)
        ops2 = tsess.kernel_operands(i, j, tdt, gather_op=gather_op, reduce=reduce)
        assert all(a is b for a, b in zip(ops1, ops2))  # staged once
        want = jsess.kernel_operands(i, j, jdt, gather_op=gather_op, reduce=reduce)
        for got, w in zip(ops1, want):
            w = np.asarray(w)
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
            assert got.device.type == "cpu"
            assert got.numpy().tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# Block primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,jprog,tprog", [
    ("weighted", jc.PageRank(), rt.PageRank()),
    ("weighted", jc.SSSP(), rt.SSSP()),
    ("er-src-sorted", jc.PageRank(), rt.PageRank()),
])
def test_block_primitives_bitwise_vs_jax(kind, jprog, tprog):
    """ToHub, FromHub and the direct update on the same blocks.

    The direct update starts from the identity accumulator, as a column's
    first block does. On a non-identity float-sum accumulator the JAX
    package's jit folds the edges straight into it (XLA turns
    ``acc + segment_sum(c)`` into a scatter-add into ``acc``), where the
    port and both packed paths fold the block's run from 0 first; there
    the two agree within a rounding step.
    """
    jg, tg = _graphs(kind)
    rng = np.random.default_rng(3)
    K, isz = 2, jg.interval_size
    prev = (rng.random((K, isz)) + 0.1).astype(np.float32)
    ident = np.full((K, isz), tprog.reduce == "min" and np.inf or 0.0, np.float32)
    acc0 = (rng.random((K, isz))).astype(np.float32)
    if tprog.reduce == "min":
        acc0[:, ::3] = np.inf
    jsess = jc.GraphSession(jg)
    tsess = rt.GraphSession(tg, device="cpu")
    jaux = jprog.make_aux(jg)
    taux = tprog.make_aux(tg)
    for key in sorted(tsess.block_keys)[::3]:
        i, j = key
        jblk, tblk = jsess.blocks[key], tsess.blocks[key]
        jview = jsess._interval_aux(jaux, i)
        tview = tsess._interval_aux(taux, i)
        for start in (ident, acc0):
            want = np.asarray(jsession._block_gather_reduce(
                jprog, jnp.asarray(prev), jview, {}, jblk["src_local"], jblk["dst_local"],
                jblk["weights"], jblk["e_valid"], jnp.asarray(start), num_segments=isz,
                has_weights=jg.weights is not None,
            ))
            got = tsession._block_gather_reduce(
                tprog, torch.from_numpy(prev), tview, {}, tblk,
                torch.from_numpy(start.copy()), tg.weights is not None,
            ).numpy()
            if start is ident or tprog.reduce != "sum":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6)
        jhub = jsession._block_to_hub(
            jprog, jnp.asarray(prev), jview, {}, jblk["src_local"], jblk["hub_inv"],
            jblk["dst_local"], jblk["weights"], jblk["e_valid"],
            num_segments=jblk["u_bucket"], has_weights=jg.weights is not None,
        )
        thub = tsession._block_to_hub(
            tprog, torch.from_numpy(prev), tview, {}, tblk, tg.weights is not None
        )
        np.testing.assert_array_equal(thub.numpy(), np.asarray(jhub)[:, : tblk["u"]])
        jacc = jsession._block_from_hub(jprog, jnp.asarray(acc0), jblk["hub_dst"], jhub, jblk["u_valid"])
        tacc = tsession._block_from_hub(tprog, torch.from_numpy(acc0.copy()), tblk["hub_dst"], thub)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("activity", ["auto", "off"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu", "fused"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_per_block_matches_jax(workload, strategy, activity):
    kind, jprog, tprog, kws, iters, tol = WORKLOADS[workload]
    jg, tg = _graphs(kind)
    budget = _budget(jg, jprog)
    jsess = jc.GraphSession(jg, memory_budget=budget, residency="device", execution="per_block")
    tsess = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency="device",
                            execution="per_block")
    if workload in PAGERANK:
        iters = JAX_PR_SWEEPS
    js, jtop = _run(jsess, jc, jprog, kws, strategy, iters, tol, activity)
    ts, ttop = _run(tsess, rt, tprog, kws, strategy, iters, tol, activity)
    if strategy == "mpu":
        assert 0 < ts[0].strategy.Q < tg.P
    for j, t in zip(js, ts):
        assert t.attrs.dtype == j.attrs.dtype and t.attrs.shape == j.attrs.shape
        if workload in PAGERANK:
            np.testing.assert_allclose(t.attrs, j.attrs, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_array_equal(t.attrs, j.attrs)
        assert t.iterations == j.iterations
        assert t.converged == j.converged
        assert t.strategy.strategy == j.strategy.strategy and t.strategy.Q == j.strategy.Q
    _same_meters_and_logs(ttop, jtop)


@pytest.mark.parametrize("strategy", ["spu", "dpu"])
@pytest.mark.parametrize("jprog,tprog,kw", [
    (jc.PageRank(), rt.PageRank(), {}),
    (jc.BFS(), rt.BFS(), {"root": 2}),
])
def test_src_sorted_per_block_matches_jax(jprog, tprog, kw, strategy):
    """Blocks whose edges are not grouped by destination fold through seg_order."""
    jg, tg = _graphs("er-src-sorted")
    budget = _budget(jg, jprog)
    plan = dict(strategy=strategy, max_iters=JAX_PR_SWEEPS, tol=0.0, program_kwargs=kw)
    j = jc.GraphSession(jg, memory_budget=budget, residency="device",
                        execution="per_block").run(jc.ExecutionPlan(jprog, **plan))
    t = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency="device",
                        execution="per_block").run(rt.ExecutionPlan(tprog, **plan))
    if jprog.reduce == "sum":
        np.testing.assert_allclose(t.attrs, j.attrs, rtol=1e-5, atol=1e-8)
    else:
        np.testing.assert_array_equal(t.attrs, j.attrs)
    assert t.iterations == j.iterations
    _same_meters_and_logs(t, j)


@pytest.mark.parametrize("activity", ["auto", "off"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_per_block_bitwise_equals_packed_kernel(workload, strategy, activity):
    bs, btop = _port_run(workload, strategy, activity, "per_block")
    ps, ptop = _port_run(workload, strategy, activity, "packed_kernel")
    for b, p in zip(bs, ps):
        np.testing.assert_array_equal(b.attrs.view(np.int32), p.attrs.view(np.int32))
        assert b.iterations == p.iterations and b.converged == p.converged
    _same_meters_and_logs(btop, ptop)


@pytest.mark.parametrize("workload", PAGERANK)
def test_fused_pagerank_close_to_spu(workload):
    spu, _ = _port_run(workload, "spu", "off", "per_block")
    fused, _ = _port_run(workload, "fused", "off", "per_block")
    for s, f in zip(spu, fused):
        np.testing.assert_allclose(f.attrs, s.attrs, rtol=1e-6, atol=1e-9)


def test_execution_axis_resolution():
    _, tg = _graphs("plain")
    sess = rt.GraphSession(tg, device="cpu")
    pr = rt.PageRank()
    assert sess.compile(rt.ExecutionPlan(pr, strategy="spu")).execution == "packed_kernel"
    assert sess.compile(rt.ExecutionPlan(pr, strategy="dpu", execution="per_block")).execution == "per_block"
    # fused runs per-block even where a packed mode was asked for
    fused = rt.ExecutionPlan(pr, strategy="fused", execution="packed_kernel", max_iters=3, tol=0.0)
    assert sess.compile(fused).execution == "per_block"
    res = sess.run(fused)
    assert res.meters.edges_processed == 3 * tg.m
    assert res.meters.peak_device_graph_bytes == tg.m * sess.Be
    # "packed" (the plain tile sweep) runs by name; "auto" stays the kernel.
    assert sess.compile(rt.ExecutionPlan(pr, strategy="mpu", execution="packed")).execution == "packed"
    assert sess.compile(rt.ExecutionPlan(pr, strategy="mpu")).execution == "packed_kernel"
    with pytest.raises(ValueError, match="unknown strategy"):
        sess.run(rt.ExecutionPlan(pr, strategy="turbograph"))
