"""End-to-end parity: the port's GraphSession against the JAX package's.

Same graph, same plans, at device residency; the JAX side runs its packed
scan (``execution="packed"``), the port its tile sweep (the plain version
on the CPU). Compared per run:

* attrs bitwise for the min/max programs (BFS, SSSP, WCC);
* PageRank attrs within ``rtol=1e-5, atol=1e-8``: the dangling-mass sum
  (``vertex_programs.py`` ``pre_iteration``) has no pinned order on either
  side, and XLA fuses the apply's float arithmetic where PyTorch runs it
  op by op, so the last bits may differ;
* ``MODEL_METER_FIELDS``, ``iterations``, ``converged`` and
  ``activity_log`` identical.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.convert import dsss_from_arrays  # noqa: E402

# tests/test_golden_pagerank.py's frozen ranking for rmat(10, 8, seed=42), P=8.
GOLDEN_TOP20 = [
    0, 1, 232, 122, 2, 444, 16, 32, 4, 8,
    63, 263, 234, 71, 48, 18, 24, 10, 64, 5,
]

_GRAPHS: dict = {}


def _graphs(kind: str):
    if kind not in _GRAPHS:
        src, dst = j_rmat(10, edge_factor=8, seed=42)
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


# name: (graph kind, JAX program, port program, per-query kwargs, max_iters, tol)
WORKLOADS = {
    "pagerank": ("plain", jc.PageRank(), rt.PageRank(), [{}], 30, 0.0),
    "ppr-batch": ("plain", jc.PageRank(), rt.PageRank(),
                  [{"personalize": v} for v in (0, 5, 17)], 20, 0.0),
    "bfs-batch": ("plain", jc.BFS(), rt.BFS(), [{"root": r} for r in (0, 3, 9, 40)], 1000, 1e-10),
    "sssp-weighted": ("weighted", jc.SSSP(), rt.SSSP(), [{"root": 1}], 1000, 1e-10),
    "wcc-symmetrized": ("symmetrized", jc.WCC(), rt.WCC(), [{}], 1000, 1e-10),
}


def _run(workload, strategy, activity):
    kind, jprog, tprog, kws, iters, tol = WORKLOADS[workload]
    jg, tg = _graphs(kind)
    budget = 2 * jg.n_pad * jprog.attr_bytes + 3_000  # MPU with 0 < Q < P
    jsess = jc.GraphSession(jg, memory_budget=budget, residency="device", execution="packed")
    tsess = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency="device")

    def plans(mod, prog):
        return [
            mod.ExecutionPlan(prog, strategy=strategy, max_iters=iters, tol=tol,
                              activity=activity, program_kwargs=kw)
            for kw in kws
        ]

    if len(kws) == 1:
        j = jsess.run(plans(jc, jprog)[0])
        t = tsess.run(plans(rt, tprog)[0])
        return [j], [t], j, t
    jb = jsess.run_batch(plans(jc, jprog))
    tb = tsess.run_batch(plans(rt, tprog))
    assert jb.fused and tb.fused
    return list(jb), list(tb), jb, tb


@pytest.mark.parametrize("activity", ["auto", "off"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_session_matches_jax(workload, strategy, activity):
    js, ts, jtop, ttop = _run(workload, strategy, activity)
    for j, t in zip(js, ts):
        assert t.attrs.dtype == j.attrs.dtype and t.attrs.shape == j.attrs.shape
        if workload in ("pagerank", "ppr-batch"):
            np.testing.assert_allclose(t.attrs, j.attrs, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_array_equal(t.attrs, j.attrs)
        assert t.iterations == j.iterations
        assert t.converged == j.converged
        assert t.strategy.strategy == j.strategy.strategy and t.strategy.Q == j.strategy.Q
    assert ttop.meters.model_dict() == jtop.meters.model_dict()
    assert len(ttop.activity_log) == len(jtop.activity_log)
    for a, b in zip(ttop.activity_log, jtop.activity_log):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu", "auto"])
def test_golden_top20_pagerank(strategy):
    _, tg = _graphs("plain")
    budget = 2 * tg.n_pad * rt.PageRank().attr_bytes + 3_000
    sess = rt.GraphSession(
        tg, device="cpu", residency="device",
        memory_budget=budget if strategy != "spu" else None,
    )
    res = sess.run(rt.ExecutionPlan(rt.PageRank(), strategy=strategy, max_iters=30, tol=0.0))
    top20 = np.argsort(-res.output, kind="stable")[:20]
    np.testing.assert_array_equal(top20, GOLDEN_TOP20)


def test_selective_is_bitwise_full_sweep_and_skips_tiles():
    _, tg = _graphs("plain")
    sess = rt.GraphSession(tg, device="cpu")
    plans = {
        a: rt.ExecutionPlan(rt.BFS(), max_iters=1000, activity=a, program_kwargs={"root": 3})
        for a in ("auto", "off")
    }
    auto, off = sess.run(plans["auto"]), sess.run(plans["off"])
    np.testing.assert_array_equal(auto.attrs, off.attrs)
    assert auto.meters.edges_processed < off.meters.edges_processed
    assert not all(row.all() for row in auto.activity_log)


_RMAT8: dict = {}


def _rmat8():
    if not _RMAT8:
        el = j_densify(*j_rmat(8, edge_factor=8, seed=7), drop_self_loops=True)
        jg = jc.build_dsss(el, 4)
        fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
        fields["edgelist"] = vars(jg.edgelist)
        _RMAT8["g"] = (jg, dsss_from_arrays(fields))
    return _RMAT8["g"]


@pytest.mark.parametrize("program", ["pagerank", "bfs"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
def test_meter_aggregates_match_jax(strategy, program):
    """bytes_read/written/total and every per_iteration() field equal the JAX package's."""
    jg, tg = _rmat8()
    budget = 2 * jg.n_pad * 4 + 1_000  # MPU with 0 < Q < P
    if program == "pagerank":
        jprog, tprog, kw, iters = jc.PageRank(), rt.PageRank(), {}, 7
    else:
        jprog, tprog, kw, iters = jc.BFS(), rt.BFS(), {"root": 3}, jg.n + 1
    jm = jc.GraphSession(jg, memory_budget=budget, residency="device", execution="packed").run(
        jc.ExecutionPlan(jprog, strategy=strategy, max_iters=iters, tol=0.0, program_kwargs=kw)
    ).meters
    tm = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency="device").run(
        rt.ExecutionPlan(tprog, strategy=strategy, max_iters=iters, tol=0.0, program_kwargs=kw)
    ).meters
    assert tm.iterations == jm.iterations > 1
    for name in ("bytes_read", "bytes_written", "bytes_total"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.bytes_total > 0
    jp, tp = jm.per_iteration(), tm.per_iteration()
    assert type(tp) is type(tm)
    for f in dataclasses.fields(tp):
        if f.name != "wall_seconds":
            assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.wall_seconds == tm.wall_seconds
    assert tp.bytes_read_edges == tm.bytes_read_edges / tm.iterations
