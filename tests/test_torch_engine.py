"""The NXGraphEngine shim, the baseline schedules and custom strategies, against the JAX package.

Both packages run the same seeded graphs at device residency
(``residency="device"`` on both sides, so a budget only sets the strategy
and the modelled meters; under ``"auto"`` a budget means host residency,
which the port refuses). Compared per run: attrs bitwise for the monotone
programs (BFS, WCC), PageRank within ``rtol=1e-6, atol=1e-9`` (the
reference's own tolerance, ``tests/test_engine_strategies.py``), and
``MODEL_METER_FIELDS`` field for field. The TurboGraph-like baseline folds
each destination in SPU's order, so its PageRank equals the port's SPU
bits.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import iomodel as jio  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import iomodel as tio  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.graph.generators import rmat as t_rmat  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify as t_densify  # noqa: E402

ITERS = 8
TOL = dict(rtol=1e-6, atol=1e-9)
_GRAPHS: dict = {}


def _graph(n=120, m=600, seed=0, P=4):
    """(JAX DSSSGraph, port DSSSGraph) of the reference tests' ER graphs."""
    key = (n, m, seed, P)
    if key not in _GRAPHS:
        jg = jc.build_dsss(j_densify(*j_er(n, m, seed=seed), drop_self_loops=True), P)
        fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
        fields["edgelist"] = vars(jg.edgelist)
        _GRAPHS[key] = (jg, convert.dsss_from_arrays(fields))
    return _GRAPHS[key]


def _meters_equal(t, j):
    for f in rt.MODEL_METER_FIELDS:
        assert getattr(t.meters, f) == getattr(j.meters, f), f


def _bits(a):
    return a.view(np.int32)


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu", "fused"])
def test_engine_pagerank_matches_reference(strategy):
    jg, tg = _graph(seed=1)
    kw = dict(strategy=strategy, memory_budget=4_000, residency="device")
    j = jc.NXGraphEngine(jg, jc.PageRank(), **kw).run(ITERS, tol=0.0)
    t = rt.NXGraphEngine(tg, rt.PageRank(), device="cpu", **kw).run(ITERS, tol=0.0)
    np.testing.assert_allclose(t.attrs, j.attrs, **TOL)
    assert t.iterations == j.iterations and t.strategy.strategy == j.strategy.strategy
    _meters_equal(t, j)


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu", "fused"])
@pytest.mark.parametrize("program", ["BFS", "WCC"])
def test_engine_monotone_programs_match_reference(program, strategy):
    jg, tg = _graph(seed=2)
    kw = dict(strategy=strategy, memory_budget=2_000, residency="device")
    run_kw = {"root": 0} if program == "BFS" else {}
    j = jc.NXGraphEngine(jg, getattr(jc, program)(), **kw).run(200, **run_kw)
    eng = rt.NXGraphEngine(tg, getattr(rt, program)(), device="cpu", **kw)
    t = eng.run(200, **run_kw)
    np.testing.assert_array_equal(t.attrs, j.attrs)
    assert t.iterations == j.iterations and t.converged == j.converged
    _meters_equal(t, j)
    want = "per_block" if strategy == "fused" else "packed_kernel"
    assert eng.execution == want


def test_engine_attributes_mirror_reference():
    jg, tg = _graph(seed=4)
    kw = dict(strategy="mpu", memory_budget=3_000, residency="device", Be=12, Bv=8)
    j = jc.NXGraphEngine(jg, jc.PageRank(), **kw)
    t = rt.NXGraphEngine(tg, rt.PageRank(), device="cpu", **kw)
    assert (t.Be, t.Bv, t.has_weights, t.memory_budget) == (j.Be, j.Bv, j.has_weights, j.memory_budget)
    assert dataclasses.asdict(t.params) == dataclasses.asdict(j.params)
    assert (t.choice.strategy, t.choice.Q) == (j.choice.strategy, j.choice.Q)
    assert t.resident == j.resident
    assert sorted(t.blocks) == sorted(j.blocks)


@pytest.mark.parametrize("execution", ["per_block", "packed", "packed_kernel"])
def test_engine_execution_override_gives_the_same_bits(execution):
    _, tg = _graph(seed=3)
    base = rt.NXGraphEngine(tg, rt.PageRank(), strategy="spu", device="cpu").run(ITERS, tol=0.0)
    eng = rt.NXGraphEngine(tg, rt.PageRank(), strategy="spu", execution=execution, device="cpu")
    assert eng.execution == execution
    got = eng.run(ITERS, tol=0.0)
    np.testing.assert_array_equal(_bits(got.attrs), _bits(base.attrs))
    assert got.meters.model_dict() == base.meters.model_dict()


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"residency": "host"}, "residency"),
        ({"memory_budget": 123}, "memory_budget"),
        ({"Be": 16}, "Be="),
        ({"Bv": 8}, "Bv="),
        ({"packing": "subshard"}, "packing"),
        ({"device": "meta"}, "device"),
    ],
    ids=lambda v: "-".join(v) if isinstance(v, dict) else v,
)
def test_shared_session_conflicts_raise(kw, match):
    _, tg = _graph(seed=3)
    sess = rt.GraphSession(tg, device="cpu")
    with pytest.raises(ValueError, match=match):
        rt.NXGraphEngine(tg, rt.PageRank(), session=sess, **kw)


def test_shared_session_conflicts_mirror_reference():
    """The reference raises for the same arguments (device aside)."""
    jg, _ = _graph(seed=3)
    jsess = jc.GraphSession(jg)
    for kw in ({"residency": "host"}, {"memory_budget": 123}, {"Be": 16}, {"Bv": 8},
               {"packing": "subshard"}):
        with pytest.raises(ValueError):
            jc.NXGraphEngine(jg, jc.PageRank(), session=jsess, **kw)
    with pytest.raises(ValueError, match="different graph"):
        jc.NXGraphEngine(_graph(seed=4)[0], jc.PageRank(), session=jsess)


def test_shared_session_of_another_graph_raises():
    _, tg = _graph(seed=3)
    _, other = _graph(seed=4)
    sess = rt.GraphSession(tg, device="cpu")
    with pytest.raises(ValueError, match="different graph"):
        rt.NXGraphEngine(other, rt.PageRank(), session=sess)
    # Arguments that agree with the session are accepted.
    eng = rt.NXGraphEngine(tg, rt.PageRank(), session=sess, device="cpu", Be=8, Bv=4,
                           packing="auto", residency="device")
    assert eng.session is sess


@pytest.mark.parametrize("hook", ["checkpoint", "resume_from", "cancel"])
def test_reliability_hooks_are_not_ported(hook, tmp_path):
    """The hooks are ported (ROADMAP A10, second part) and reach the session:
    snapshots are written, a resume gives the uninterrupted bits, and
    ``cancel`` sees every sweep boundary."""
    from repro_torch.reliability import CheckpointSpec, DeadlineExceeded, list_snapshots

    _, tg = _graph(seed=3)
    eng = rt.NXGraphEngine(tg, rt.PageRank(), device="cpu")
    ref = eng.run(ITERS, tol=0.0)
    ck = CheckpointSpec(str(tmp_path / "s"), every=2, keep=2)
    if hook == "checkpoint":
        got = eng.run(ITERS, tol=0.0, checkpoint=ck)
        assert len(list_snapshots(ck.directory)) == 2
    elif hook == "resume_from":
        eng.run(4, tol=0.0, checkpoint=ck)
        got = eng.run(ITERS, tol=0.0, checkpoint=ck, resume_from=ck.directory)
    else:
        seen = []
        got = eng.run(ITERS, tol=0.0, cancel=seen.append)
        assert seen == list(range(ITERS))

        def stop(sweep):
            if sweep == 3:
                raise DeadlineExceeded("deadline")

        with pytest.raises(DeadlineExceeded):
            eng.run(ITERS, tol=0.0, cancel=stop)
    np.testing.assert_array_equal(got.attrs.view(np.int32), ref.attrs.view(np.int32))


def test_engine_defaults_to_the_card(monkeypatch):
    import torch

    _, tg = _graph(seed=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.NXGraphEngine(tg, rt.PageRank())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbase.TurboGraphLikeEngine(tg, rt.PageRank())


# -- TurboGraph-like -----------------------------------------------------------
@pytest.mark.parametrize("seed,P", [(3, 4), (8, 8), (5, 3), (6, 1)])
def test_turbograph_like_bitwise_equals_port_spu(seed, P):
    _, tg = _graph(n=160, m=800, seed=seed, P=P)
    tgl = tbase.TurboGraphLikeEngine(tg, rt.PageRank(), device="cpu").run(ITERS, tol=0.0)
    for execution in ("per_block", "packed_kernel"):
        spu = rt.NXGraphEngine(tg, rt.PageRank(), strategy="spu", execution=execution,
                               device="cpu").run(ITERS, tol=0.0)
        np.testing.assert_array_equal(_bits(tgl.attrs), _bits(spu.attrs))
    assert tgl.strategy.strategy == "turbograph-like"


@pytest.mark.parametrize("seed,P", [(3, 4), (8, 8)])
def test_turbograph_like_matches_reference(seed, P):
    jg, tg = _graph(n=160, m=800, seed=seed, P=P)
    j = jbase.TurboGraphLikeEngine(jg, jc.PageRank()).run(ITERS, tol=0.0)
    t = tbase.TurboGraphLikeEngine(tg, rt.PageRank(), device="cpu").run(ITERS, tol=0.0)
    np.testing.assert_allclose(t.attrs, j.attrs, **TOL)
    assert t.iterations == j.iterations
    _meters_equal(t, j)


@pytest.mark.parametrize("program", ["BFS", "WCC"])
def test_turbograph_like_monotone_matches_reference(program):
    jg, tg = _graph(seed=2)
    run_kw = {"root": 3} if program == "BFS" else {}
    j = jbase.TurboGraphLikeEngine(jg, getattr(jc, program)()).run(200, **run_kw)
    t = tbase.TurboGraphLikeEngine(tg, getattr(rt, program)(), device="cpu").run(200, **run_kw)
    np.testing.assert_array_equal(t.attrs, j.attrs)
    assert t.iterations == j.iterations and t.converged == j.converged
    _meters_equal(t, j)


def test_turbograph_like_np_scaling():
    """The baseline's interval traffic is (P + non-empty blocks)·isz·Ba read, P·isz·Ba written."""
    _, tg = _graph(n=160, m=800, seed=8, P=8)
    prog = rt.PageRank()
    eng = tbase.TurboGraphLikeEngine(tg, prog, device="cpu")
    per = eng.run(ITERS, tol=0.0).meters.per_iteration()
    Ba = prog.attr_bytes
    nonempty = len(eng.blocks)
    assert per.bytes_read_intervals == pytest.approx((tg.P + nonempty) * tg.interval_size * Ba)
    assert per.bytes_written_intervals == pytest.approx(tg.P * tg.interval_size * Ba)


def test_turbograph_like_memory_budget_only_parameterizes_the_model():
    _, tg = _graph(seed=3)
    eng = tbase.TurboGraphLikeEngine(tg, rt.PageRank(), memory_budget=5_000, device="cpu")
    assert eng.memory_budget == 5_000 and eng.session.memory_budget is None
    assert eng.resident == frozenset() and eng.execution == "per_block"
    assert tbase.turbograph_like_partitions(1000, 8, 4000) == jbase.turbograph_like_partitions(1000, 8, 4000)


@settings(max_examples=60, deadline=None)
@given(
    n=st.integers(1, 10**7),
    deg=st.integers(0, 64),
    P=st.integers(1, 64),
    Ba=st.sampled_from([4, 8]),
    d=st.floats(0.5, 40.0),
    B_M=st.one_of(st.none(), st.integers(0, 10**9)),
)
def test_turbograph_like_io_matches_reference(n, deg, P, Ba, d, B_M):
    kw = dict(n=n, m=n * deg, Ba=Ba, d=d, P=P)
    tp, jp = tio.IOParams(**kw), jio.IOParams(**kw)
    if B_M is not None:
        assert tio.turbograph_like_io(tp, B_M) == jio.turbograph_like_io(jp, B_M)
    assert tio.modelled_io(tp, B_M, "turbograph-like") == jio.modelled_io(jp, B_M, "turbograph-like")


# -- custom strategies ---------------------------------------------------------
def test_registered_strategy_wrapping_spu_gives_spu_bits():
    _, tg = _graph(seed=5)
    calls = []

    def wrapped(ctx, attrs, active, meters):
        assert attrs.shape == (ctx.K, tg.P, tg.interval_size) and attrs.device == ctx.session.device
        assert isinstance(active, np.ndarray) and active.shape == (ctx.K, tg.P) and active.dtype == bool
        calls.append(1)
        new, active_next = tsession._iteration_spu(ctx, attrs, active, meters)
        assert isinstance(active_next, np.ndarray) and active_next.shape == (ctx.K, tg.P)
        return new, active_next

    rt.GraphSession.register_strategy("wrapped-spu", wrapped)
    try:
        sess = rt.GraphSession(tg, device="cpu")
        for prog, kw, iters, tol in ((rt.PageRank(), {}, ITERS, 0.0),
                                     (rt.BFS(), {"root": 1}, 200, 1e-10)):
            plan = rt.ExecutionPlan(prog, max_iters=iters, tol=tol, program_kwargs=kw)
            spu = sess.run(dataclasses.replace(plan, strategy="spu", execution="per_block"))
            custom_plan = dataclasses.replace(plan, strategy="wrapped-spu", execution="packed_kernel")
            assert sess.compile(custom_plan).execution == "per_block"
            assert sess.compile(custom_plan).choice == tsession.StrategyChoice("wrapped-spu", 0, 0.0, 0.0)
            got = sess.run(custom_plan)
            np.testing.assert_array_equal(_bits(got.attrs), _bits(spu.attrs))
            assert got.iterations == spu.iterations
            # A custom schedule pins no sub-shard: every edge it reads is charged.
            want = dict(spu.meters.model_dict(), bytes_read_edges=spu.meters.edges_processed * sess.Be)
            assert got.meters.model_dict() == want
        assert calls
    finally:
        tsession._STRATEGIES.pop("wrapped-spu", None)


def test_unknown_strategy_raises():
    _, tg = _graph(seed=5)
    sess = rt.GraphSession(tg, device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="no-such-schedule"))
    with pytest.raises(ValueError, match="unknown strategy"):
        rt.NXGraphEngine(tg, rt.PageRank(), strategy="no-such-schedule", device="cpu")


# -- GraphChi-like layout ------------------------------------------------------
def test_build_graphchi_like_matches_reference_and_runs_under_auto():
    src, dst = j_rmat(9, edge_factor=8, seed=6)
    jel = j_densify(src, dst, drop_self_loops=True)
    tel = t_densify(*t_rmat(9, edge_factor=8, seed=6), drop_self_loops=True)
    jg, tg = jbase.build_graphchi_like(jel, 4), tbase.build_graphchi_like(tel, 4)
    assert tg.src_sorted and jg.src_sorted
    for f in dataclasses.fields(jg):
        if f.name == "edgelist":
            continue
        a, b = getattr(tg, f.name), getattr(jg, f.name)
        if isinstance(b, np.ndarray) or b is None:
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    sess = rt.GraphSession(tg, device="cpu")
    assert sess.packing == "subshard" and sess.resolved_execution("spu", "device") == "packed_kernel"
    t = sess.run(rt.ExecutionPlan(rt.BFS(), max_iters=tg.n + 1, program_kwargs={"root": 0}))
    j = jc.GraphSession(jg, execution="packed").run(
        jc.ExecutionPlan(jc.BFS(), max_iters=jg.n + 1, program_kwargs={"root": 0})
    )
    np.testing.assert_array_equal(t.attrs, j.attrs)
    _meters_equal(t, j)
