"""The port's §IV drivers and their session cache against the JAX package's.

Same seeded graphs through ``repro.core.algorithms`` and
``repro_torch.core.algorithms`` (``device="cpu"``; on the JAX side
``execution="auto"`` is the XLA scan on the CPU). Compared per driver:

* attrs (or SCC labels) bitwise for BFS, SSSP, WCC and SCC;
* PageRank within ``rtol=1e-6, atol=1e-9`` of the JAX driver (the
  reference's own tolerance, ``tests/test_engine_strategies.py``; the
  dangling-mass sum has no pinned order) and bitwise against the port's own
  ``GraphSession`` run of the same plan;
* ``iterations``, ``converged`` and ``MODEL_METER_FIELDS`` equal.

Then the cache (``get_session``, the drivers' sharded-graph LRU) and the
refusals of what is not ported.
"""
import gc

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.graph import generators as jgen  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify as t_densify  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-9)

# name: (generator, kwargs, P, weighted)
GRAPHS = {
    "er-P4": ("erdos_renyi", dict(n=120, m=600, seed=1), 4, False),
    "rmat10-P8": ("rmat", dict(scale=10, edge_factor=8, seed=42), 8, False),
    "ring-P3": ("ring", dict(n=40), 3, False),
    "er-P1": ("erdos_renyi", dict(n=90, m=400, seed=7), 1, False),
    "rmat9-P4-weighted": ("rmat", dict(scale=9, edge_factor=8, seed=5), 4, True),
}

_CACHE: dict = {}


def _edge_lists(name):
    """(JAX EdgeList, port EdgeList) of one graph, built once per process."""
    key = ("el", name)
    if key not in _CACHE:
        gen, kw, _, weighted = GRAPHS[name]
        js, jd = getattr(jgen, gen)(**kw)
        ts, td = getattr(tgen, gen)(**kw)
        w = None
        if weighted:
            w = np.random.default_rng(11).random(js.shape[0]).astype(np.float32) + 0.05
        _CACHE[key] = (
            j_densify(js, jd, w, drop_self_loops=True),
            t_densify(ts, td, w, drop_self_loops=True),
        )
    return _CACHE[key]


def _graphs(name):
    """(JAX DSSSGraph, port DSSSGraph), kept alive for the session caches."""
    key = ("g", name)
    if key not in _CACHE:
        jel, tel = _edge_lists(name)
        P = GRAPHS[name][2]
        _CACHE[key] = (jc.build_dsss(jel, P), rt.build_dsss(tel, P))
    return _CACHE[key]


def _same_run(t, j):
    assert t.iterations == j.iterations and t.converged == j.converged
    for f in rt.MODEL_METER_FIELDS:
        assert getattr(t.meters, f) == getattr(j.meters, f), f


@pytest.mark.parametrize("name", ["er-P4", "rmat10-P8", "ring-P3", "er-P1"])
def test_pagerank_matches_reference(name):
    jg, tg = _graphs(name)
    j = jalg.pagerank(jg, iters=10)
    t = talg.pagerank(tg, iters=10, device="cpu")
    np.testing.assert_allclose(t.attrs, j.attrs, **TOL)
    _same_run(t, j)
    own = rt.GraphSession(tg, device="cpu").run(
        rt.ExecutionPlan(rt.PageRank(), max_iters=10, tol=0.0)
    )
    np.testing.assert_array_equal(t.attrs.view(np.int32), own.attrs.view(np.int32))


@pytest.mark.parametrize("root", [0, 7])
@pytest.mark.parametrize("name", ["er-P4", "rmat10-P8", "ring-P3", "er-P1"])
def test_bfs_matches_reference(name, root):
    jg, tg = _graphs(name)
    j = jalg.bfs(jg, root)
    t = talg.bfs(tg, root, device="cpu")
    np.testing.assert_array_equal(t.attrs, j.attrs)
    assert t.output == j.output
    _same_run(t, j)


@pytest.mark.parametrize("name", ["er-P4", "rmat10-P8", "ring-P3"])
def test_multi_bfs_matches_reference(name):
    jg, tg = _graphs(name)
    roots = [0, 3, 9, 17]
    j = jalg.multi_bfs(jg, roots)
    t = talg.multi_bfs(tg, roots, device="cpu")
    assert t.fused and j.fused
    assert t.iterations == j.iterations and t.converged == j.converged
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.attrs, b.attrs)
        assert a.iterations == b.iterations
    for f in rt.MODEL_METER_FIELDS:
        assert getattr(t.meters, f) == getattr(j.meters, f), f
    single = talg.bfs(tg, roots[2], device="cpu")
    np.testing.assert_array_equal(t[2].attrs, single.attrs)


@pytest.mark.parametrize("name", ["rmat9-P4-weighted", "er-P4", "er-P1"])
def test_sssp_matches_reference(name):
    jg, tg = _graphs(name)
    j = jalg.sssp(jg, 2)
    t = talg.sssp(tg, 2, device="cpu")
    np.testing.assert_array_equal(t.attrs.view(np.int32), j.attrs.view(np.int32))
    _same_run(t, j)


@pytest.mark.parametrize("name", ["rmat9-P4-weighted", "rmat10-P8"])
def test_multi_sssp_matches_reference(name):
    jg, tg = _graphs(name)
    roots = [1, 4, 30]
    j = jalg.multi_sssp(jg, roots)
    t = talg.multi_sssp(tg, roots, device="cpu")
    assert t.fused == j.fused and t.iterations == j.iterations
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
        assert a.iterations == b.iterations and a.converged == b.converged
    for f in rt.MODEL_METER_FIELDS:
        assert getattr(t.meters, f) == getattr(j.meters, f), f


def test_sssp_unweighted_equals_bfs_depths():
    _, tg = _graphs("rmat10-P8")
    roots = [0, 5]
    depths = talg.multi_bfs(tg, roots, device="cpu")
    dist = talg.multi_sssp(tg, roots, device="cpu")
    for d, s in zip(depths, dist):
        reached = d.attrs < rt.INF_DEPTH
        want = np.where(reached, d.attrs.astype(np.float32), np.float32(np.inf))
        np.testing.assert_array_equal(s.attrs, want)


@pytest.mark.parametrize("name", ["er-P4", "rmat10-P8", "ring-P3"])
def test_wcc_from_edge_list_matches_reference(name):
    jel, tel = _edge_lists(name)
    P = GRAPHS[name][2]
    j = jalg.wcc(jel, P=P)
    t = talg.wcc(tel, P=P, device="cpu")
    np.testing.assert_array_equal(t.attrs, j.attrs)
    _same_run(t, j)


@pytest.mark.parametrize("name", ["er-P4", "rmat10-P8"])
def test_wcc_from_symmetric_dsss_matches_reference(name):
    jel, tel = _edge_lists(name)
    P = GRAPHS[name][2]
    jg, tg = jc.build_dsss(jel.symmetrized(), P), rt.build_dsss(tel.symmetrized(), P)
    j = jalg.wcc(jg)
    t = talg.wcc(tg, device="cpu")
    np.testing.assert_array_equal(t.attrs, j.attrs)
    _same_run(t, j)
    # The component labels are the least vertex id of each weak component.
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = tel.n
    _, comp = connected_components(
        coo_matrix((np.ones(tel.m), (tel.src, tel.dst)), shape=(n, n)), connection="weak"
    )
    least = np.full(comp.max() + 1, n)
    np.minimum.at(least, comp, np.arange(n))
    np.testing.assert_array_equal(t.attrs, least[comp])


def _two_rings(n):
    a = np.arange(n, dtype=np.int64)
    src = np.concatenate([a, a + n, [0, n + 3]])
    dst = np.concatenate([(a + 1) % n, (a + 1) % n + n, [n, 2]])
    return src, dst


SCC_CASES = {
    "ring-P3": (lambda m: m.ring(30), 3),
    "two-rings-P4": (lambda m: _two_rings(25), 4),
    "rmat10-P8": (lambda m: m.rmat(10, edge_factor=8, seed=42), 8),
}


@pytest.mark.parametrize("case", list(SCC_CASES))
def test_scc_matches_reference(case):
    make, P = SCC_CASES[case]
    jel = j_densify(*make(jgen), drop_self_loops=True)
    tel = t_densify(*make(tgen), drop_self_loops=True)
    j = jalg.scc(jel, P=P)
    t = talg.scc(tel, P=P, device="cpu")
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_edge_list_reversed_and_index_to_id_match_reference():
    jel, tel = _edge_lists("rmat10-P8")
    jr, tr = jel.reversed(), tel.reversed()
    for f in ("src", "dst", "out_degree", "in_degree", "id_to_index"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    assert tr.n == jr.n and tr.weights is None and jr.weights is None
    idx = tel.id_to_index[[0, 5, 17, tel.n - 1]]
    np.testing.assert_array_equal(tel.index_to_id(idx), jel.index_to_id(idx))
    assert tel.index_to_id(idx).dtype == np.int32
    missing = np.setdiff1d(np.arange(tel.id_to_index.max() + 2), tel.id_to_index)[:1]
    for el in (tel, jel):
        with pytest.raises(KeyError):
            el.index_to_id(missing)


# -- the session cache ---------------------------------------------------------
def test_same_graph_object_gives_the_same_session():
    rt.clear_session_cache()
    _, tg = _graphs("er-P4")
    a = rt.get_session(tg, device="cpu")
    assert rt.get_session(tg, device="cpu") is a
    talg.pagerank(tg, iters=2, device="cpu")
    assert talg._session(tg, 8, None, "auto", "auto", "cpu") is a


@pytest.mark.parametrize(
    "other",
    [
        {"device": "meta"},
        {"memory_budget": 4_000, "residency": "device"},
        {"execution": "packed"},
        {"execution": "per_block"},
        {"packing": "subshard"},
        {"Be": 12},
    ],
    ids=lambda kw: "-".join(kw),
)
def test_variants_get_their_own_session_over_one_staging(other):
    rt.clear_session_cache()
    _, tg = _graphs("er-P4")
    base = rt.get_session(tg, device="cpu")
    kw = {"device": "cpu", **other}
    variant = rt.get_session(tg, **kw)
    assert variant is not base and rt.get_session(tg, **kw) is variant
    assert variant._staged is base._staged
    assert variant.device.type == kw["device"]


def test_same_edge_list_and_P_give_the_same_dsss():
    _, tel = _edge_lists("er-P4")
    g4 = talg._as_graph(tel, 4)
    assert talg._as_graph(tel, 4) is g4
    assert talg._as_graph(tel, 3) is not g4
    assert talg._as_graph(g4, 8) is g4  # a DSSSGraph passes through


def test_clear_session_cache_releases_the_sessions():
    rt.clear_session_cache()
    tel = _edge_lists("ring-P3")[1]
    g = rt.build_dsss(tel, 3)
    sess = rt.get_session(g, device="cpu")
    ref = __import__("weakref").ref(sess)
    del sess
    rt.clear_session_cache()
    gc.collect()
    assert ref() is None
    assert rt.get_session(g, device="cpu") is not None


def test_a_dead_graph_slot_is_not_served_again():
    lru = tsession.IdentityLRU(size=4)

    class Obj:
        pass

    a = Obj()
    first = lru.get_or_build(a, (), lambda: "a's value")
    assert lru.get_or_build(a, (), lambda: "rebuilt") == first
    key = id(a)
    del a
    gc.collect()
    b = Obj()
    # Force the recycled id: the slot's weakref is dead, so it is rebuilt.
    lru._entries[(id(b),)] = lru._entries.pop((key,))
    assert lru.get_or_build(b, (), lambda: "b's value") == "b's value"
    # Eviction keeps the newest `size` slots.
    keep = [Obj() for _ in range(6)]
    for o in keep:
        lru.get_or_build(o, (), object)
    assert len(lru._entries) == 4


def test_driver_on_a_fresh_graph_after_the_old_one_died():
    rt.clear_session_cache()
    tel = _edge_lists("ring-P3")[1]
    g = rt.build_dsss(tel, 3)
    talg.bfs(g, 0, device="cpu")
    del g
    gc.collect()
    g2 = rt.build_dsss(t_densify(*tgen.ring(12)), 3)
    res = talg.bfs(g2, 0, device="cpu")
    np.testing.assert_array_equal(res.attrs, np.arange(12))


# -- refusals ------------------------------------------------------------------
def test_wcc_refuses_an_asymmetric_dsss():
    _, tg = _graphs("er-P4")
    with pytest.raises(ValueError, match="symmetrized"):
        talg.wcc(tg, device="cpu")


@pytest.mark.parametrize("driver", [talg.multi_bfs, talg.multi_sssp])
def test_server_is_not_ported(driver):
    """``server=`` is ported (ROADMAP A11): the sources go through the graph
    server's micro-batcher and come back equal to the direct batch."""
    from repro_torch.serving import GraphServer

    _, tg = _graphs("ring-P3")
    direct = driver(tg, [0, 1], device="cpu")
    via = driver(tg, [0, 1], device="cpu", server=GraphServer(max_batch=8, max_wait_ms=1.0))
    assert via.fused and len(via) == len(direct)
    for a, b in zip(direct, via):
        np.testing.assert_array_equal(a.attrs, b.attrs)
        assert a.iterations == b.iterations


@pytest.mark.parametrize("driver", ["pagerank", "bfs", "sssp", "wcc"])
def test_budget_under_auto_residency_is_not_ported(driver):
    """A budget under the default residency="auto" means host residency (ported
    since ROADMAP A7-A8): the driver streams, with device residency's results."""
    rt.clear_session_cache()
    tel = _edge_lists("ring-P3")[1]
    g = rt.build_dsss(tel.symmetrized() if driver == "wcc" else tel, 3)
    host = getattr(talg, driver)(g, device="cpu", memory_budget=1_000)
    assert rt.get_session(g, device="cpu", memory_budget=1_000).resolved_residency() == "host"
    # residency="device" keeps the budget a modelled one.
    dev = getattr(talg, driver)(g, device="cpu", memory_budget=1_000, residency="device")
    assert dev.meters.bytes_h2d == 0
    np.testing.assert_array_equal(host.attrs.view(np.int32), dev.attrs.view(np.int32))
    assert host.meters.model_dict() == dev.meters.model_dict()


def test_host_memory_budget_is_not_ported():
    # Ported with the disk tier: keyed and forwarded, and an in-memory graph
    # refuses the disk tier's RAM bound with the session's own error, as the
    # JAX package's get_session does.
    jg, tg = _graphs("ring-P3")
    with pytest.raises(ValueError, match="host_memory_budget"):
        rt.get_session(tg, device="cpu", host_memory_budget=10_000)
    with pytest.raises(ValueError, match="host_memory_budget"):
        jc.get_session(jg, host_memory_budget=10_000)


def test_drivers_default_to_the_card(monkeypatch):
    import torch

    _, tg = _graphs("ring-P3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: talg.pagerank(tg),
        lambda: talg.bfs(tg),
        lambda: talg.multi_sssp(tg, [0]),
        lambda: talg.scc(_edge_lists("ring-P3")[1]),
        lambda: rt.get_session(tg),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize(
    "change",
    [{"root": 9}, {"tol": 1e-3}, {"strategy": "dpu"}, {"max_iters": 5}, {"execution": "packed"},
     {"activity": "off"}],
    ids=lambda c: next(iter(c)),
)
def test_plan_with_kwargs_and_compatible_with_match_reference(change):
    import dataclasses

    plans = []
    for mod, prog in ((jc, jc.BFS()), (rt, rt.BFS())):
        base = mod.ExecutionPlan(prog, max_iters=50, program_kwargs={"root": 3})
        if "root" in change:
            other = base.with_kwargs(**change)
            assert other.kwargs_dict() == {"root": 9} and base.kwargs_dict() == {"root": 3}
            assert other.program_kwargs == (("root", 9),)
        else:
            other = dataclasses.replace(base, **change)
        plans.append((base.compatible_with(other), other.compatible_with(base), base.compatible_with(base)))
    assert plans[0] == plans[1]
    assert plans[1][0] == ("root" in change)
