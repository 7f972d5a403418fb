"""``execution="packed"``: the tile sweep's plain version as its own path.

The port's ``"packed"`` runs the same packed sweep as ``"packed_kernel"``
with :func:`repro_torch.kernels.packed_sweep.packed_sweep_update_ref` in
place of the kernel. It is held:

* bitwise, with field-identical model meters and activity logs, against
  ``"packed_kernel"`` for all six programs, selective activity on;
* against the JAX session's ``execution="packed"`` (its XLA scan): attrs
  bitwise for the monotone programs, PageRank within ``rtol=1e-6,
  atol=1e-9`` (the reference's own tolerance), ``MODEL_METER_FIELDS``,
  ``iterations`` and ``converged`` equal.

``"fused"`` and registered strategies resolve to ``"per_block"`` under
either packed mode, as in the reference; ``"auto"`` stays the kernel.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
from repro.core import vertex_programs as jvp  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.convert import dsss_from_arrays  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.core import vertex_programs as tvp  # noqa: E402
from repro_torch.kernels import packed_sweep as ps  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-9)
_GRAPHS: dict = {}


def _graphs(kind: str, P: int):
    key = (kind, P)
    if key not in _GRAPHS:
        src, dst = j_rmat(9, edge_factor=8, seed=13)
        w = None
        if kind == "weighted":
            w = np.random.default_rng(2).random(src.shape[0]).astype(np.float32) + 0.05
        el = j_densify(src, dst, w, drop_self_loops=True)
        if kind == "symmetrized":
            el = el.symmetrized()
        jg = jc.build_dsss(el, P)
        fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
        fields["edgelist"] = vars(jg.edgelist)
        _GRAPHS[key] = (jg, dsss_from_arrays(fields))
    return _GRAPHS[key]


def _scc_kwargs(n, n_pad):
    """One colour round's inputs: a mask with some dead vertices, labels, colours."""
    r = np.random.default_rng(n)
    mask = np.zeros(n_pad, np.int32)
    mask[:n] = (r.random(n) < 0.85).astype(np.int32)
    labels = np.full(n_pad, -jvp.INF_DEPTH, np.int32)
    labels[:n][mask[:n] > 0] = np.flatnonzero(mask[:n])
    colors = np.full(n_pad, -1, np.int32)
    colors[:n] = r.integers(0, 3, n)
    reach = np.zeros(n_pad, np.int32)
    reach[r.choice(n, 5, replace=False)] = 1
    return (
        {"labels": labels, "mask": mask},
        {"reach": reach, "colors": colors, "mask": mask},
    )


def _workload(name, P):
    """(kind, JAX program, port program, kwargs, max_iters, tol)."""
    jg, _ = _graphs("plain", P)
    fwd, bwd = _scc_kwargs(jg.n, jg.n_pad)
    return {
        "pagerank": ("plain", jc.PageRank(), rt.PageRank(), {}, 12, 0.0),
        "bfs": ("plain", jc.BFS(), rt.BFS(), {"root": 3}, 1000, 1e-10),
        "wcc": ("symmetrized", jc.WCC(), rt.WCC(), {}, 1000, 1e-10),
        "sssp": ("weighted", jc.SSSP(), rt.SSSP(), {"root": 1}, 1000, 1e-10),
        "max_label_forward": ("plain", jvp.MaxLabelForward(), tvp.MaxLabelForward(), fwd, 1000, 1e-10),
        "reach_backward": ("plain", jvp.ReachBackward(), tvp.ReachBackward(), bwd, 1000, 1e-10),
    }[name]


PROGRAMS = ["pagerank", "bfs", "wcc", "sssp", "max_label_forward", "reach_backward"]


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_packed_bitwise_equals_packed_kernel(name, strategy):
    kind, _, prog, kw, iters, tol = _workload(name, 4)
    _, tg = _graphs(kind, 4)
    budget = 2 * tg.n_pad * prog.attr_bytes * 3 // 4  # MPU: 0 < Q < P
    sess = rt.GraphSession(tg, device="cpu", memory_budget=budget, residency="device")
    plan = rt.ExecutionPlan(prog, strategy=strategy, max_iters=iters, tol=tol, program_kwargs=kw)
    assert plan.activity == "auto"
    runs = {}
    for execution in ("packed", "packed_kernel"):
        p = dataclasses.replace(plan, execution=execution)
        assert sess.compile(p).execution == execution
        runs[execution] = sess.run(p)
    a, b = runs["packed"], runs["packed_kernel"]
    np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
    assert a.iterations == b.iterations and a.converged == b.converged
    assert a.meters.model_dict() == b.meters.model_dict()
    assert len(a.activity_log) == len(b.activity_log)
    for x, y in zip(a.activity_log, b.activity_log):
        np.testing.assert_array_equal(x, y)
    if name in ("bfs", "sssp"):
        assert not a.activity_log[0].all()  # the first sweep reads the root's interval only


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", PROGRAMS)
def test_packed_matches_reference_packed(name, P):
    kind, jprog, tprog, kw, iters, tol = _workload(name, P)
    jg, tg = _graphs(kind, P)
    j = jc.GraphSession(jg, residency="device", execution="packed").run(
        jc.ExecutionPlan(jprog, max_iters=iters, tol=tol, program_kwargs=kw)
    )
    t = rt.GraphSession(tg, device="cpu", execution="packed").run(
        rt.ExecutionPlan(tprog, max_iters=iters, tol=tol, program_kwargs=kw)
    )
    if name == "pagerank":
        np.testing.assert_allclose(t.attrs, j.attrs, **TOL)
    else:
        np.testing.assert_array_equal(t.attrs.view(np.int32), np.asarray(j.attrs).view(np.int32))
    assert t.iterations == j.iterations and t.converged == j.converged
    for f in rt.MODEL_METER_FIELDS:
        assert getattr(t.meters, f) == getattr(j.meters, f), f


def test_packed_batch_matches_reference_packed():
    jg, tg = _graphs("plain", 4)
    roots = [0, 3, 9, 40]
    jb = jc.GraphSession(jg, residency="device", execution="packed").run_batch(
        [jc.ExecutionPlan(jc.BFS(), max_iters=jg.n + 1, program_kwargs={"root": r}) for r in roots]
    )
    tb = rt.GraphSession(tg, device="cpu", execution="packed").run_batch(
        [rt.ExecutionPlan(rt.BFS(), max_iters=tg.n + 1, program_kwargs={"root": r}) for r in roots]
    )
    assert tb.fused and jb.fused and tb.iterations == jb.iterations
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.attrs, b.attrs)
    for f in rt.MODEL_METER_FIELDS:
        assert getattr(tb.meters, f) == getattr(jb.meters, f), f


def test_packed_runs_the_plain_version_by_name(monkeypatch):
    """Under "packed" the session calls the plain version, never the kernel's wrapper."""
    _, tg = _graphs("plain", 4)
    called = {"ref": 0}
    real_ref = ps.packed_sweep_update_ref

    def counting_ref(*a, **k):
        called["ref"] += 1
        return real_ref(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran under execution='packed'")

    monkeypatch.setattr(tsession, "packed_sweep_update_ref", counting_ref)
    monkeypatch.setattr(tsession, "packed_sweep_update", no_kernel)
    res = rt.GraphSession(tg, device="cpu", execution="packed").run(
        rt.ExecutionPlan(rt.PageRank(), max_iters=3, tol=0.0)
    )
    assert called["ref"] == res.meters.iterations == 3


@pytest.mark.parametrize("execution", ["packed", "packed_kernel", "auto"])
def test_fused_and_registered_strategies_resolve_to_per_block(execution):
    _, tg = _graphs("plain", 4)
    sess = rt.GraphSession(tg, device="cpu", execution=execution)
    want = "packed_kernel" if execution == "auto" else execution
    # The reference's signature, resolved_execution(strategy, residency,
    # override=None): every execution runs at each residency.
    for residency in ("device", "host", "disk"):
        assert sess.resolved_execution("fused", residency) == "per_block"
        for s in ("spu", "dpu", "mpu"):
            assert sess.resolved_execution(s, residency) == want
            assert sess.resolved_execution(s, residency, "per_block") == "per_block"
    with pytest.raises(ValueError, match="resolved residency"):
        sess.resolved_execution("spu", "auto")
    rt.GraphSession.register_strategy("resolve-probe", tsession._iteration_spu)
    try:
        assert sess.resolved_execution("resolve-probe", "device") == "per_block"
        plan = rt.ExecutionPlan(rt.PageRank(), strategy="resolve-probe", execution=execution)
        assert sess.compile(plan).execution == "per_block"
    finally:
        tsession._STRATEGIES.pop("resolve-probe", None)
    jsess = jc.GraphSession(_graphs("plain", 4)[0], execution=execution)
    assert jsess.resolved_execution("fused", "device") == "per_block"
    # A reference-style call gives the reference's answer wherever the
    # reference does not resolve "auto" by its own backend.
    for override in ("per_block", "packed", "packed_kernel"):
        for s in ("spu", "dpu", "mpu", "fused"):
            for residency in ("device", "host"):
                assert sess.resolved_execution(s, residency, override) == (
                    jsess.resolved_execution(s, residency, override)
                )
