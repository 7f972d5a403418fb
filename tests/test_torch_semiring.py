"""Semiring layer parity: identities and vertex programs, bitwise against JAX.

Each program piece of the port is called on the same numpy-seeded inputs
as the JAX program, which runs eagerly here (op by op, as its unfused
reference), and must give the same bits.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import identities as jid  # noqa: E402
from repro.core import vertex_programs as jvp  # noqa: E402
from repro.core.dsss import build_dsss as j_build_dsss  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

from repro_torch.convert import dsss_from_arrays  # noqa: E402
from repro_torch.core import identities as tid  # noqa: E402
from repro_torch.core import vertex_programs as tvp  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.int32, torch.int32)]


def _same_bits(t, j):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.tobytes() != b.tobytes():
        np.testing.assert_array_equal(a, b)
        raise AssertionError(f"same values, different bits: {a!r} vs {b!r}")


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("jd,td", DTYPES)
def test_identity_families(reduce, jd, td):
    _same_bits(tid.reduce_identity(reduce, td), jid.reduce_identity(reduce, jd))
    _same_bits(tid.padding_identity(reduce, td), jid.padding_identity(reduce, jd))
    _same_bits(tid.segment_fill_value(reduce, td), jid.segment_fill_value(reduce, jd))
    assert tid.padding_identity_value(reduce, td) == jid.padding_identity_value(reduce, jd)
    assert tid.INF_DEPTH == int(jid.INF_DEPTH)


def test_int_max_fill_is_one_below_padding():
    assert tid.segment_fill_value("max", torch.int32).item() == -(2**31)
    assert tid.padding_identity_value("max", torch.int32) == -(2**31) + 1


@pytest.fixture(scope="module")
def graphs():
    src, dst = j_rmat(8, edge_factor=6, seed=11)
    jg = j_build_dsss(j_densify(src, dst, drop_self_loops=True), 4)
    fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
    fields["edgelist"] = vars(jg.edgelist)
    return jg, dsss_from_arrays(fields)


def _kwarg_cases(g):
    rng = np.random.default_rng(0)
    n_pad = g.n_pad
    mask = (rng.random(n_pad) < 0.7).astype(np.int32)
    return {
        "pagerank": [{}, {"personalize": 3}, {"reset_dist": rng.random(g.n)}],
        "bfs": [{}, {"root": 5}],
        "wcc": [{}],
        "sssp": [{"root": 2}],
        "maxlabel": [{}, {"labels": rng.integers(-9, 9, n_pad).astype(np.int32), "mask": mask}],
        "reach": [{
            "reach": rng.integers(0, 2, n_pad).astype(np.int32),
            "mask": mask,
            "colors": rng.integers(0, 4, n_pad).astype(np.int32),
        }],
    }


PROGRAMS = {
    "pagerank": (jvp.PageRank(), tvp.PageRank()),
    "bfs": (jvp.BFS(), tvp.BFS()),
    "wcc": (jvp.WCC(), tvp.WCC()),
    "sssp": (jvp.SSSP(), tvp.SSSP()),
    "maxlabel": (jvp.MaxLabelForward(), tvp.MaxLabelForward()),
    "reach": (jvp.ReachBackward(), tvp.ReachBackward()),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_metadata_and_lifecycle(name, graphs):
    jg, tg = graphs
    jp, tp = PROGRAMS[name]
    for f in ("name", "reduce", "monotone", "attr_bytes", "needs_dst_aux"):
        assert getattr(tp, f) == getattr(jp, f)
    assert tp.accepted_kwargs() == jp.accepted_kwargs()
    for kw in _kwarg_cases(jg)[name]:
        ikw = {k: v for k, v in kw.items() if k in ("root", "personalize", "reset_dist", "labels", "reach")}
        _same_bits(tp.init_attrs(tg, **ikw), jp.init_attrs(jg, **ikw))
        np.testing.assert_array_equal(tp.init_active(tg, **kw), jp.init_active(jg, **kw))
        aux_kw = {k: v for k, v in kw.items() if k not in ("root", "labels", "reach")}
        t_aux, j_aux = tp.make_aux(tg, **aux_kw), jp.make_aux(jg, **aux_kw)
        assert set(t_aux) == set(j_aux)
        for k in j_aux:
            _same_bits(t_aux[k], j_aux[k])


def _values(name, n, rng):
    if name in ("pagerank", "sssp"):
        v = (rng.random(n) * 2).astype(np.float32)
        if name == "sssp":
            v[rng.random(n) < 0.2] = np.inf
        return v
    if name == "reach":
        return rng.integers(0, 2, n).astype(np.int32)
    v = rng.integers(-40, 40, n).astype(np.int32)
    v[rng.random(n) < 0.2] = tid.INF_DEPTH
    return v


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_gather_apply_changed_bitwise(name, weighted, graphs):
    jg, tg = graphs
    jp, tp = PROGRAMS[name]
    rng = np.random.default_rng(abs(len(name) * 7 + weighted))
    kw = _kwarg_cases(jg)[name][-1]
    aux_kw = {k: v for k, v in kw.items() if k not in ("root", "labels", "reach")}
    j_aux = {k: np.asarray(v) for k, v in jp.make_aux(jg, **aux_kw).items()}
    t_aux = {k: torch.from_numpy(v.copy()) for k, v in j_aux.items()}
    E, n_pad = 500, jg.n_pad
    src_ids = rng.integers(0, n_pad, E)
    dst_ids = rng.integers(0, n_pad, E)
    vals = _values(name, E, rng)
    w = (rng.random(E).astype(np.float32) + 0.1) if weighted else None

    def view(aux, ids):
        return {k: (v[ids] if v.ndim == 1 else v) for k, v in aux.items()}

    j_out = jp.gather(
        jnp.asarray(vals), None if w is None else jnp.asarray(w),
        {k: jnp.asarray(v) for k, v in view(j_aux, src_ids).items()},
        {k: jnp.asarray(v) for k, v in view(j_aux, dst_ids).items()},
    )
    t_out = tp.gather(
        torch.from_numpy(vals), None if w is None else torch.from_numpy(w),
        view(t_aux, torch.from_numpy(src_ids)),
        view(t_aux, torch.from_numpy(dst_ids)),
    )
    _same_bits(t_out, j_out)

    old = _values(name, n_pad, rng)
    red = _values(name, n_pad, rng)
    mass = np.float32(rng.random() * 0.1)
    j_new = jp.apply(
        jnp.asarray(old), jnp.asarray(red), {k: jnp.asarray(v) for k, v in j_aux.items()},
        {"dangling_mass": jnp.asarray(mass)},
    )
    t_new = tp.apply(
        torch.from_numpy(old), torch.from_numpy(red), t_aux,
        {"dangling_mass": torch.tensor(mass)},
    )
    _same_bits(t_new, j_new)
    tol = np.float32(1e-3)
    _same_bits(
        tp.changed(torch.from_numpy(old), t_new, torch.tensor(tol)),
        jp.changed(jnp.asarray(old), j_new, jnp.asarray(tol)),
    )


def test_pagerank_pre_iteration_bitwise(graphs):
    """Dangling mass on dyadic inputs, whose sum is exact in any order.

    Neither side pins the order of this float sum, so arbitrary inputs may
    differ in the last bit; on inputs that are multiples of 2^-10 every
    partial sum is exact, and the two must agree bitwise.
    """
    jg, tg = graphs
    rng = np.random.default_rng(1)
    attrs = (rng.integers(0, 1024, jg.n_pad) / 1024).astype(np.float32)
    aux = {k: np.asarray(v) for k, v in jvp.PageRank().make_aux(jg).items()}
    j = jvp.PageRank().pre_iteration(jnp.asarray(attrs), {k: jnp.asarray(v) for k, v in aux.items()})
    t = tvp.PageRank().pre_iteration(
        torch.from_numpy(attrs), {k: torch.from_numpy(v.copy()) for k, v in aux.items()}
    )
    _same_bits(t["dangling_mass"], j["dangling_mass"])
    for name in ("bfs", "wcc", "sssp", "maxlabel", "reach"):
        assert PROGRAMS[name][1].pre_iteration(torch.zeros(4), {}) == {}
