"""Layout, plan and I/O-model parity: array for array against the JAX package."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import dsss as jd  # noqa: E402
from repro.core import iomodel as jio  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import vertex_programs as jvp  # noqa: E402
from repro.graph import generators as jgen  # noqa: E402
from repro.graph import preprocess as jpre  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import dsss as td  # noqa: E402
from repro_torch.core import iomodel as tio  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import vertex_programs as tvp  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph import preprocess as tpre  # noqa: E402


def _eq(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _fields_equal(t, j, skip=()):
    for f in dataclasses.fields(j):
        if f.name in skip:
            continue
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray) or b is None:
            _eq(a, b)
        else:
            assert a == b, f.name


GEN_CASES = [
    ("rmat", dict(scale=9, edge_factor=8, seed=3)),
    ("rmat", dict(scale=8, edge_factor=4, a=0.45, b=0.15, c=0.15, seed=7)),
    ("zipf", dict(n=1500, m=6000, seed=4)),
    ("erdos_renyi", dict(n=700, m=3000, seed=2)),
    ("ring", dict(n=50)),
    ("star", dict(n=40)),
]


@pytest.mark.parametrize("name,kw", GEN_CASES)
def test_generators_equal(name, kw):
    for a, b in zip(getattr(tgen, name)(**kw), getattr(jgen, name)(**kw)):
        _eq(a, b)


def _edges(weighted):
    src, dst = jgen.rmat(9, edge_factor=8, seed=3)
    w = np.random.default_rng(5).random(src.shape[0]).astype(np.float32) if weighted else None
    return src, dst, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("drop", [False, True])
def test_degree_and_densify_and_symmetrized(weighted, drop):
    src, dst, w = _edges(weighted)
    t = tpre.degree_and_densify(src, dst, w, drop_self_loops=drop)
    j = jpre.degree_and_densify(src, dst, w, drop_self_loops=drop)
    _fields_equal(t, j)
    _fields_equal(t.symmetrized(), j.symmetrized())


def _graph_pair(P, weighted=False, src_sorted=False, kind="rmat"):
    if kind == "rmat":
        src, dst, w = _edges(weighted)
    else:
        src, dst = jgen.zipf(1500, 6000, seed=4)
        w = np.random.default_rng(6).random(src.shape[0]).astype(np.float32) if weighted else None
    jel = jpre.degree_and_densify(src, dst, w, drop_self_loops=True)
    tel = tpre.degree_and_densify(src, dst, w, drop_self_loops=True)
    return (
        td.build_dsss(tel, P, src_sorted=src_sorted),
        jd.build_dsss(jel, P, src_sorted=src_sorted),
    )


@pytest.mark.parametrize(
    "P,weighted,src_sorted,kind",
    [(3, False, False, "rmat"), (4, True, False, "zipf"), (8, False, True, "rmat")],
)
def test_build_dsss_every_field(P, weighted, src_sorted, kind):
    t, j = _graph_pair(P, weighted, src_sorted, kind)
    _fields_equal(t, j, skip=("edgelist",))
    _fields_equal(t.edgelist, j.edgelist)
    assert t.n_pad == j.n_pad
    assert t.mean_hub_in_degree() == j.mean_hub_in_degree()
    _eq(t.global_hub_slots(), j.global_hub_slots())
    _eq(t.density_matrix(), j.density_matrix())


@pytest.mark.parametrize(
    "P,weighted,kind,mode",
    [
        (3, False, "rmat", "adaptive"),
        (8, True, "zipf", "adaptive"),
        (4, False, "rmat", "subshard"),
        (4, True, "zipf", "subshard"),
    ],
)
def test_packed_sweep_every_leaf(P, weighted, kind, mode):
    t, j = _graph_pair(P, weighted, kind=kind)
    tp, jp = t.packed_sweep(mode), j.packed_sweep(mode)
    _fields_equal(tp, jp)
    assert tp.padding_ratio == jp.padding_ratio
    tf, tl = td.tile_source_spans(tp, t.interval_size)
    jf, jl = jd.tile_source_spans(jp, j.interval_size)
    _eq(tf, jf)
    _eq(tl, jl)
    rng = np.random.default_rng(P)
    for _ in range(5):
        row = rng.random(P) < 0.4
        _eq(td.active_tile_mask(row, tf, tl), jd.active_tile_mask(row, jf, jl))


def test_src_sorted_subshard_packing():
    t, j = _graph_pair(4, src_sorted=True)
    _fields_equal(t.packed_sweep("subshard"), j.packed_sweep("subshard"))
    with pytest.raises(ValueError):
        t.packed_sweep("adaptive")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_choice_helpers(seed):
    rng = np.random.default_rng(seed)
    runs = rng.zipf(1.7, size=400).clip(1, 3000).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(runs)])
    assert td.choose_tile_edges(runs) == jd.choose_tile_edges(runs)
    assert td.tile_candidates(int(runs.sum()), int(runs.max())) == jd.tile_candidates(
        int(runs.sum()), int(runs.max())
    )
    for T in (128, 1024, 4096):
        assert td.cut_runs_into_tiles(bounds, max(T, int(runs.max()))) == (
            jd.cut_runs_into_tiles(bounds, max(T, int(runs.max())))
        )
    for e in (0, 1, 8, 9, 1000, 4097):
        assert td.next_bucket(e) == jd.next_bucket(e)


@pytest.mark.parametrize("Ba", [4, 8])
def test_iomodel_closed_forms_and_choice(Ba):
    t, j = _graph_pair(8)
    kw = dict(n=t.n, m=t.m, Ba=Ba, Bv=4, Be=8, d=t.mean_hub_in_degree(), P=t.P)
    tp, jp = tio.IOParams(**kw), jio.IOParams(**kw)
    n_pad = t.n_pad
    for B in (None, 0, 1000, n_pad * Ba, 2 * n_pad * Ba - 1, 2 * n_pad * Ba, 10**9):
        assert dataclasses.asdict(tio.select_strategy(tp, B)) == dataclasses.asdict(
            jio.select_strategy(jp, B)
        )
        for s in ("spu", "dpu", "mpu"):
            assert tio.modelled_io(tp, B, s) == jio.modelled_io(jp, B, s)
        if B is not None:
            assert tio.mpu_q(tp, B) == jio.mpu_q(jp, B)
            assert tio.spu_io(tp, B) == jio.spu_io(jp, B)
            assert tio.mpu_io(tp, B) == jio.mpu_io(jp, B)
    assert tio.dpu_io(tp) == jio.dpu_io(jp)


def test_plan_validation_and_batch_key():
    mask = np.arange(8, dtype=np.int32)
    t = tplan.ExecutionPlan(tvp.MaxLabelForward(), strategy="dpu", program_kwargs={"mask": mask})
    j = jplan.ExecutionPlan(jvp.MaxLabelForward(), strategy="dpu", program_kwargs={"mask": mask})
    assert hash(t) == hash(tplan.ExecutionPlan(
        tvp.MaxLabelForward(), strategy="dpu", program_kwargs={"mask": mask.copy()}
    ))
    np.testing.assert_array_equal(t.kwargs_dict()["mask"], j.kwargs_dict()["mask"])
    assert len(t.batch_key()) == len(j.batch_key())  # the checkpoint axis included
    other = tplan.ExecutionPlan(
        tvp.MaxLabelForward(), strategy="dpu", program_kwargs={"mask": mask[::-1].copy()}
    )
    assert other.batch_key() == t.batch_key() and other != t
    for bad, err in [
        (dict(program_kwargs={"rooot": 1}), TypeError),
        (dict(residency="nowhere"), ValueError),
        (dict(execution="fast"), ValueError),
        (dict(activity="sometimes"), ValueError),
    ]:
        with pytest.raises(err):
            tplan.ExecutionPlan(tvp.BFS(), **bad)
        with pytest.raises(err):
            jplan.ExecutionPlan(jvp.BFS(), **bad)
    # trace is ported (observational, outside batch_key); so is checkpoint
    # (ROADMAP A10, second part), which both packages type-check.
    assert t.trace is None and t.checkpoint is None
    with pytest.raises(TypeError, match="CheckpointSpec"):
        tplan.ExecutionPlan(tvp.BFS(), checkpoint=object())
    with pytest.raises(TypeError, match="CheckpointSpec"):
        jplan.ExecutionPlan(jvp.BFS(), checkpoint=object())


@pytest.mark.parametrize("weighted", [False, True])
def test_convert_round_trips_the_reference_graph(weighted):
    _, j = _graph_pair(4, weighted)
    fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    fields["edgelist"] = vars(j.edgelist)
    t = convert.dsss_from_arrays(fields)
    _fields_equal(t, j, skip=("edgelist",))
    _fields_equal(t.edgelist, j.edgelist)
    _fields_equal(t.packed_sweep(), j.packed_sweep())
    a = np.arange(6, dtype=np.float32)
    assert convert.attrs_from_numpy(a, device="cpu").numpy().tobytes() == a.tobytes()
    aux = convert.aux_from_numpy({"x": a, "s": np.float32(2.5)}, device="cpu")
    assert aux["s"].ndim == 0 and aux["x"].dtype.is_floating_point
