"""Kernel B1's tile ranges (the host-residency stream's units), through the plain version.

Every range cut of a layout, each range staged with
:func:`repro_torch.kernels.packed_sweep.tile_ranges` into its own byte
payload and folded in ascending order by
:class:`~repro_torch.kernels.packed_sweep.RangeSweep` (on the CPU: the
plain range version, which reads only what a range ships), gives the bits
of the whole-layout plain sweep: destination-sorted and ``src_sorted``
layouts, weighted or not, K = 1 and a selective K = 3. And the index's
invariants: fold lists ascend by destination with each destination's runs
in order, chunk rows keep long chunks first, offsets stay in the range.
The same cuts run on the card in ``test_torch_kernel_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.identities import reduce_identity
from repro_torch.graph.generators import erdos_renyi, rmat
from repro_torch.graph.preprocess import degree_and_densify
from repro_torch.kernels import packed_sweep as ps

_GRAPHS: dict = {}


def _graph(kind: str):
    if kind not in _GRAPHS:
        if kind == "er-src-sorted":
            el = degree_and_densify(*erdos_renyi(300, 2400, seed=6), drop_self_loops=True)
            _GRAPHS[kind] = rt.build_dsss(el, 5, src_sorted=True)
        else:
            src, dst = rmat(12 if kind == "rmat12" else 10, edge_factor=8, seed=42)
            w = None
            if kind == "weighted":
                w = np.random.default_rng(9).random(src.shape[0]).astype(np.float32) + 0.05
            _GRAPHS[kind] = rt.build_dsss(degree_and_densify(src, dst, w, drop_self_loops=True), 8)
    return _GRAPHS[kind]


PROGRAMS = {"pagerank": rt.PageRank(), "bfs": rt.BFS(), "sssp": rt.SSSP()}

LAYOUTS = {
    "rmat-adaptive": ("plain", "adaptive"),
    "rmat-subshard-weighted": ("weighted", "subshard"),
    "er-src-sorted": ("er-src-sorted", "subshard"),
    "rmat12-adaptive": ("rmat12", "adaptive"),
}


def _cuts(num_tiles, seed):
    r = np.random.default_rng(seed)
    inner = sorted(r.choice(np.arange(1, num_tiles), min(num_tiles - 1, 3), replace=False).tolist())
    edges = [0, *inner, num_tiles]
    return [[(0, num_tiles)], [(t, t + 1) for t in range(num_tiles)], list(zip(edges[:-1], edges[1:]))]


def _state(prog, g, K, r):
    if prog.dtype == torch.float32:
        attrs = (r.random((K, g.n_pad)) * 2).astype(np.float32)
        if isinstance(prog, rt.SSSP):
            attrs[r.random((K, g.n_pad)) < 0.3] = np.inf
    else:
        attrs = r.integers(-50, 50, (K, g.n_pad)).astype(np.int32)
    acc = torch.full((K, g.n_pad), reduce_identity(prog.reduce, prog.dtype).item(), dtype=prog.dtype)
    aux = prog.make_aux(g)
    return torch.from_numpy(attrs), acc, aux


@pytest.mark.parametrize("program", ["pagerank", "bfs", "sssp"])
@pytest.mark.parametrize("layout", [k for k in LAYOUTS if not k.startswith("rmat12")])
def test_every_range_cut_gives_the_whole_sweep(layout, program):
    kind, packing = LAYOUTS[layout]
    g = _graph(kind)
    prog = PROGRAMS[program]
    packed = g.packed_sweep(packing)
    tiles = ps.prepare_packed_tiles(packed, has_weights=g.weights is not None, device="cpu")
    index = ps.run_index(packed)
    hw = g.weights is not None
    r = np.random.default_rng(5)
    for K, selective in ((1, False), (3, True)):
        attrs, acc, aux = _state(prog, g, K, r)
        row = np.ones(g.P, bool)
        sel = np.ones(packed.num_tiles, bool)
        if selective:
            row = r.random(g.P) < 0.6
            row[0] = True
            sel = r.random(packed.num_tiles) < 0.6
        row_t = torch.from_numpy(row)
        idx = torch.from_numpy(np.flatnonzero(sel).astype(np.int32)) if selective else None
        want = ps.packed_sweep_update_ref(prog, attrs, acc, aux, tiles, row_t, hw, False, idx)
        for cut in _cuts(packed.num_tiles, K):
            sweep = ps.RangeSweep(prog, attrs, aux, row_t, hw)
            got = acc.clone()
            for rng, arrays in ps.tile_ranges(packed, cut, index=index, run_tile=selective):
                buf = np.zeros(rng.nbytes, np.uint8)
                ps.write_range(buf, rng, arrays)
                local = torch.from_numpy(sel[rng.lo:rng.hi]) if selective else None
                sweep.update(got, torch.from_numpy(buf), rng, local)
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_range_index_invariants(layout):
    kind, packing = LAYOUTS[layout]
    g = _graph(kind)
    packed = g.packed_sweep(packing)
    index = ps.run_index(packed)
    T = packed.tile_edges
    cut = _cuts(packed.num_tiles, 1)[2]
    items = ps.tile_ranges(packed, cut, index=index, run_tile=True)
    assert sum(rng.runs for rng, _ in items) == index["run_start"].shape[0]
    assert sum(rng.chunk_rows for rng, _ in items) == index["chunks"].shape[0]
    for rng, a in items:
        assert rng.sections["chunks"][0] == 0  # the int4 rows start the aligned buffer
        assert rng.nbytes == sum(4 * n for _, n in rng.sections.values())
        ptr, dst, runs = a["fold_ptr"], a["fold_dst"], a["fold_runs"]
        assert ptr[0] == 0 and ptr[-1] == rng.runs and np.all(np.diff(ptr) > 0)
        assert np.all(np.diff(dst) > 0)  # touched destinations ascend, each once
        assert sorted(runs.tolist()) == list(range(rng.runs))
        for i in range(rng.touched):  # a destination's runs ascend
            assert np.all(np.diff(runs[ptr[i]:ptr[i + 1]]) > 0)
        rows = a["chunks"].astype(np.int64)
        assert np.all((rows[:, 5] >= 0) & (rows[:, 5] < rng.num_tiles))
        assert np.all((rows[:, 0] >= 0) & (rows[:, 1] <= rng.runs))
        lens = rows[:, 3] - rows[:, 2]
        longs = (rows[:, 1] - rows[:, 0] == 1) & (lens > ps.LONG_RUN)
        assert not np.any(longs[1:] & ~longs[:-1])  # long chunks first
        span = rng.num_tiles * T if "perm" not in a else a["perm"].shape[0]
        assert np.all(a["run_start"] >= 0) and np.all(a["run_start"] < span)
        if "perm" in a:
            assert np.all((a["perm"] >= 0) & (a["perm"] < rng.num_tiles * T))
        assert a["src"].shape == (rng.num_tiles, T)


def test_tile_ranges_refuse_overlaps_and_selections_need_run_tile():
    g = _graph("plain")
    packed = g.packed_sweep("adaptive")
    with pytest.raises(ValueError, match="disjoint"):
        ps.tile_ranges(packed, [(0, 2), (1, 3)])
    ((rng, arrays),) = ps.tile_ranges(packed, [(0, 1)])
    buf = np.zeros(rng.nbytes, np.uint8)
    ps.write_range(buf, rng, arrays)
    prog = rt.BFS()
    attrs, acc, aux = _state(prog, g, 1, np.random.default_rng(0))
    sweep = ps.RangeSweep(prog, attrs, aux, torch.ones(g.P, dtype=torch.bool), False)
    with pytest.raises(ValueError, match="run_tile"):
        sweep.update(acc, torch.from_numpy(buf), rng, torch.ones(1, dtype=torch.uint8))


def test_range_pointers_follow_the_c_signature():
    """The sections RangeSweep passes, in order, are the C entry's pointer parameters."""
    import re
    from pathlib import Path

    text = (Path(ps.__file__).parent / "csrc" / "packed_sweep.cu").read_text()
    match = re.search(r'extern "C" int packed_sweep_range_launch\(([^)]*)\)', text)
    names = [p.split()[-1].lstrip("*") for p in match.group(1).split(",")]
    first = names.index("src")
    got = names[first:first + len(ps._RANGE_POINTERS)]
    assert [("weights" if n == "w" else n) for n in got] == list(ps._RANGE_POINTERS)
    g = _graph("er-src-sorted")
    ((rng, _),) = ps.tile_ranges(g.packed_sweep("subshard"), [(0, 2)], run_tile=True)
    for name, off in zip(ps._RANGE_POINTERS, rng.offsets):
        assert off == (rng.sections[name][0] if name in rng.sections else None)
