"""Kernel B1's range operands built from a range's own leaves (the disk stream's units).

:func:`repro_torch.kernels.packed_sweep.range_from_leaves` reads only the
``src``, ``dst``, ``run_local``, ``run_dst``, ``e_valid`` (and weights) of
tiles ``[lo, hi)`` — what a ``.dsss`` file's mmap gives for that range —
and must equal :func:`~repro_torch.kernels.packed_sweep.tile_ranges` over
the whole layout's run index, array for array, for every cut: generated
small layouts (R-MAT, zipf, ring; P in {1, 4, 8}; weighted or not;
adaptive, subshard and ``src_sorted`` packings), with and without the
``run_tile`` section. The plain range sweep over such ranges gives the
whole-layout sweep's bits.
"""
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.graph.generators import ring, rmat, zipf  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify  # noqa: E402
from repro_torch.kernels import packed_sweep as ps  # noqa: E402

_LAYOUTS: dict = {}


def _layout(kind, P, weighted, packing):
    key = (kind, P, weighted, packing)
    if key not in _LAYOUTS:
        if kind == "rmat":
            src, dst = rmat(10, edge_factor=6, seed=P)
        elif kind == "zipf":
            src, dst = zipf(400, 2000, seed=P)
        else:
            src, dst = ring(120)
        w = None
        if weighted:
            w = np.random.default_rng(P).uniform(0.1, 2.0, len(src)).astype(np.float32)
        el = degree_and_densify(src, dst, w, drop_self_loops=True)
        g = rt.build_dsss(el, P, src_sorted=packing == "src_sorted")
        packed = g.packed_sweep("subshard" if packing != "adaptive" else "adaptive")
        _LAYOUTS[key] = (packed, ps.run_index(packed))
    return _LAYOUTS[key]


def _leaves(packed, lo, hi):
    names = ("src", "dst", "run_local", "run_dst", "e_valid", "weights")
    return {n: getattr(packed, n)[lo:hi] for n in names if getattr(packed, n) is not None}


def _check(packed, index, bounds, run_tile):
    permuted = "perm" in index
    ref = ps.tile_ranges(packed, bounds, index=index, run_tile=run_tile)
    for (lo, hi), (rng, arrays) in zip(bounds, ref):
        got, got_arrays = ps.range_from_leaves(
            _leaves(packed, lo, hi), lo, interval_size=packed.interval_size,
            permuted=permuted, run_tile=run_tile,
        )
        assert got == rng
        assert list(got_arrays) == list(arrays)
        for name, a in arrays.items():
            b = got_arrays[name]
            assert b.dtype == a.dtype and b.shape == a.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)


@settings(max_examples=40, deadline=None)
@given(
    kind=st.sampled_from(["rmat", "zipf", "ring"]),
    P=st.sampled_from([1, 4, 8]),
    weighted=st.booleans(),
    packing=st.sampled_from(["adaptive", "subshard", "src_sorted"]),
    run_tile=st.booleans(),
    data=st.data(),
)
def test_range_from_leaves_equals_tile_ranges(kind, P, weighted, packing, run_tile, data):
    packed, index = _layout(kind, P, weighted, packing)
    nt = packed.num_tiles
    cuts = data.draw(st.sets(st.integers(1, max(nt - 1, 1)), max_size=min(nt - 1, 6)))
    edges = [0, *sorted(c for c in cuts if 0 < c < nt), nt]
    bounds = list(zip(edges[:-1], edges[1:]))
    keep = data.draw(st.lists(st.booleans(), min_size=len(bounds), max_size=len(bounds)))
    bounds = [b for b, k in zip(bounds, keep) if k] or bounds[:1]
    _check(packed, index, bounds, run_tile)


@pytest.mark.parametrize("packing", ["adaptive", "src_sorted"])
def test_every_single_tile_and_the_whole_layout(packing):
    packed, index = _layout("rmat", 4, True, packing)
    nt = packed.num_tiles
    _check(packed, index, [(t, t + 1) for t in range(nt)], False)
    _check(packed, index, [(0, nt)], True)
    assert ("perm" in index) == (packing == "src_sorted")


def test_a_permuted_range_needs_the_flag():
    packed, index = _layout("rmat", 4, False, "src_sorted")
    assert "perm" in index
    with pytest.raises(ValueError, match="not contiguous"):
        ps.range_from_leaves(
            _leaves(packed, 0, packed.num_tiles), 0, interval_size=packed.interval_size,
            permuted=False,
        )


@pytest.mark.parametrize("packing", ["adaptive", "subshard", "src_sorted"])
def test_ranges_from_leaves_fold_to_the_whole_sweep(packing):
    packed, index = _layout("zipf", 4, True, packing)
    prog = rt.PageRank()
    n_pad = packed.n_pad
    P = n_pad // packed.interval_size
    r = np.random.default_rng(0)
    attrs = torch.from_numpy(r.random((1, n_pad)).astype(np.float32))
    aux = {"inv_out_degree": torch.from_numpy(r.random(n_pad).astype(np.float32))}
    row_active = torch.ones(P, dtype=torch.bool)
    ident = torch.zeros((1, n_pad), dtype=torch.float32)
    tiles = ps.prepare_packed_tiles(packed, has_weights=True, device="cpu", index=index)
    want = ps.packed_sweep_update_ref(prog, attrs, ident.clone(), aux, tiles, row_active, True)
    acc = ident.clone()
    sweep = ps.RangeSweep(prog, attrs, aux, row_active, True)
    nt = packed.num_tiles
    for lo in range(0, nt, 3):
        hi = min(lo + 3, nt)
        rng, arrays = ps.range_from_leaves(
            _leaves(packed, lo, hi), lo, interval_size=packed.interval_size,
            permuted="perm" in index,
        )
        buf = np.zeros(rng.nbytes, np.uint8)
        ps.write_range(buf, rng, arrays)
        sweep.update(acc, torch.from_numpy(buf), rng)
    assert torch.equal(acc.view(torch.int32), want.view(torch.int32))
