"""Tile-sweep parity: the port's plain version against the JAX package.

``repro_torch.kernels.packed_sweep.packed_sweep_update_ref`` must equal,
bit for bit, the JAX scan ``repro.core.session._packed_sweep_impl`` (as
the session jits it), the compacted ``_packed_sweep_select_impl`` and
``repro.kernels.ref.packed_sweep_update_ref``, on the same layout and the
same numpy-seeded attributes, accumulators and aux. (The Pallas kernel
itself is not an oracle here: it does not trace on the installed jax.)

The CUDA kernel cannot run on the CPU, so the run index it consumes is
checked here by an element-by-element emulation of its two phases; the
kernel itself is held against the plain version on the card by
tests/test_torch_kernel_cuda.py.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import vertex_programs as jvp  # noqa: E402
from repro.core.dsss import build_dsss as j_build_dsss  # noqa: E402
from repro.core.session import _packed_jits, _packed_select_jits  # noqa: E402
from repro.graph.generators import rmat as j_rmat, zipf as j_zipf  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402
from repro.kernels.ops import prepare_packed_tiles as j_prepare  # noqa: E402
from repro.kernels.ref import packed_sweep_update_ref as j_ref  # noqa: E402

from repro_torch.convert import aux_from_numpy, dsss_from_arrays  # noqa: E402
from repro_torch.core import identities as tid  # noqa: E402
from repro_torch.core import vertex_programs as tvp  # noqa: E402
from repro_torch.kernels import packed_sweep as ps  # noqa: E402

PROGRAMS = {
    "pagerank": (jvp.PageRank(), tvp.PageRank()),
    "bfs": (jvp.BFS(), tvp.BFS()),
    "wcc": (jvp.WCC(), tvp.WCC()),
    "sssp": (jvp.SSSP(), tvp.SSSP()),
    "maxlabel": (jvp.MaxLabelForward(), tvp.MaxLabelForward()),
    "reach": (jvp.ReachBackward(), tvp.ReachBackward()),
}

# (graph, P, weighted, packing, K, aux mode, partial row_active, selection, ref,
#  src_sorted)
CASES = {
    "rmat-k1-full": ("rmat", 4, False, "adaptive", 1, "shared", False, False, True, False),
    "zipf-k3-shared-select": ("zipf", 8, True, "adaptive", 3, "shared", True, True, False, False),
    "rmat-k3-stacked-select": ("rmat", 3, False, "subshard", 3, "stacked", True, True, False, False),
    "zipf-k1-weighted-subshard": ("zipf", 4, True, "subshard", 1, "shared", True, False, True, False),
    "rmat-k1-src-sorted": ("rmat", 4, True, "subshard", 1, "shared", False, False, True, True),
    "zipf-k3-src-sorted-select": ("zipf", 4, False, "subshard", 3, "shared", True, True, False, True),
}

_GRAPHS: dict = {}


def _graph(kind: str, P: int, weighted: bool, src_sorted: bool = False):
    """The JAX package's graph and the port's copy of it (via convert)."""
    key = (kind, P, weighted, src_sorted)
    if key not in _GRAPHS:
        src, dst = (
            j_rmat(9, edge_factor=8, seed=3) if kind == "rmat"
            else j_zipf(1500, 6000, seed=4)
        )
        w = (
            np.random.default_rng(5).random(src.shape[0]).astype(np.float32) + 0.01
            if weighted else None
        )
        jg = j_build_dsss(j_densify(src, dst, w, drop_self_loops=True), P, src_sorted=src_sorted)
        fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
        fields["edgelist"] = vars(jg.edgelist)
        _GRAPHS[key] = (jg, dsss_from_arrays(fields))
    return _GRAPHS[key]


def _state(name, jprog, g, K, aux_mode, rng):
    """Seeded attrs, acc and aux (numpy) for K queries of one program."""
    n_pad = g.n_pad
    if name in ("pagerank", "sssp"):
        attrs = (rng.random((K, n_pad)) * 3).astype(np.float32)
        if name == "sssp":
            attrs[rng.random((K, n_pad)) < 0.3] = np.inf
        acc = (rng.random((K, n_pad)) * (1 if name == "pagerank" else 5)).astype(np.float32)
    elif name == "reach":
        attrs = rng.integers(0, 2, (K, n_pad)).astype(np.int32)
        acc = rng.integers(0, 2, (K, n_pad)).astype(np.int32)
    else:
        attrs = rng.integers(-50, 50, (K, n_pad)).astype(np.int32)
        attrs[rng.random((K, n_pad)) < 0.2] = tid.INF_DEPTH
        acc = rng.integers(-60, 60, (K, n_pad)).astype(np.int32)

    def make(q):
        if name == "pagerank":
            return jvp.PageRank().make_aux(g, personalize=q if aux_mode == "stacked" else None)
        if name == "maxlabel":
            return jprog.make_aux(g, mask=(rng.random(n_pad) < 0.8).astype(np.int32))
        if name == "reach":
            return jprog.make_aux(
                g,
                mask=(rng.random(n_pad) < 0.8).astype(np.int32),
                colors=rng.integers(0, 3, n_pad).astype(np.int32),
            )
        return jprog.make_aux(g)

    if aux_mode == "stacked":
        per_q = [{k: np.asarray(v) for k, v in make(q).items()} for q in range(K)]
        aux = {k: np.stack([a[k] for a in per_q]) for k in per_q[0]}
    else:
        aux = {k: np.asarray(v) for k, v in make(0).items()}
    return attrs, acc, aux


def _inputs(name, case):
    kind, P, weighted, packing, K, aux_mode, partial, select, _, src_sorted = CASES[case]
    jg, tg = _graph(kind, P, weighted, src_sorted)
    jprog, tprog = PROGRAMS[name]
    rng = np.random.default_rng(zlib.crc32(f"{name}/{case}".encode()))
    attrs, acc, aux = _state(name, jprog, jg, K, aux_mode, rng)
    row = np.ones(jg.P, bool)
    if partial:
        row = rng.random(jg.P) < 0.5
        row[rng.integers(jg.P)] = True
    jpacked = jg.packed_sweep(packing)
    tpacked = tg.packed_sweep(packing)
    idx = a_valid = None
    if select:
        nt = jpacked.num_tiles
        local = np.flatnonzero(rng.random(nt) < 0.5)
        bucket = 1 << int(np.ceil(np.log2(max(local.size, 1))))
        idx = np.zeros(bucket, np.int32)
        idx[: local.size] = local
        a_valid = int(local.size)
    return dict(
        jg=jg, tg=tg, jprog=jprog, tprog=tprog, attrs=attrs, acc=acc, aux=aux,
        row=row, jpacked=jpacked, tpacked=tpacked, idx=idx, a_valid=a_valid,
        weighted=weighted, stacked=aux_mode == "stacked",
    )


def _run_port(d, fn=ps.packed_sweep_update_ref, device="cpu"):
    tiles = ps.prepare_packed_tiles(d["tpacked"], has_weights=d["weighted"], device=device)
    idx = None if d["idx"] is None else torch.from_numpy(d["idx"]).to(device)
    return fn(
        d["tprog"],
        torch.from_numpy(d["attrs"]).to(device),
        torch.from_numpy(d["acc"]).to(device),
        aux_from_numpy(d["aux"], device),
        tiles,
        torch.from_numpy(d["row"]).to(device),
        d["weighted"],
        d["stacked"],
        idx,
        d["a_valid"],
    ).cpu().numpy()


def _run_jax(d):
    tiles = j_prepare(d["jpacked"], has_weights=d["weighted"])
    aux = {k: jnp.asarray(v) for k, v in d["aux"].items()}
    args = (d["jprog"], jnp.asarray(d["attrs"]), jnp.asarray(d["acc"]), aux, tiles)
    kw = dict(has_weights=d["weighted"], aux_batched=d["stacked"])
    row = jnp.asarray(d["row"])
    if d["idx"] is None:
        return np.asarray(_packed_jits(False)[0](*args, row, **kw))
    return np.asarray(
        _packed_select_jits(False)(
            *args, jnp.asarray(d["idx"]), jnp.asarray(np.int32(d["a_valid"])), row, **kw
        )
    )


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_plain_matches_jax_scan_bitwise(name, case):
    """Bitwise: the plain version equals the JAX scan (or its selective form)."""
    d = _inputs(name, case)
    got = _run_port(d)
    want = _run_jax(d)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if CASES[case][8]:
        ref = np.asarray(
            j_ref(
                d["jprog"], jnp.asarray(d["attrs"]), jnp.asarray(d["acc"]),
                {k: jnp.asarray(v) for k, v in d["aux"].items()},
                j_prepare(d["jpacked"], has_weights=d["weighted"]),
                jnp.asarray(d["row"]), d["weighted"], d["stacked"],
            )
        )
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _emulate_kernel(d):
    """The CUDA kernel's two phases, element by element, from the run index.

    Mirrors csrc/packed_sweep.cu: phase 1 folds each run over its edge
    span from segment_fill_value, reading edge ``perm[i]`` for span
    position ``i`` where the index has a permutation (``src_sorted``
    layouts) and edge ``i`` where it has none; phase 2 folds each
    destination's runs from the dst_ptr/dst_runs CSR, skipping runs of
    unselected tiles.
    """
    prog, packed = d["tprog"], d["tpacked"]
    ix = ps.run_index(packed)
    perm = ix.get("perm")
    T = packed.tile_edges
    src, dst = packed.src.reshape(-1), packed.dst.reshape(-1)
    w = packed.weights.reshape(-1) if d["weighted"] else None
    K, n_pad = d["acc"].shape
    isz = n_pad // d["row"].shape[0]
    dtype = d["acc"].dtype
    fill = tid.segment_fill_value(prog.reduce, prog.dtype).item()
    ident = tid.reduce_identity(prog.reduce, prog.dtype).item()
    comb = {"sum": lambda a, b: dtype.type(a + b), "min": min, "max": max}[prog.reduce]
    sel = None
    if d["idx"] is not None:
        sel = np.zeros(packed.num_tiles, bool)
        sel[d["idx"][: d["a_valid"]]] = True
    R = ix["run_start"].shape[0]
    out = d["acc"].copy()
    for k in range(K):
        aux = {n: (v[k] if d["stacked"] else v) for n, v in d["aux"].items()}
        attrs = torch.from_numpy(d["attrs"][k])
        partial = np.empty(R, dtype)
        for r in range(R):
            p = dtype.type(fill)
            for i in range(ix["run_start"][r], ix["run_end"][r]):
                e = int(perm[i]) if perm is not None else i
                s = int(src[e])
                if not d["row"][s // isz]:
                    x = dtype.type(ident)
                else:
                    x = prog.gather(
                        attrs[s : s + 1],
                        None if w is None else torch.from_numpy(w[e : e + 1]),
                        {n: torch.from_numpy(np.array(v[s] if v.ndim else v, ndmin=1)) for n, v in aux.items()},
                        {n: torch.from_numpy(np.array(v[dst[e]] if v.ndim else v, ndmin=1)) for n, v in aux.items()},
                    ).numpy()[0]
                p = comb(p, dtype.type(x))
            partial[r] = p
        for dd in range(n_pad):
            v = out[k, dd]
            for q in range(ix["dst_ptr"][dd], ix["dst_ptr"][dd + 1]):
                r = ix["dst_runs"][q]
                if sel is None or sel[ix["run_tile"][r]]:
                    v = comb(v, partial[r])
            out[k, dd] = v
    assert T == packed.src.shape[1]
    return out


@pytest.mark.parametrize(
    "name,case",
    [
        ("pagerank", "zipf-k1-weighted-subshard"),
        ("sssp", "zipf-k3-shared-select"),
        ("reach", "rmat-k3-stacked-select"),
        ("maxlabel", "rmat-k1-full"),
        ("pagerank", "rmat-k1-src-sorted"),
        ("pagerank", "zipf-k3-src-sorted-select"),
        ("sssp", "rmat-k1-src-sorted"),
        ("sssp", "zipf-k3-src-sorted-select"),
        ("bfs", "rmat-k1-src-sorted"),
        ("bfs", "zipf-k3-src-sorted-select"),
    ],
)
def test_run_index_emulation_matches_plain(name, case):
    """The kernel's algorithm over the staged run index equals the plain version."""
    d = _inputs(name, case)
    got = _emulate_kernel(d)
    want = _run_port(d)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind,P,packing", [("rmat", 4, "adaptive"), ("zipf", 8, "subshard")])
def test_run_index_invariants(kind, P, packing):
    """Runs are contiguous edge spans of one destination, CSR in run order."""
    _, tg = _graph(kind, P, False)
    packed = tg.packed_sweep(packing)
    ix = ps.run_index(packed)
    T = packed.tile_edges
    R = int(packed.u.sum())
    assert ix["run_start"].shape == (R,)
    assert np.all(ix["run_end"] > ix["run_start"])
    assert (ix["run_end"] - ix["run_start"]).sum() == packed.m
    dst = packed.dst.reshape(-1)
    for r in range(R):
        span = slice(ix["run_start"][r], ix["run_end"][r])
        assert np.all(dst[span] == ix["run_target"][r])
        assert ix["run_start"][r] // T == ix["run_tile"][r]
    assert np.all(np.diff(ix["dst_ptr"]) >= 0) and ix["dst_ptr"][-1] == R
    for dd in range(packed.n_pad):
        runs = ix["dst_runs"][ix["dst_ptr"][dd] : ix["dst_ptr"][dd + 1]]
        assert np.all(np.diff(runs) > 0)
        assert np.all(ix["run_target"][runs] == dd)
    lens = ix["run_end"] - ix["run_start"]
    np.testing.assert_array_equal(ix["long_runs"], np.flatnonzero(lens > ps.LONG_RUN))


@pytest.mark.parametrize("kind,P,weighted", [("rmat", 4, True), ("zipf", 4, False)])
def test_src_sorted_run_index_permutes_runs(kind, P, weighted):
    """A src_sorted layout's run index exists and its permuted runs are edge-ordered spans.

    Its runs are not contiguous in the tiles, so the index carries ``perm``:
    each run's edges are one span of ``perm``, ascending within the run,
    all of the run's tile and destination, and every valid edge once.
    Destination-sorted layouts of the same graph get no permutation.
    """
    _, tg = _graph(kind, P, weighted, src_sorted=True)
    packed = tg.packed_sweep("subshard")
    ix = ps.run_index(packed)
    perm = ix["perm"]
    T = packed.tile_edges
    R = int(packed.u.sum())
    assert ix["run_start"].shape == (R,)
    np.testing.assert_array_equal(ix["run_start"][1:], ix["run_end"][:-1])
    assert ix["run_start"][0] == 0 and ix["run_end"][-1] == packed.m == perm.shape[0]
    valid = np.flatnonzero(np.arange(T)[None, :] < packed.e_valid[:, None])
    np.testing.assert_array_equal(np.sort(perm), valid)
    dst = packed.dst.reshape(-1)
    slot = packed.run_local.reshape(-1)
    contiguous = 0
    for r in range(R):
        edges = perm[ix["run_start"][r] : ix["run_end"][r]]
        assert np.all(np.diff(edges) > 0)
        assert np.all(edges // T == ix["run_tile"][r])
        assert np.all(dst[edges] == ix["run_target"][r])
        assert np.all(slot[edges] == slot[edges[0]])
        contiguous += int(edges[-1] - edges[0] + 1 == edges.size)
    assert contiguous < R  # some runs really are scattered in their tile
    np.testing.assert_array_equal(
        ix["long_runs"], np.flatnonzero(ix["run_end"] - ix["run_start"] > ps.LONG_RUN)
    )
    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device="cpu")
    np.testing.assert_array_equal(tiles["perm"].numpy(), perm)
    _, dst_sorted = _graph(kind, P, weighted)
    for packing in ("adaptive", "subshard"):
        assert "perm" not in ps.run_index(dst_sorted.packed_sweep(packing))
