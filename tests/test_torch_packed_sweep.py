"""Tile-sweep parity: the port's plain version against the JAX package.

``repro_torch.kernels.packed_sweep.packed_sweep_update_ref`` must equal,
bit for bit, the JAX scan ``repro.core.session._packed_sweep_impl`` (as
the session jits it), the compacted ``_packed_sweep_select_impl`` and
``repro.kernels.ref.packed_sweep_update_ref``, on the same layout and the
same numpy-seeded attributes, accumulators and aux. (The Pallas kernel
itself is not an oracle here: it does not trace on the installed jax.)

The CUDA kernel cannot run on the CPU, so the run index and chunk table
it consumes are checked here by a lane-by-lane emulation of its three
launches (per-vertex pre-gather, chunked run folds, per-destination fold),
on the JAX package's layouts and on the hand-made layouts of
``repro_torch.launch.b1_cases`` that reach every branch; the kernel itself
is held against the plain version on the card by
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
from repro_torch.launch import b1_cases as bc  # noqa: E402

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


KCAP = ps.LONG_RUN  # positions of a window and at most of a short chunk (kCap)


def _pre(name, v, s, aux):
    """The per-vertex part of the gather (pre_gather's Op::pre)."""
    if name == "pagerank":
        return np.float32(v) * np.float32(aux["inv_out_degree"][s])
    if name == "bfs":
        return tid.INF_DEPTH if v >= tid.INF_DEPTH else v + 1
    if name == "maxlabel":
        return v if aux["mask"][s] > 0 else -tid.INF_DEPTH
    if name == "reach":
        return 1 if (aux["mask"][s] > 0 and v > 0) else 0
    return v  # wcc, sssp


def _edge(name, y, w, s, d, aux):
    """The per-edge rest of the gather (Op::edge)."""
    if name == "pagerank":
        return y if w is None else np.float32(y) * np.float32(w)
    if name == "sssp":
        return np.float32(y) + np.float32(1.0 if w is None else w)
    if name == "reach":
        return 1 if (y != 0 and aux["color"][s] == aux["color"][d]) else 0
    return y


def _combine(reduce, dtype):
    """The kernel's combine: a NaN operand wins, ties keep the accumulator."""
    if reduce == "sum":
        return lambda acc, x: dtype.type(dtype.type(acc) + dtype.type(x))
    better = (lambda x, acc: x < acc) if reduce == "min" else (lambda x, acc: x > acc)
    if dtype.kind == "f":
        return lambda acc, x: x if (np.isnan(x) or better(x, acc)) else acc
    return lambda acc, x: x if better(x, acc) else acc


def _emulate_kernel(name, packed, attrs, acc, aux, row, idx, weighted, stacked):
    """csrc/packed_sweep.cu lane by lane, from the staged run index.

    pre_gather writes y[s, k] for the sources of active intervals (the rest
    holds a poison value the emulation refuses to read). run_partials takes
    the chunks in table order: an unselected chunk does nothing, an inactive
    one writes fill (+) ident for its runs; a long chunk (one run of more
    than LONG_RUN edges) is staged window by window, kCap positions each,
    lane kk folding query k0 + kk and carrying its value across windows; a
    short chunk (at most kCap positions) is staged whole, its run starts
    are its head list, and the (run, query) folds go round robin over the
    lanes. Queries go in groups of KG (1 for K = 1, else 4). fold_runs folds each destination's
    selected runs in CSR order. Returns the new acc and how many times each
    (run, query) partial was written.
    """
    with np.errstate(all="ignore"):  # inf - inf and NaN operands are part of the cases
        return _emulate(name, packed, attrs, acc, aux, row, idx, weighted, stacked)


def _emulate(name, packed, attrs, acc, aux, row, idx, weighted, stacked):
    prog = PROGRAMS[name][1]
    ix = ps.run_index(packed)
    perm = ix.get("perm")
    src, dst = packed.src.reshape(-1), packed.dst.reshape(-1)
    wts = packed.weights.reshape(-1) if weighted else None
    K, n_pad = acc.shape
    isz = n_pad // row.shape[0]
    assert isz == packed.interval_size
    dtype = acc.dtype
    fill = dtype.type(tid.segment_fill_value(prog.reduce, prog.dtype).item())
    ident = dtype.type(tid.reduce_identity(prog.reduce, prog.dtype).item())
    comb = _combine(prog.reduce, dtype)
    sel = None
    if idx is not None:
        sel = np.zeros(packed.num_tiles, bool)
        sel[idx] = True
    auxk = [{n: (v[k] if stacked else v) for n, v in aux.items()} for k in range(K)]

    poison = object()
    y = np.full((n_pad, K), poison, dtype=object)
    for s in range(n_pad):
        if row[s // isz]:
            for k in range(K):
                y[s, k] = _pre(name, attrs[k, s], s, auxk[k])

    def contrib(pos, k):
        e = int(perm[pos]) if perm is not None else pos
        s = int(src[e])
        assert y[s, k] is not poison, "read y of an inactive source"
        return dtype.type(_edge(name, y[s, k], None if wts is None else wts[e], s, int(dst[e]), auxk[k]))

    R = ix["run_start"].shape[0]
    partial = np.zeros((R, K), dtype)
    written = np.zeros((R, K), np.int64)
    KG = 1 if K == 1 else 4
    for run0, run1, pos0, pos1, iv, tile, _, _ in ix["chunks"].tolist():
        if sel is not None and not sel[tile]:
            continue
        if not row[iv]:
            partial[run0:run1] = comb(fill, ident)
            written[run0:run1] += 1
            continue
        if run1 - run0 == 1 and pos1 - pos0 > ps.LONG_RUN:  # a long chunk
            for k0 in range(0, K, KG):
                kn = min(KG, K - k0)
                carry = [fill] * kn
                for w0 in range(pos0, pos1, KCAP):
                    n = min(KCAP, pos1 - w0)
                    sval = [[contrib(w0 + p, k0 + kk) for p in range(n)] for kk in range(kn)]
                    for kk in range(kn):  # lane kk
                        for x in sval[kk]:
                            carry[kk] = comb(carry[kk], x)
                partial[run0, k0:k0 + kn] = carry
                written[run0, k0:k0 + kn] += 1
            continue
        n = pos1 - pos0
        H = run1 - run0
        assert n <= KCAP and ix["run_start"][run0] == pos0
        heads = np.append(ix["run_start"][run0:run1] - pos0, n)  # the head list
        for k0 in range(0, K, KG):
            kn = min(KG, K - k0)
            sval = [[contrib(pos0 + p, k0 + kk) for p in range(n)] for kk in range(kn)]
            for lane in range(32):
                for t in range(lane, H * kn, 32):  # (run, query) folds round robin
                    h, kk = divmod(t, kn)
                    a = fill
                    for i in range(heads[h], heads[h + 1]):
                        a = comb(a, sval[kk][i])
                    partial[run0 + h, k0 + kk] = a
                    written[run0 + h, k0 + kk] += 1
    out = acc.copy()
    for k in range(K):
        for dd in range(n_pad):
            v = out[k, dd]
            for q in range(ix["dst_ptr"][dd], ix["dst_ptr"][dd + 1]):
                r = ix["dst_runs"][q]
                if sel is None or sel[ix["run_tile"][r]]:
                    v = comb(v, partial[r, k])
            out[k, dd] = v
    return out, written


def _selected_runs(packed, idx):
    """(R,) bool: the runs of the selected tiles."""
    ix = ps.run_index(packed)
    if idx is None:
        return np.ones(ix["run_start"].shape[0], bool)
    return np.isin(ix["run_tile"], idx)


def _emulate_inputs(name, d):
    idx = None if d["idx"] is None else d["idx"][: d["a_valid"]]
    return _emulate_kernel(
        name, d["tpacked"], d["attrs"], d["acc"], d["aux"], d["row"], idx,
        d["weighted"], d["stacked"],
    ), idx


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
    (got, written), idx = _emulate_inputs(name, d)
    want = _run_port(d)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sel = _selected_runs(d["tpacked"], idx)
    assert np.all(written[sel] == 1) and np.all(written[~sel] == 0)


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
    _check_chunks(ix, packed)


def _check_chunks(ix, packed):
    """The chunk table covers every run once, in run-aligned pieces of one
    tile and one source interval: long chunks (one run of more than
    LONG_RUN edges) first, longest first, then short chunks of at most
    LONG_RUN positions in run order, each as full as the greedy walk makes
    it (the next run would not fit, or a tile, interval or long run ends
    the stretch)."""
    ch = ix["chunks"]
    run0, run1, pos0, pos1, iv, tile = (ch[:, i] for i in range(6))
    assert ch.dtype == np.int32 and np.all(ch[:, 6:] == 0)
    R = ix["run_start"].shape[0]
    covered = np.zeros(R, np.int64)
    for a, b in zip(run0, run1):
        covered[a:b] += 1
    assert np.all(covered == 1)
    lens = ix["run_end"] - ix["run_start"]
    np.testing.assert_array_equal(pos0, ix["run_start"][run0])
    np.testing.assert_array_equal(pos1, ix["run_end"][run1 - 1])
    edges = ix.get("perm", None)
    src = packed.src.reshape(-1)
    for c in range(ch.shape[0]):
        runs = np.arange(run0[c], run1[c])
        np.testing.assert_array_equal(ix["run_start"][runs[1:]], ix["run_end"][runs[:-1]])
        assert np.all(ix["run_tile"][runs] == tile[c])
        span = np.arange(pos0[c], pos1[c])
        e = span if edges is None else edges[span]
        assert np.all(src[e] // packed.interval_size == iv[c])
    long = (run1 - run0 == 1) & (pos1 - pos0 > ps.LONG_RUN)
    n_long = int(long.sum())
    assert np.all(long[:n_long]) and n_long == int((lens > ps.LONG_RUN).sum())
    assert np.all(np.diff(pos1[:n_long] - pos0[:n_long]) <= 0)
    short = slice(n_long, None)
    assert np.all(pos1[short] - pos0[short] <= ps.LONG_RUN)
    assert np.all(np.diff(run0[short]) > 0)
    first = ix["run_start"] if edges is None else edges[ix["run_start"]]
    run_iv = src[first] // packed.interval_size
    for c in range(n_long, ch.shape[0]):  # greedy: the next run would not fit
        r = run1[c]
        if r < R and lens[r] <= ps.LONG_RUN and ix["run_tile"][r] == tile[c] and run_iv[r] == iv[c]:
            assert pos1[c] - pos0[c] + lens[r] > ps.LONG_RUN


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
    _check_chunks(ix, packed)
    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device="cpu")
    np.testing.assert_array_equal(tiles["perm"].numpy(), perm)
    _, dst_sorted = _graph(kind, P, weighted)
    for packing in ("adaptive", "subshard"):
        assert "perm" not in ps.run_index(dst_sorted.packed_sweep(packing))


@pytest.mark.parametrize("program", bc.PROGRAMS)
@pytest.mark.parametrize("case", list(bc.CASES))
def test_hand_made_layouts_emulation_matches_plain(case, program):
    """Every branch of the kernel, emulated, equals the plain version bitwise.

    The layouts of ``repro_torch.launch.b1_cases``: a run of 20,000 edges,
    run ends on both sides of the window and chunk edges, −0.0 and NaN
    contribs under the float sum and SSSP's min, inactive intervals whose
    edges carry negative and infinite weights, a selection without the
    longest run's tile, K = 8 with stacked aux, and a src_sorted build.
    Each (run, query) partial of a selected tile is written exactly once.
    """
    c = bc.case(case, program)
    ix = ps.run_index(c["packed"])
    _check_chunks(ix, c["packed"])
    (got, written) = _emulate_kernel(
        program, c["packed"], c["attrs"], c["acc"], c["aux"], c["row"], c["idx"],
        c["weighted"], c["stacked"],
    )
    tiles = ps.prepare_packed_tiles(c["packed"], has_weights=c["weighted"], device="cpu")
    want = ps.packed_sweep_update_ref(
        PROGRAMS[program][1], torch.from_numpy(c["attrs"]), torch.from_numpy(c["acc"]),
        aux_from_numpy(c["aux"], "cpu"), tiles, torch.from_numpy(c["row"]), c["weighted"],
        c["stacked"], None if c["idx"] is None else torch.from_numpy(c["idx"]),
    ).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sel = _selected_runs(c["packed"], c["idx"])
    assert np.all(written[sel] == 1) and np.all(written[~sel] == 0)


def test_run_index_refuses_a_run_across_source_intervals():
    """A run is one hub slot, one (destination, sub-shard): two intervals raise."""
    good = bc.hand_packed([[(3, np.array([0, 5, 9]), np.ones(3))]], 4 * 16, 16)
    assert ps.run_index(good)["chunks"].shape == (1, 8)
    bad = bc.hand_packed([[(3, np.array([0, 5, 17]), np.ones(3))]], 4 * 16, 16)
    with pytest.raises(ValueError, match="more than one source interval"):
        ps.run_index(bad)


@pytest.mark.parametrize("src_sorted", [False, True])
@pytest.mark.parametrize("kind,P", [("rmat", 3), ("rmat", 4), ("zipf", 8)])
def test_jax_layouts_keep_each_run_in_one_source_interval(kind, P, src_sorted):
    """The JAX package's tile layouts never put two source intervals in a run,
    and the port's run index of the same layouts accepts them."""
    jg, tg = _graph(kind, P, False, src_sorted)
    for packing in ("subshard",) if src_sorted else ("adaptive", "subshard"):
        jp = jg.packed_sweep(packing)
        valid = np.arange(jp.tile_edges)[None, :] < jp.e_valid[:, None]
        run_id = (np.arange(jp.num_tiles)[:, None] * jp.tile_edges + jp.run_local)[valid]
        iv = (jp.src // jg.interval_size)[valid]
        lo = np.full(run_id.max() + 1, P, np.int64)
        hi = np.full(run_id.max() + 1, -1, np.int64)
        np.minimum.at(lo, run_id, iv)
        np.maximum.at(hi, run_id, iv)
        seen = hi >= 0
        assert np.all(lo[seen] == hi[seen])
        _check_chunks(ps.run_index(tg.packed_sweep(packing)), tg.packed_sweep(packing))


def test_argtypes_match_the_c_signature():
    """The ctypes binding of packed_sweep_launch matches its parameters in packed_sweep.cu."""
    import ctypes
    import re
    from pathlib import Path

    text = (Path(ps.__file__).parent / "csrc" / "packed_sweep.cu").read_text()
    match = re.search(r'extern "C" int packed_sweep_launch\(([^)]*)\)', text)
    assert match
    params = [" ".join(p.split()) for p in match.group(1).split(",")]
    assert len(params) == len(ps._ARGTYPES)
    scalars = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for param, argtype in zip(params, ps._ARGTYPES):
        want = ctypes.c_void_p if "*" in param else scalars[param.rsplit(" ", 1)[0]]
        assert argtype is want, param


@pytest.mark.parametrize("entry", ["packed_sweep_pre_gather", "packed_sweep_range_launch"])
def test_range_entries_argtypes_match_the_c_signature(entry):
    """The ctypes bindings of the host-residency path's two entries match packed_sweep.cu."""
    import ctypes
    import re
    from pathlib import Path

    text = (Path(ps.__file__).parent / "csrc" / "packed_sweep.cu").read_text()
    match = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert match
    params = [" ".join(p.split()) for p in match.group(1).split(",")]
    argtypes = ps._ENTRIES[entry]
    assert len(params) == len(argtypes)
    scalars = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for param, argtype in zip(params, argtypes):
        want = ctypes.c_void_p if "*" in param else scalars[param.rsplit(" ", 1)[0]]
        assert argtype is want, param
