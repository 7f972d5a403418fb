"""The CUDA kernels against their plain versions, and the per-block path, on the card.

The tile sweep (B1), on destination-sorted and src_sorted layouts, and the
sub-shard ToHub update (B2), per sub-shard and as a whole pass, must equal
their plain PyTorch versions bit for bit, launch after launch. Flash attention
(B3) sums in another order than its plain version (a materialized
softmax), so it is held within the JAX tests' own bounds for the Pallas
kernel, ``rtol = atol = 2e-5`` in float32 and ``3e-2`` in bfloat16, and a
repeated launch must give the same bits; the LM serving path with
``attn_impl="pallas"`` must launch it once per layer. The per-block
path's ordered reductions must give the CPU's bits; and per-block
SPU/DPU/MPU sessions must equal packed_kernel sessions bitwise on the card.
``execution="packed"`` (the tile sweep's plain version, by name) must give
B1's bits and meters without launching it, and the §IV drivers on the card
the CPU's results, with one B1 launch per sweep. Under a transient H2D
fault plan host and disk sessions heal to the clean run's bits, meters
and B1 launches; crash → resume and a served batch give the uninterrupted
and solo bits; two threads that first touch B1 together build it once.

Needs a CUDA device (``-m cuda``); skips without one, since the kernels
have no CPU mode. Imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import aux_from_numpy
from repro_torch.core import identities as tid
from repro_torch.core import session as session_mod
from repro_torch.core import vertex_programs as vp
from repro_torch.core.dsss import build_dsss
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import GraphSession
from repro_torch.graph.generators import rmat, zipf
from repro_torch.graph.preprocess import degree_and_densify
from repro_torch.kernels import dsss_spmv as dk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import packed_sweep as ps
from repro_torch.launch import b1_cases as bc

pytestmark = pytest.mark.cuda

PROGRAMS = [
    vp.PageRank(), vp.BFS(), vp.WCC(), vp.SSSP(), vp.MaxLabelForward(), vp.ReachBackward(),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile-sweep kernel has no CPU mode")
    return torch.device("cuda")


def _graph(kind, P, weighted, src_sorted=False):
    src, dst = rmat(10, edge_factor=8, seed=3) if kind == "rmat" else zipf(3000, 20000, seed=4)
    w = np.random.default_rng(5).random(src.shape[0]).astype(np.float32) + 0.01
    return build_dsss(
        degree_and_densify(src, dst, w if weighted else None, drop_self_loops=True), P,
        src_sorted=src_sorted,
    )


def _inputs(prog, g, K, stacked, rng, dev):
    n_pad = g.n_pad
    if prog.dtype == torch.float32:
        attrs = (rng.random((K, n_pad)) * 2).astype(np.float32)
        if isinstance(prog, vp.SSSP):
            attrs[rng.random((K, n_pad)) < 0.3] = np.inf
    elif isinstance(prog, vp.ReachBackward):
        attrs = rng.integers(0, 2, (K, n_pad)).astype(np.int32)
    else:
        attrs = rng.integers(-50, 50, (K, n_pad)).astype(np.int32)
        attrs[rng.random((K, n_pad)) < 0.2] = tid.INF_DEPTH
    acc = torch.full((K, n_pad), tid.reduce_identity(prog.reduce, prog.dtype).item(), dtype=prog.dtype)

    def aux_of(q):
        if isinstance(prog, vp.PageRank):
            return prog.make_aux(g, personalize=q if stacked else None)
        if isinstance(prog, vp.MaxLabelForward):
            return prog.make_aux(g, mask=(rng.random(n_pad) < 0.8).astype(np.int32))
        if isinstance(prog, vp.ReachBackward):
            return prog.make_aux(
                g, mask=(rng.random(n_pad) < 0.8).astype(np.int32),
                colors=rng.integers(0, 3, n_pad).astype(np.int32),
            )
        return prog.make_aux(g)

    if stacked:
        per_q = [aux_of(q) for q in range(K)]
        aux = {k: torch.stack([a[k] for a in per_q]) for k in per_q[0]}
    else:
        aux = aux_of(0)
    return (
        torch.from_numpy(attrs).to(dev), acc.to(dev), {k: v.to(dev) for k, v in aux.items()}
    )


@pytest.mark.parametrize("kind,P,weighted,packing", [
    ("rmat", 4, False, "adaptive"),
    ("zipf", 8, True, "adaptive"),
    ("rmat", 3, True, "subshard"),
])
@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.name)
def test_kernel_bitwise_equals_plain(prog, kind, P, weighted, packing, dev):
    g = _graph(kind, P, weighted)
    packed = g.packed_sweep(packing)
    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device=dev)
    rng = np.random.default_rng(P)
    for K, stacked, partial in ((1, False, False), (4, True, True)):
        attrs, acc, aux = _inputs(prog, g, K, stacked, rng, dev)
        row = np.ones(P, bool)
        idx = None
        if partial:
            row = rng.random(P) < 0.5
            row[0] = True
            idx = torch.from_numpy(
                np.flatnonzero(rng.random(packed.num_tiles) < 0.6).astype(np.int32)
            ).to(dev)
        args = (prog, attrs, acc, aux, tiles, torch.from_numpy(row).to(dev), weighted, stacked, idx)
        before = ps.launches
        got = ps.packed_sweep_update(*args)
        again = ps.packed_sweep_update(*args)
        want = ps.packed_sweep_update_ref(*args)
        torch.cuda.synchronize()
        assert ps.launches == before + 2
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_session_on_card_matches_cpu(dev):
    g = _graph("rmat", 8, False)
    plans = [ExecutionPlan(vp.BFS(), max_iters=g.n + 1, program_kwargs={"root": r}) for r in (0, 7)]
    on_card = GraphSession(g).run_batch(plans)
    on_cpu = GraphSession(g, device="cpu").run_batch(plans)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a.attrs, b.attrs)
    assert on_card.meters.model_dict() == on_cpu.meters.model_dict()
    pr = ExecutionPlan(vp.PageRank(), max_iters=20, tol=0.0)
    np.testing.assert_allclose(
        GraphSession(g).run(pr).attrs, GraphSession(g, device="cpu").run(pr).attrs,
        rtol=1e-5, atol=1e-8,
    )


# ---------------------------------------------------------------------------
# B1 on src_sorted layouts: runs reached through the edge permutation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.name)
def test_kernel_bitwise_equals_plain_src_sorted(prog, weighted, dev):
    g = _graph("rmat", 4, weighted, src_sorted=True)
    packed = g.packed_sweep("subshard")
    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device=dev)
    assert "perm" in tiles
    rng = np.random.default_rng(11)
    for K, stacked, partial in ((1, False, False), (8, True, True)):
        attrs, acc, aux = _inputs(prog, g, K, stacked, rng, dev)
        row = np.ones(g.P, bool)
        idx = None
        if partial:
            row = rng.random(g.P) < 0.5
            row[0] = True
            idx = torch.from_numpy(
                np.flatnonzero(rng.random(packed.num_tiles) < 0.6).astype(np.int32)
            ).to(dev)
        args = (prog, attrs, acc, aux, tiles, torch.from_numpy(row).to(dev), weighted, stacked, idx)
        before = ps.launches
        got = ps.packed_sweep_update(*args)
        again = ps.packed_sweep_update(*args)
        want = ps.packed_sweep_update_ref(*args)
        torch.cuda.synchronize()
        assert ps.launches == before + 2
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("execution", ["auto", "packed_kernel"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
def test_src_sorted_session_runs_the_kernel(strategy, execution, dev):
    """A src_sorted graph's default session runs B1: BFS/SSSP give the CPU's bits,
    PageRank the plain version's bits on the card, one launch per sweep."""
    g = _graph("rmat", 4, True, src_sorted=True)
    budget = 2 * g.interval_size * 4 * (g.P // 2)
    card = GraphSession(g, memory_budget=budget, residency="device", execution=execution)
    cpu = GraphSession(g, device="cpu", memory_budget=budget, residency="device")
    plans = [ExecutionPlan(vp.BFS(), strategy=strategy, max_iters=g.n + 1, program_kwargs={"root": r})
             for r in (0, 7)]
    sssp = ExecutionPlan(vp.SSSP(), strategy=strategy, max_iters=g.n + 1, program_kwargs={"root": 1})
    before = ps.launches
    on_card = card.run_batch(plans)
    assert ps.launches - before == on_card.iterations
    for a, b in zip(on_card, cpu.run_batch(plans)):
        np.testing.assert_array_equal(a.attrs, b.attrs)
    np.testing.assert_array_equal(card.run(sssp).attrs.view(np.int32), cpu.run(sssp).attrs.view(np.int32))
    pr = ExecutionPlan(vp.PageRank(), strategy=strategy, max_iters=12, tol=0.0)
    before = ps.launches
    got = card.run(pr)
    assert ps.launches - before == 12
    session_mod.packed_sweep_update = ps.packed_sweep_update_ref
    try:
        plain = card.run(pr)
    finally:
        session_mod.packed_sweep_update = ps.packed_sweep_update
    np.testing.assert_array_equal(got.attrs.view(np.int32), plain.attrs.view(np.int32))
    assert got.meters.model_dict() == cpu.run(pr).meters.model_dict()


# ---------------------------------------------------------------------------
# B1 on hand-made layouts that reach every branch, and the K = 8 BFS batch
# ---------------------------------------------------------------------------
BY_NAME = dict(zip(bc.PROGRAMS, PROGRAMS))


@pytest.mark.parametrize("program", bc.PROGRAMS)
@pytest.mark.parametrize("case", list(bc.CASES))
def test_kernel_hand_made_layouts_bitwise(case, program, dev):
    """Long runs across windows, run ends at chunk and window edges, −0.0/NaN
    contribs, inactive intervals with wild weights, a selection without the
    longest run's tile, K = 8 stacked, a src_sorted build: bitwise equal to
    the plain version and to a repeat."""
    c = bc.case(case, program)
    tiles = ps.prepare_packed_tiles(c["packed"], has_weights=c["weighted"], device=dev)
    idx = None if c["idx"] is None else torch.from_numpy(c["idx"]).to(dev)
    args = (
        BY_NAME[program], torch.from_numpy(c["attrs"]).to(dev), torch.from_numpy(c["acc"]).to(dev),
        aux_from_numpy(c["aux"], dev), tiles, torch.from_numpy(c["row"]).to(dev), c["weighted"],
        c["stacked"], idx,
    )
    before = ps.launches
    got = ps.packed_sweep_update(*args)
    again = ps.packed_sweep_update(*args)
    want = ps.packed_sweep_update_ref(*args)
    torch.cuda.synchronize()
    assert ps.launches == before + 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("packing", ["adaptive", "subshard"])
def test_kernel_bfs_k8_bitwise(packing, dev):
    """The fused BFS batch's shape (K = 8, no aux): full sweep and a partial
    one, bitwise equal to the plain version and to a repeat; the batch of 8
    roots through a session gives the CPU's bits."""
    g = _graph("rmat", 4, False)
    packed = g.packed_sweep(packing)
    tiles = ps.prepare_packed_tiles(packed, has_weights=False, device=dev)
    rng = np.random.default_rng(8)
    bfs = vp.BFS()
    for partial in (False, True):
        attrs, acc, _ = _inputs(bfs, g, 8, True, rng, dev)
        row = np.ones(g.P, bool)
        idx = None
        if partial:
            row[1] = False
            idx = torch.from_numpy(np.flatnonzero(rng.random(packed.num_tiles) < 0.6).astype(np.int32)).to(dev)
        args = (bfs, attrs, acc, {}, tiles, torch.from_numpy(row).to(dev), False, True, idx)
        got = ps.packed_sweep_update(*args)
        again = ps.packed_sweep_update(*args)
        want = ps.packed_sweep_update_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, again)
    plans = [ExecutionPlan(bfs, max_iters=g.n + 1, program_kwargs={"root": r}) for r in range(8)]
    card = GraphSession(g, packing=packing).run_batch(plans)
    for a, b in zip(card, GraphSession(g, device="cpu", packing=packing).run_batch(plans)):
        np.testing.assert_array_equal(a.attrs, b.attrs)


# ---------------------------------------------------------------------------
# B2, the sub-shard ToHub update
# ---------------------------------------------------------------------------
B2_SHAPES = [(64, 100, 32), (300, 2000, 150), (128, 513, 128), (1000, 4096, 999), (16, 8, 4)]
SEMIRINGS = [("mul", "sum"), ("add", "min"), ("add", "max")]
B2_DTYPES = [torch.float32, torch.bfloat16]


def _b2_case(isize, e, nslots, gather_op, reduce, dtype, dev, sorted_slots=True):
    rng = np.random.default_rng(e + isize)
    src_local = rng.integers(0, isize, e).astype(np.int32)
    hub_inv = rng.integers(0, nslots, e).astype(np.int32)
    if sorted_slots:
        hub_inv = np.sort(hub_inv)
    w = rng.random(e).astype(np.float32) + 0.1
    vals = torch.from_numpy(rng.random(isize).astype(np.float32) + 0.5).to(dtype).to(dev)
    ops = kops.prepare_subshard_operands(
        src_local, hub_inv, w, dtype, gather_op=gather_op, reduce=reduce, device=dev
    )
    return vals, ops


def _b2_bitwise(vals, ops, num_slots, gather_op, reduce):
    """Kernel == plain version bitwise, for the partials and the hub, twice."""
    kw = dict(gather_op=gather_op, reduce=reduce)
    before = dk.launches
    parts = dk.dsss_spmv_block_partials(vals, *ops, **kw)
    hub = dk.subshard_update(vals, *ops, num_slots, **kw)
    hub_again = dk.subshard_update(vals, *ops, num_slots, **kw)
    want_parts = dk.dsss_spmv_block_partials_ref(vals, *ops, **kw)
    want_hub = dk.subshard_update_ref(vals, *ops, num_slots, **kw)
    torch.cuda.synchronize()
    assert dk.launches == before + 3
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)  # noqa: E731
    assert torch.equal(bits(parts), bits(want_parts))
    assert torch.equal(bits(hub), bits(want_hub))
    assert torch.equal(bits(hub), bits(hub_again))


@pytest.mark.parametrize("dtype", B2_DTYPES, ids=str)
@pytest.mark.parametrize("isize,e,nslots", B2_SHAPES)
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_dsss_spmv_bitwise_equals_plain(isize, e, nslots, gather_op, reduce, dtype, dev):
    vals, ops = _b2_case(isize, e, nslots, gather_op, reduce, dtype, dev)
    _b2_bitwise(vals, ops, nslots, gather_op, reduce)


@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_dsss_spmv_unsorted_slots_bitwise_equals_plain(gather_op, reduce, dev):
    vals, ops = _b2_case(300, 2000, 150, gather_op, reduce, torch.float32, dev, sorted_slots=False)
    _b2_bitwise(vals, ops, 150, gather_op, reduce)


@pytest.mark.parametrize("dtype", B2_DTYPES, ids=str)
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_dsss_spmv_real_subshards(gather_op, reduce, dtype, dev):
    """Every sub-shard of an R-MAT scale-14 graph, through kernel_operands."""
    src, dst = rmat(14, edge_factor=16, seed=1)
    w = np.random.default_rng(2).random(src.shape[0]).astype(np.float32) + 0.01
    g = build_dsss(degree_and_densify(src, dst, w, drop_self_loops=True), 4)
    sess = GraphSession(g, device=dev)
    rng = np.random.default_rng(3)
    for i, j in sorted(sess.block_keys):
        vals = torch.from_numpy(rng.random(g.interval_size).astype(np.float32)).to(dtype).to(dev)
        ops = sess.kernel_operands(i, j, dtype, gather_op=gather_op, reduce=reduce)
        _b2_bitwise(vals, ops, sess.host_blocks[(i, j)]["u"], gather_op, reduce)


def _b2_pass_bitwise(vals, sp, dev):
    """The pass == plain pass == one subshard_update per sub-shard, bitwise, twice."""
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)  # noqa: E731
    before = dk.launches
    hubs, offsets = dk.subshard_update_pass(vals, sp)
    again, _ = dk.subshard_update_pass(vals, sp)
    want, want_offsets = dk.subshard_update_pass_ref(vals, sp)
    torch.cuda.synchronize()
    assert dk.launches == before + 2
    assert offsets.tolist() == want_offsets.tolist()
    assert torch.equal(bits(hubs), bits(want))
    assert torch.equal(bits(hubs), bits(again))
    fb = sp.first_block
    for k, (src_off, isize, num_slots, _) in enumerate(sp.meta.tolist()):
        e = slice(int(fb[k]) * dk.E_BLK, int(fb[k + 1]) * dk.E_BLK)
        one = dk.subshard_update(
            vals[src_off:src_off + isize], sp.src_idx[e], sp.hub_inv[e], sp.weights[e],
            sp.block_base[int(fb[k]):int(fb[k + 1])], num_slots,
            gather_op=sp.gather_op, reduce=sp.reduce,
        )
        assert torch.equal(bits(one), bits(hubs[offsets[k]:offsets[k + 1]]))
    return hubs


@pytest.mark.parametrize("dtype", B2_DTYPES, ids=str)
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_dsss_spmv_pass_bitwise_equals_plain(gather_op, reduce, dtype, dev):
    """The JAX tests' shapes, slots out of order, and a hand-made sub-shard in one pass.

    The hand-made one has a run across three blocks, slots no edge reaches,
    a jump past the window and slots past its last edge; two sources lie
    outside the first interval (NaN contribs), and under a sum zero weights
    meet negative and -0.0 values (-0.0 contribs).
    """
    ops, isizes, slots = [], [], []
    for (isize, e, nslots), srt in [(shape, True) for shape in B2_SHAPES] + [((300, 2000, 150), False)]:
        rng = np.random.default_rng(e + isize)
        src_local = rng.integers(0, isize, e).astype(np.int32)
        hub_inv = rng.integers(0, nslots, e).astype(np.int32)
        if srt:
            hub_inv = np.sort(hub_inv)
        w = rng.random(e).astype(np.float32) + 0.1
        ops.append(kops.prepare_subshard_operands(
            src_local, hub_inv, w, dtype, gather_op=gather_op, reduce=reduce, device=dev))
        isizes.append(isize)
        slots.append(nslots)
    rng = np.random.default_rng(7)
    hub_inv = np.concatenate([
        np.full(1400, 3), np.arange(4, 300), np.full(700, 900), np.arange(1000, 1604)
    ]).astype(np.int32)
    w = rng.random(3000).astype(np.float32) + 0.1
    if reduce == "sum":
        w[::3] = 0.0
    ops.append(kops.prepare_subshard_operands(
        rng.integers(0, 50, 3000).astype(np.int32), hub_inv, w, dtype,
        gather_op=gather_op, reduce=reduce, device=dev))
    isizes.append(50)
    slots.append(1800)
    src_idx = ops[0][0].clone()
    src_idx[[5, 40]] = torch.tensor([70, -2], dtype=torch.int32, device=dev)
    ops[0] = (src_idx, *ops[0][1:])
    vals = rng.random(sum(isizes)).astype(np.float32) + 0.5
    vals[::7] *= -1
    vals[::11] = -0.0
    sp = kops.prepare_subshard_pass(
        ops, np.cumsum([0] + isizes[:-1]).tolist(), isizes, slots,
        gather_op=gather_op, reduce=reduce,
    )
    assert sp.flags[0].tolist() == [0] * len(B2_SHAPES) + [1, 0]
    hubs = _b2_pass_bitwise(torch.from_numpy(vals).to(dtype).to(dev), sp, dev)
    assert bool(torch.isnan(hubs).any()) == (reduce == "sum")


@pytest.mark.parametrize("dtype", B2_DTYPES, ids=str)
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_dsss_spmv_pass_real_subshards(gather_op, reduce, dtype, dev):
    """Every sub-shard of R-MAT scale 14 (P = 4) in one pass, and of its src_sorted build."""
    src, dst = rmat(14, edge_factor=16, seed=1)
    w = np.random.default_rng(2).random(src.shape[0]).astype(np.float32) + 0.01
    el = degree_and_densify(src, dst, w, drop_self_loops=True)
    for src_sorted in (False, True):
        g = build_dsss(el, 4, src_sorted=src_sorted)
        sess = GraphSession(g, device=dev)
        keys = sorted(sess.block_keys)
        sp = kops.prepare_subshard_pass(
            [sess.kernel_operands(i, j, dtype, gather_op=gather_op, reduce=reduce) for i, j in keys],
            [i * g.interval_size for i, _ in keys], [g.interval_size] * len(keys),
            [sess.host_blocks[key]["u"] for key in keys], gather_op=gather_op, reduce=reduce,
        )
        assert bool(sp.flags[0].all()) == src_sorted
        vals = torch.from_numpy(np.random.default_rng(3).random(g.n_pad).astype(np.float32))
        _b2_pass_bitwise(vals.to(dtype).to(dev), sp, dev)


# ---------------------------------------------------------------------------
# The per-block path
# ---------------------------------------------------------------------------
def test_per_block_reductions_give_the_cpu_bits(dev):
    """segment_reduce over (e, K) folds in order on the card: the CPU's bits."""
    g = _graph("rmat", 4, True)
    prog = vp.PageRank()
    rng = np.random.default_rng(7)
    K, isz = 3, g.interval_size
    prev = (rng.random((K, isz)) + 0.1).astype(np.float32)
    # Zero rank on dangling vertices: the fused apply's dangling-mass sum,
    # whose order is pinned on neither device, is then exactly 0.
    flat = np.tile(prev, (1, g.P))
    flat[:, g.out_degree == 0] = 0.0
    outs = {}
    for where in ("cpu", dev):
        sess = GraphSession(g, device=where)
        aux = {k: v.to(sess.device) for k, v in prog.make_aux(g).items()}
        got = []
        for key in sorted(sess.block_keys):
            i, j = key
            acc = torch.zeros((K, isz), device=sess.device)
            for _ in range(2):  # a second block folds onto a non-zero acc
                acc = session_mod._block_gather_reduce(
                    prog, torch.from_numpy(prev).to(sess.device), sess._interval_aux(aux, i),
                    {}, sess.blocks[key], acc, True,
                )
            got.append(acc.cpu())
        fused = session_mod._fused_iteration(
            prog, torch.from_numpy(flat).to(sess.device), aux,
            sess.fused_arrays(), (torch.arange(g.n_pad, device=sess.device) < g.n).reshape(g.P, isz),
            torch.tensor(0.0, device=sess.device), True,
        )[0]
        outs[str(where)] = (torch.stack(got), fused.cpu())
    cpu, card = outs["cpu"], outs[str(dev)]
    assert torch.equal(cpu[0].view(torch.int32), card[0].view(torch.int32))
    assert torch.equal(cpu[1].view(torch.int32), card[1].view(torch.int32))


@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
def test_per_block_sessions_bitwise_equal_packed_kernel_on_card(strategy, dev):
    g = _graph("rmat", 8, False)
    pr = vp.PageRank()
    budget = 2 * g.interval_size * pr.attr_bytes * (g.P // 2)
    runs = {}
    for execution in ("per_block", "packed_kernel"):
        sess = GraphSession(
            g, device=dev, memory_budget=budget, residency="device", execution=execution
        )
        res = sess.run(ExecutionPlan(pr, strategy=strategy, max_iters=15, tol=0.0))
        bfs = sess.run_batch([
            ExecutionPlan(vp.BFS(), strategy=strategy, max_iters=g.n + 1, program_kwargs={"root": r})
            for r in (0, 5, 9)
        ])
        runs[execution] = (res, bfs)
    (bp, bb), (pp, pb) = runs["per_block"], runs["packed_kernel"]
    np.testing.assert_array_equal(bp.attrs.view(np.int32), pp.attrs.view(np.int32))
    assert bp.meters.model_dict() == pp.meters.model_dict()
    for a, b in zip(bb, pb):
        np.testing.assert_array_equal(a.attrs, b.attrs)
    assert bb.meters.model_dict() == pb.meters.model_dict()


# ---------------------------------------------------------------------------
# execution="packed" (the plain tile sweep by name) and the drivers on the card
# ---------------------------------------------------------------------------
def _rmat_el(scale, seed):
    return degree_and_densify(*rmat(scale, edge_factor=8, seed=seed), drop_self_loops=True)


@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.name)
def test_packed_scan_bitwise_equals_packed_kernel_on_card(prog, dev):
    """The plain version under "packed" gives B1's bits and meters, and launches no B1."""
    el = _rmat_el(14, 6)
    if isinstance(prog, vp.WCC):
        el = el.symmetrized()
    w = np.random.default_rng(7).random(el.m).astype(np.float32) + 0.05
    if isinstance(prog, vp.SSSP):
        el = degree_and_densify(el.src, el.dst, w)
    g = build_dsss(el, 8)
    n, n_pad = g.n, g.n_pad
    r = np.random.default_rng(3)
    mask = np.zeros(n_pad, np.int32)
    mask[:n] = (r.random(n) < 0.9).astype(np.int32)
    colors = np.full(n_pad, -1, np.int32)
    colors[:n] = r.integers(0, 3, n)
    labels = np.full(n_pad, -tid.INF_DEPTH, np.int32)
    labels[:n][mask[:n] > 0] = np.flatnonzero(mask[:n])
    reach = np.zeros(n_pad, np.int32)
    reach[r.choice(n, 20, replace=False)] = 1
    kw, iters, tol = {
        "pagerank": ({}, 6, 0.0),
        "bfs": ({"root": 1}, n + 1, 1e-10),
        "wcc": ({}, n + 1, 1e-10),
        "sssp": ({"root": 1}, n + 1, 1e-10),
        "scc_fwd": ({"labels": labels, "mask": mask}, n + 1, 1e-10),
        "scc_bwd": ({"reach": reach, "colors": colors, "mask": mask}, n + 1, 1e-10),
    }[prog.name]
    budget = 2 * g.interval_size * prog.attr_bytes * (g.P // 2)
    sess = GraphSession(g, device=dev, memory_budget=budget, residency="device")
    runs, launches = {}, {}
    for execution in ("packed", "packed_kernel"):
        plan = ExecutionPlan(prog, strategy="mpu", max_iters=iters, tol=tol,
                             execution=execution, program_kwargs=kw)
        before = ps.launches
        runs[execution] = sess.run(plan)
        torch.cuda.synchronize()
        launches[execution] = ps.launches - before
    a, b = runs["packed"], runs["packed_kernel"]
    assert launches == {"packed": 0, "packed_kernel": b.meters.iterations}
    np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
    assert a.iterations == b.iterations and a.meters.model_dict() == b.meters.model_dict()


def test_drivers_on_card_match_cpu(dev):
    from repro_torch.core import algorithms as alg
    from repro_torch.core.baselines import TurboGraphLikeEngine

    el = _rmat_el(12, 2)
    g = build_dsss(el, 8)
    roots = [0, 5, 9]
    card, cpu = {}, {}
    for where, out in ((dev, card), ("cpu", cpu)):
        before = ps.launches
        out["pagerank"] = alg.pagerank(g, iters=10, device=where)
        out["bfs"] = alg.bfs(g, 5, device=where)
        out["multi_bfs"] = alg.multi_bfs(g, roots, device=where)
        out["sssp"] = alg.sssp(g, 5, device=where)
        out["multi_sssp"] = alg.multi_sssp(g, roots, device=where)
        out["tg"] = TurboGraphLikeEngine(g, vp.PageRank(), device=where).run(10, tol=0.0)
        sweeps = sum(out[k].iterations for k in ("pagerank", "bfs", "multi_bfs", "sssp", "multi_sssp"))
        out["launches"] = (ps.launches - before, sweeps)
        out["wcc"] = alg.wcc(el, device=where)
        out["scc"] = alg.scc(el, device=where)
    launched, sweeps = card["launches"]
    assert launched == sweeps  # one B1 launch per sweep; TurboGraph-like runs per-block
    assert cpu["launches"][0] == 0
    np.testing.assert_allclose(card["pagerank"].attrs, cpu["pagerank"].attrs, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(card["tg"].attrs.view(np.int32), card["pagerank"].attrs.view(np.int32))
    for k in ("bfs", "sssp", "wcc"):
        np.testing.assert_array_equal(card[k].attrs.view(np.int32), cpu[k].attrs.view(np.int32))
        assert card[k].meters.model_dict() == cpu[k].meters.model_dict()
    for k in ("multi_bfs", "multi_sssp"):
        assert card[k].fused and card[k].iterations == cpu[k].iterations
        for a, b in zip(card[k], cpu[k]):
            np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
    np.testing.assert_array_equal(card["scc"], cpu["scc"])
    assert card["pagerank"].meters.model_dict() == cpu["pagerank"].meters.model_dict()
    # A second call on the same graph object gets the same staged session.
    sess = alg._session(g, 8, None, "auto", "auto", dev)
    assert alg._session(g, 8, None, "auto", "auto", dev) is sess


# ---------------------------------------------------------------------------
# B1 over tile ranges (host residency) and host-residency sessions
# ---------------------------------------------------------------------------
def _cuts(num_tiles, seed):
    """Range cuts that cover a layout: whole, one tile each, and a random partition."""
    r = np.random.default_rng(seed)
    inner = np.sort(r.choice(np.arange(1, num_tiles), min(num_tiles - 1, 4), replace=False)) if num_tiles > 1 else []
    edges = [0, *[int(x) for x in inner], num_tiles]
    return [
        [(0, num_tiles)],
        [(t, t + 1) for t in range(num_tiles)],
        list(zip(edges[:-1], edges[1:])),
    ]


def _leaves_on(packed, lo, hi, dev):
    leaves = {k: getattr(packed, k)[lo:hi] for k in ps.TILE_LEAVES}
    if packed.weights is not None:
        leaves["weights"] = packed.weights[lo:hi]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in leaves.items()}


@pytest.mark.parametrize("layout", ["rmat-adaptive", "zipf-weighted-subshard", "rmat-src-sorted"])
@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.name)
def test_kernel_range_launches_bitwise_equal_whole_layout(prog, layout, dev):
    """Every range cut, folded range by range, gives the whole-layout launch's bits
    and the plain version's over each range's leaves (carrying acc), three times."""
    kind, weighted, src_sorted = {
        "rmat-adaptive": ("rmat", False, False),
        "zipf-weighted-subshard": ("zipf", True, False),
        "rmat-src-sorted": ("rmat", True, True),
    }[layout]
    g = _graph(kind, 4, weighted, src_sorted=src_sorted)
    packed = g.packed_sweep("subshard" if layout != "rmat-adaptive" else "adaptive")
    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device=dev)
    index = ps.run_index(packed)
    rng = np.random.default_rng(21)
    for K, stacked, selective in ((1, False, False), (8, True, False), (8, True, True)):
        attrs, acc, aux = _inputs(prog, g, K, stacked, rng, dev)
        row = np.ones(g.P, bool)
        sel = np.ones(packed.num_tiles, bool)
        if selective:
            row = rng.random(g.P) < 0.5
            row[0] = True
            sel = rng.random(packed.num_tiles) < 0.6
        row_t = torch.from_numpy(row).to(dev)
        idx = torch.from_numpy(np.flatnonzero(sel).astype(np.int32)).to(dev) if selective else None
        want = ps.packed_sweep_update(prog, attrs, acc, aux, tiles, row_t, weighted, stacked, idx)
        for cut in _cuts(packed.num_tiles, K):
            items = ps.tile_ranges(packed, cut, index=index, run_tile=True)
            bufs = []
            for r_, arrays in items:
                host = np.zeros(r_.nbytes, np.uint8)
                ps.write_range(host, r_, arrays)
                bufs.append(torch.from_numpy(host).to(dev))
            plain = acc.clone()
            for (r_, _), (lo, hi) in zip(items, cut):
                local = np.flatnonzero(sel[lo:hi]).astype(np.int32)
                plain = ps.packed_sweep_update_ref(
                    prog, attrs, plain, aux, _leaves_on(packed, lo, hi, dev), row_t, weighted,
                    stacked, torch.from_numpy(local).to(dev) if selective else None,
                )
            for _ in range(3):
                before, pre_before = ps.launches, ps.pre_gathers
                sweep = ps.RangeSweep(prog, attrs, aux, row_t, weighted, stacked,
                                      max(r_.runs for r_, _ in items))
                got = acc.clone()
                for (r_, _), buf, (lo, hi) in zip(items, bufs, cut):
                    local = torch.from_numpy(sel[lo:hi].astype(np.uint8)).to(dev) if selective else None
                    sweep.update(got, buf, r_, local)
                torch.cuda.synchronize()
                assert ps.launches - before == len(cut) and ps.pre_gathers - pre_before == 1
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (K, cut)
                assert torch.equal(got.view(torch.int32), plain.view(torch.int32)), (K, cut)


@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
def test_host_residency_on_card_bitwise_equals_device(strategy, execution, dev):
    """Host sessions on the card stream and give device residency's bits and
    model meters, repeated three times; B1 runs once per slab and chunk."""
    g = _graph("rmat", 8, True)
    pr = vp.PageRank()
    budgets = (0, 2 * g.n_pad * pr.attr_bytes + g.m * 12 // 2)
    plans = [ExecutionPlan(pr, strategy=strategy, max_iters=8, tol=0.0)] + [
        ExecutionPlan(vp.SSSP(), strategy=strategy, max_iters=g.n + 1, program_kwargs={"root": r})
        for r in (0, 7)
    ]
    for budget in budgets:
        dev_sess = GraphSession(g, memory_budget=budget, residency="device", execution=execution)
        host = GraphSession(g, memory_budget=budget, residency="host", execution=execution)
        want_pr = dev_sess.run(plans[0])
        want_bfs = dev_sess.run_batch(plans[1:])
        splan = host.packed_stream_plan(strategy, pr.attr_bytes)
        for _ in range(3):
            before = ps.launches
            got = host.run(plans[0])
            torch.cuda.synchronize()
            launched = ps.launches - before
            np.testing.assert_array_equal(got.attrs.view(np.int32), want_pr.attrs.view(np.int32))
            assert got.meters.model_dict() == want_pr.meters.model_dict()
            assert got.meters.bytes_h2d > 0 or splan.pin_tiles == splan.num_tiles
            if execution == "packed_kernel":
                chunks = -(-(splan.num_tiles - splan.pin_tiles) // splan.chunk_tiles)
                assert launched == got.iterations * (chunks + (splan.pin_tiles > 0))
            else:
                assert launched == 0
            batch = host.run_batch(plans[1:])
            for a, b in zip(batch, want_bfs):
                np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
            assert batch.meters.model_dict() == want_bfs.meters.model_dict()


def test_drivers_with_a_budget_stream_on_card(dev):
    from repro_torch.core import algorithms as alg

    el = _rmat_el(12, 2)
    g = build_dsss(el, 8)
    budget = 2 * g.n_pad * 4 + g.m * 8 // 3
    host = alg.pagerank(g, iters=6, memory_budget=budget, device=dev)
    device = alg.pagerank(g, iters=6, memory_budget=budget, residency="device", device=dev)
    assert host.meters.bytes_h2d > 0 and device.meters.bytes_h2d == 0
    np.testing.assert_array_equal(host.attrs.view(np.int32), device.attrs.view(np.int32))
    hb = alg.multi_bfs(g, [0, 5, 9], memory_budget=budget, device=dev)
    db = alg.multi_bfs(g, [0, 5, 9], memory_budget=budget, residency="device", device=dev)
    for a, b in zip(hb, db):
        np.testing.assert_array_equal(a.attrs, b.attrs)


@pytest.mark.parametrize("execution", ["packed_kernel", "packed", "per_block"])
@pytest.mark.parametrize("strategy", ["spu", "dpu", "mpu"])
def test_disk_residency_on_card_bitwise_equals_device(strategy, execution, dev, tmp_path):
    """Disk sessions on the card over a file written here: device residency's
    bits and model meters, three times, with bytes_disk_read and bytes_h2d
    equal to their closed forms (host residency's bytes_h2d under
    packed_kernel) and one B1 launch per slab and chunk."""
    from repro_torch.core import iomodel as tio
    from repro_torch.storage import write_dsss

    g = _graph("rmat", 8, True)
    path = str(tmp_path / "g.dsss")
    write_dsss(g, path)
    pr = vp.PageRank()
    budget = 2 * g.n_pad * pr.attr_bytes + g.m * 12 // 2
    plans = [ExecutionPlan(pr, strategy=strategy, max_iters=8, tol=0.0)] + [
        ExecutionPlan(vp.SSSP(), strategy=strategy, max_iters=g.n + 1, program_kwargs={"root": r})
        for r in (0, 7)
    ]
    dev_sess = GraphSession(g, memory_budget=budget, residency="device", execution=execution)
    host = GraphSession(g, memory_budget=budget, residency="host", execution=execution)
    want_pr, want_h = dev_sess.run(plans[0]), host.run(plans[0])
    want_sssp = dev_sess.run_batch(plans[1:])
    for host_budget in (0, 1 << 18):
        disk = GraphSession.open(
            path, memory_budget=budget, host_memory_budget=host_budget, execution=execution
        )
        assert disk.resolved_residency() == "disk"
        compiled = disk.compile(plans[0])
        splan = disk.packed_stream_plan(compiled.choice.strategy, pr.attr_bytes)
        if execution == "per_block":
            nbytes = {k: session_mod._host_block_nbytes(h) for k, h in disk.host_blocks.items()}
            read = tio.disk_read_bytes(nbytes, compiled.resident, compiled.host_cached)
        else:
            read = tio.packed_disk_bytes(
                splan.num_tiles - splan.pin_tiles - splan.host_tiles, splan.tile_edges,
                weighted=True,
            )
        for _ in range(3):
            before = ps.launches
            got = disk.run(plans[0])
            torch.cuda.synchronize()
            launched = ps.launches - before
            np.testing.assert_array_equal(got.attrs.view(np.int32), want_pr.attrs.view(np.int32))
            assert got.meters.model_dict() == want_pr.meters.model_dict()
            assert got.meters.bytes_disk_read == read * got.iterations
            assert got.meters.bytes_h2d == want_h.meters.bytes_h2d
            if execution == "packed_kernel":
                chunks = -(-(splan.num_tiles - splan.pin_tiles) // splan.chunk_tiles)
                assert launched == got.iterations * (chunks + (splan.pin_tiles > 0))
            else:
                assert launched == 0
            batch = disk.run_batch(plans[1:])
            for a, b in zip(batch, want_sssp):
                np.testing.assert_array_equal(a.attrs.view(np.int32), b.attrs.view(np.int32))
            assert batch.meters.model_dict() == want_sssp.meters.model_dict()


# ---------------------------------------------------------------------------
# Reliability and serving through B1 on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("residency", ["host", "disk"])
@pytest.mark.parametrize("execution", ["packed_kernel", "per_block"])
def test_transient_plan_heals_through_b1_on_card(residency, execution, dev, tmp_path):
    """A transient H2D plan that fires and heals gives the clean run's bits and
    meters on the card, and B1 runs once per slab and chunk as without it; a
    fault that escapes leaves the session's ring and slots sound."""
    from repro_torch.reliability import FaultPlan, TransientFault
    from repro_torch.storage import write_dsss

    g = _graph("rmat", 8, True)
    pr = vp.PageRank()
    path = str(tmp_path / "g.dsss")
    write_dsss(g, path)

    def session(**kw):
        if residency == "disk":
            return GraphSession.open(path, memory_budget=0, host_memory_budget=0,
                                     execution=execution, **kw)
        return GraphSession(g, memory_budget=0, residency="host", execution=execution, **kw)

    plan = ExecutionPlan(pr, strategy="dpu", max_iters=6, tol=0.0)
    clean_sess = session()
    before = ps.launches
    clean = clean_sess.run(plan)
    torch.cuda.synchronize()
    clean_launches = ps.launches - before
    sess = session(fault_plan=FaultPlan.h2d_transient(rate=0.2, times=None, seed=5))
    before = ps.launches
    got = sess.run(plan)
    torch.cuda.synchronize()
    assert ps.launches - before == clean_launches
    assert (clean_launches > 0) == (execution == "packed_kernel")
    assert sess.fault_injector.fired("h2d") > 0
    np.testing.assert_array_equal(got.attrs.view(np.int32), clean.attrs.view(np.int32))
    assert got.meters.model_dict() == clean.meters.model_dict()
    assert got.meters.bytes_h2d == clean.meters.bytes_h2d
    assert got.meters.bytes_disk_read == clean.meters.bytes_disk_read
    # Escape mid-sweep (a later copy fails four times in a row), then run
    # clean on the same session.
    label = "block:1," if execution == "per_block" else "chunk:5"
    sess.inject_faults(FaultPlan.h2d_transient(rate=1.0, times=4, match=label))
    with pytest.raises(TransientFault):
        sess.run(plan)
    sess.inject_faults(None)
    again = sess.run(plan)
    np.testing.assert_array_equal(again.attrs.view(np.int32), clean.attrs.view(np.int32))
    assert again.meters.bytes_h2d == clean.meters.bytes_h2d


@pytest.mark.parametrize("residency", ["device", "host"])
def test_crash_resume_and_serving_on_card(residency, dev, tmp_path):
    """Crash at sweep 5, resume: the uninterrupted bits and meters on the card,
    B1 once per sweep; the graph server's fused BFS batch equals solo runs."""
    from repro_torch.reliability import CheckpointSpec, FaultPlan, InjectedCrash
    from repro_torch.serving import GraphServer, QueryRequest, SessionPool

    g = _graph("rmat", 8, True)
    pr = vp.PageRank()
    kw = dict(residency=residency, memory_budget=0 if residency == "host" else None)
    ck = CheckpointSpec(str(tmp_path / "s"), every=2, keep=2)
    plan = ExecutionPlan(pr, strategy="spu", max_iters=8, tol=0.0, checkpoint=ck)
    ref = GraphSession(g, **kw).run(ExecutionPlan(pr, strategy="spu", max_iters=8, tol=0.0))
    sess = GraphSession(g, fault_plan=FaultPlan.crash_at_sweep(5), **kw)
    with pytest.raises(InjectedCrash):
        sess.run(plan)
    got = sess.run(plan, resume_from=True)
    np.testing.assert_array_equal(got.attrs.view(np.int32), ref.attrs.view(np.int32))
    want = {k: v for k, v in vars(ref.meters).items() if k != "wall_seconds"}
    assert {k: v for k, v in vars(got.meters).items() if k != "wall_seconds"} == want
    pool = SessionPool()
    pool.register("g", g, **kw)
    roots = [0, 3, 7, 11, 20, 33, 40, 51]
    plans = [ExecutionPlan(vp.BFS(), max_iters=g.n + 1, program_kwargs={"root": r}) for r in roots]
    before = ps.launches
    served = GraphServer(pool, max_batch=8, max_wait_ms=2.0).serve([QueryRequest("g", p) for p in plans])
    torch.cuda.synchronize()
    assert ps.launches > before and all(q.fused and q.batch_size == 8 for q in served)
    solo = pool.session("g")
    assert solo.device.type == "cuda"
    for p, q in zip(plans, served):
        np.testing.assert_array_equal(q.result.attrs, solo.run(p).attrs)


def test_two_threads_first_touch_a_kernel(dev, monkeypatch):
    """Two threads that first touch B1 together load one library: the second
    waits on the build lock instead of starting a second nvcc."""
    import threading

    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_loaded", {})
    started = []
    real_start = _build._start

    def counting_start(name):
        job = real_start(name)
        if job is not None:
            started.append(name)
        return job

    monkeypatch.setattr(_build, "_start", counting_start)
    target = _build._target("packed_sweep")
    if target.exists():
        target.unlink()  # force a build, so both threads reach it cold
    libs, errors = [], []
    barrier = threading.Barrier(2)

    def touch():
        try:
            barrier.wait()
            libs.append(_build.load("packed_sweep"))
        except Exception as exc:  # pragma: no cover - failure capture
            errors.append(exc)

    threads = [threading.Thread(target=touch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and started == ["packed_sweep"]
    assert libs[0] is libs[1]
    # The kernel runs from both threads, each on its own current stream.
    g = _graph("rmat", 8, False)
    tiles = ps.prepare_packed_tiles(g.packed_sweep("adaptive"), has_weights=False, device=dev)
    pr = vp.PageRank()
    attrs = pr.init_attrs(g).to(dev)[None, :]
    aux = {k: v.to(dev) for k, v in pr.make_aux(g).items()}
    row = torch.ones(g.P, dtype=torch.bool, device=dev)
    want = ps.packed_sweep_update_ref(pr, attrs, torch.zeros_like(attrs), aux, tiles, row, False)
    outs = []

    def sweep():
        out = ps.packed_sweep_update(pr, attrs, torch.zeros_like(attrs), aux, tiles, row, False)
        torch.cuda.current_stream(dev).synchronize()
        outs.append(out)

    threads = [threading.Thread(target=sweep) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outs) == 2 and all(torch.equal(o, want) for o in outs)


# ---------------------------------------------------------------------------
# B3: flash attention
# ---------------------------------------------------------------------------
B3_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
B3_CASES = [
    # (B, Hq, Hkv, Sq, Sk, D), kwargs
    ((2, 4, 4, 64, 64, 32), dict(causal=True)),
    ((1, 8, 2, 128, 128, 64), dict(causal=True)),
    ((1, 4, 1, 96, 160, 32), dict(causal=True)),
    ((2, 16, 8, 32, 32, 128), dict(causal=True)),
    ((1, 2, 2, 257, 130, 64), dict(causal=True)),
    ((1, 4, 2, 128, 128, 32), dict(causal=True, window=8)),
    ((1, 4, 4, 64, 64, 32), dict(causal=True, softcap=30.0)),
    ((2, 4, 4, 64, 96, 32), dict(causal=False)),
    ((1, 4, 2, 96, 32, 32), dict(causal=True, window=8)),  # rows that see no key
    ((1, 8, 1, 300, 300, 256), dict(causal=True)),  # gemma-2b's head
    ((1, 16, 8, 200, 200, 256), dict(causal=True, window=64, softcap=50.0)),  # gemma2
    ((1, 40, 8, 100, 100, 128), dict(causal=True)),  # qwen2.5-14b
    ((2, 4, 2, 50, 50, 16), dict(causal=True, scale=0.5)),
    ((1, 4, 2, 200, 200, 128), dict(causal=True)),  # Sq not a multiple of the 128-row q block
    ((1, 4, 2, 128, 100, 64), dict(causal=True)),  # Sk not a multiple of the 64-key tile
    ((1, 2, 1, 70, 70, 20), dict(causal=True)),  # D not a multiple of 8: bf16 rows padded
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,kw", B3_CASES, ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_flash_attention_matches_plain(shape, kw, dtype, dev):
    b, hq, hkv, sq, sk, d = shape
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype).to(dev)
        for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    )
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    tol = B3_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_takes_strided_inputs(dev):
    """(B, S, H, D) tensors transposed to (B, H, S, D), as attn_apply passes them."""
    rng = np.random.default_rng(3)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev).transpose(1, 2)
        for s in ((2, 70, 8, 64), (2, 70, 2, 64), (2, 70, 2, 64))
    )
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, want)


def _bshd(shapes, dtype, dev, seed):
    """q, k, v made (B, S, H, D) and transposed to (B, H, S, D), as attn_apply passes them."""
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype).to(dev).transpose(1, 2)
        for s in shapes
    ]


@pytest.mark.parametrize("batch,length", [(8, 1024), (4, 2048)])
def test_flash_attention_gemma_2b_buckets_bf16(batch, length, dev):
    """gemma-2b's two serving buckets (Hq 8 on one KV head, D 256, causal) in bf16."""
    q, k, v = _bshd([(batch, length, h, 256) for h in (8, 1, 1)], torch.bfloat16, dev, length)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = B3_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_bf16_repeat_and_strided_bitwise(dev):
    """The tensor-core body: a repeat launch and contiguous copies give the same bits."""
    q, k, v = _bshd([(2, 300, h, 256) for h in (8, 1, 1)], torch.bfloat16, dev, 11)
    kw = dict(causal=True, window=200, softcap=50.0)
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    packed = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, packed)


def test_lm_prefill_launches_flash_attention_per_layer(dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    for arch in ("gemma-2b", "gemma2-9b"):
        base = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        outs = {}
        for impl in ("pallas", "ref"):
            cfg = dataclasses.replace(base, attn_impl=impl)
            model = Model(cfg, device=dev)
            params = model.init(0)
            toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 40))).to(dev)
            before = fa.launches
            outs[impl] = model.prefill(params, toks, 50)[0]
            assert fa.launches - before == (cfg.num_layers if impl == "pallas" else 0)
        torch.testing.assert_close(outs["pallas"], outs["ref"], rtol=1e-4, atol=1e-4)
