"""The sub-shard ToHub update (B2) against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX package's
Pallas kernel (interpret mode off the TPU, as its own tests run it), its
oracle ``repro.kernels.ref.subshard_update_ref``, and the port's wrapper,
which runs its plain version on a CPU tensor. Tolerances:

* staged operands: bitwise;
* float32 min/max: bitwise (exact in any order);
* float32 sum: ``rtol=atol=1e-5``, the JAX tests' own bound: the TPU kernel
  sums each block's window as a matmul, in another order;
* bfloat16: ``5e-2``, as the JAX tests hold it.

The pass entry (one launch per phase for every sub-shard of a sweep) is held
to the per-sub-shard calls bitwise. The CUDA kernel cannot run here, so its
algorithm is checked by a lane-by-lane emulation against the plain version,
bitwise; the kernel itself is held against the plain version on the card by
tests/test_torch_kernel_cuda.py.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
from repro.graph.generators import erdos_renyi as j_er  # noqa: E402
from repro.graph.generators import rmat as j_rmat  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402
from repro.kernels import dsss_spmv as jk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import subshard_update_ref  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.convert import dsss_from_arrays  # noqa: E402
from repro_torch.kernels import dsss_spmv as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(64, 100, 32), (300, 2000, 150), (128, 513, 128), (1000, 4096, 999), (16, 8, 4)]
SEMIRINGS = [("mul", "sum"), ("add", "min"), ("add", "max")]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _random_subshard(isize, e, nslots, seed, sorted_slots=True):
    rng = np.random.default_rng(seed)
    src_local = rng.integers(0, isize, e).astype(np.int32)
    hub_inv = rng.integers(0, nslots, e).astype(np.int32)
    if sorted_slots:
        hub_inv = np.sort(hub_inv)
    w = rng.random(e).astype(np.float32) + 0.1
    return src_local, hub_inv, w


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
    assert got.numpy().tobytes() == want.tobytes()


def _close(got: torch.Tensor, want, reduce: str, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    if reduce != "sum" and dtype == "float32":
        np.testing.assert_array_equal(_np(got), want)
        return
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def _both(isize, e, nslots, gather_op, reduce, dtype, sorted_slots=True):
    """Staged operands and src_vals for both packages, from one seed."""
    jdt, tdt = DTYPES[dtype]
    src_local, hub_inv, w = _random_subshard(isize, e, nslots, e + isize, sorted_slots)
    vals = np.random.default_rng(isize).random(isize) + 0.5
    jvals = jnp.asarray(vals, jdt)
    tvals = torch.from_numpy(np.array(jvals.astype(jnp.float32))).to(tdt)
    jin = jops.prepare_subshard_operands(src_local, hub_inv, w, jdt, gather_op=gather_op, reduce=reduce)
    tin = tops.prepare_subshard_operands(
        src_local, hub_inv, w, tdt, gather_op=gather_op, reduce=reduce, device="cpu"
    )
    return (src_local, hub_inv, w), (jvals, jin), (tvals, tin)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("isize,e,nslots", SHAPES)
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_kernel_matches_jax(isize, e, nslots, gather_op, reduce, dtype):
    (src_local, hub_inv, w), (jvals, jin), (tvals, tin) = _both(
        isize, e, nslots, gather_op, reduce, dtype
    )
    for got, want in zip(tin, jin):
        _same_bits(got, want)
    jparts = jk.dsss_spmv_block_partials(jvals, *jin, gather_op=gather_op, reduce=reduce)
    tparts = tk.dsss_spmv_block_partials(tvals, *tin, gather_op=gather_op, reduce=reduce)
    assert tparts.shape == jparts.shape and tparts.dtype == tvals.dtype
    _close(tparts, jparts, reduce, dtype)
    jhub = jops.subshard_update(jvals, *jin, nslots, gather_op=gather_op, reduce=reduce)
    thub = tops.subshard_update(tvals, *tin, nslots, gather_op=gather_op, reduce=reduce)
    assert thub.shape == (nslots,) and thub.dtype == tvals.dtype
    _close(thub, jhub, reduce, dtype)
    want = subshard_update_ref(
        jvals, jnp.asarray(src_local), jnp.asarray(hub_inv), jnp.asarray(w, jvals.dtype),
        nslots, gather_op=gather_op, reduce=reduce,
    )
    _close(thub, want, reduce, dtype)


@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_unsorted_slots_match_jax_window_semantics(gather_op, reduce):
    """Slots out of order: each block still folds the in-window edges of each slot."""
    _, (jvals, jin), (tvals, tin) = _both(300, 2000, 150, gather_op, reduce, "float32", False)
    jparts = jk.dsss_spmv_block_partials(jvals, *jin, gather_op=gather_op, reduce=reduce)
    tparts = tk.dsss_spmv_block_partials(tvals, *tin, gather_op=gather_op, reduce=reduce)
    _close(tparts, jparts, reduce, "float32")
    jhub = jops.subshard_update(jvals, *jin, 150, gather_op=gather_op, reduce=reduce)
    _close(tops.subshard_update(tvals, *tin, 150, gather_op=gather_op, reduce=reduce),
           jhub, reduce, "float32")


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_mul_with_min_or_max_rejected(reduce):
    src_local, hub_inv, w = _random_subshard(8, 8, 4, seed=0)
    with pytest.raises(ValueError, match="requires reduce='sum'"):
        tops.prepare_subshard_operands(
            src_local, hub_inv, w, torch.float32, gather_op="mul", reduce=reduce, device="cpu"
        )


def test_slot_fold_drops_slots_past_num_slots():
    _, (jvals, jin), (tvals, tin) = _both(64, 100, 32, "mul", "sum", "float32")
    for n in (0, 5, 40):
        jhub = jops.subshard_update(jvals, *jin, n, gather_op="mul", reduce="sum")
        thub = tops.subshard_update(tvals, *tin, n, gather_op="mul", reduce="sum")
        assert thub.shape == (n,)
        _close(thub, jhub, "sum", "float32")


def _graph(seed, P, weighted=False, src_sorted=False):
    el = j_densify(*j_er(80, 400, seed=seed), drop_self_loops=True)
    if weighted:
        w = np.random.default_rng(seed).random(el.m).astype(np.float32) + 0.1
        el = j_densify(el.src, el.dst, w, drop_self_loops=True)
    jg = jc.build_dsss(el, P, src_sorted=src_sorted)
    fields = {f: getattr(jg, f) for f in jg.__dataclass_fields__}
    fields["edgelist"] = vars(jg.edgelist)
    return jg, dsss_from_arrays(fields)


def test_prepare_from_packed_tile_matches_jax():
    jg, tg = _graph(11, 3, weighted=True)
    jp, tp = jg.packed_sweep("adaptive"), tg.packed_sweep("adaptive")
    num_slots = int(jg.hub_offsets[-1, -1])
    vals = np.random.default_rng(0).uniform(0.1, 1.0, size=jg.n_pad).astype(np.float32)
    for t in range(jp.num_tiles):
        jin = jops.prepare_from_packed_tile(jp, t, jnp.float32, gather_op="mul", reduce="sum")
        tin = tops.prepare_from_packed_tile(
            tp, t, torch.float32, gather_op="mul", reduce="sum", device="cpu"
        )
        for got, want in zip(tin, jin):
            _same_bits(got, want)
        jhub = jops.subshard_update(jnp.asarray(vals), *jin, num_slots, gather_op="mul", reduce="sum")
        thub = tops.subshard_update(torch.from_numpy(vals), *tin, num_slots, gather_op="mul", reduce="sum")
        _close(thub, jhub, "sum", "float32")
    # src_sorted blocks scramble the slot stream: staging refuses them.
    _, tgs = _graph(11, 3, src_sorted=True)
    ps = tgs.packed_sweep("subshard")
    raised = 0
    for t in range(ps.num_tiles):
        try:
            tops.prepare_from_packed_tile(ps, t, torch.float32, gather_op="mul", reduce="sum", device="cpu")
        except ValueError:
            raised += 1
    assert raised > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_prepare_from_subshard_matches_jax(weighted):
    jg, tg = _graph(5, 4, weighted=weighted)
    for i in range(jg.P):
        for j in range(jg.P):
            jss, tss = jg.subshard(i, j), tg.subshard(i, j)
            jin = jops.prepare_from_subshard(jss, jnp.bfloat16, gather_op="add", reduce="min")
            tin = tops.prepare_from_subshard(
                tss, torch.bfloat16, gather_op="add", reduce="min", device="cpu"
            )
            for got, want in zip(tin, jin):
                _same_bits(got, want)


def test_end_to_end_pagerank_iteration_via_kernel():
    """One PageRank sweep from per-sub-shard kernel calls equals the session's sweep."""
    src, dst = j_rmat(9, edge_factor=8, seed=4)
    el = j_densify(src, dst, drop_self_loops=True)
    jg = jc.build_dsss(el, 4)
    fields = {f: getattr(jg, f) for f in jg.__dataclass_fields__}
    fields["edgelist"] = vars(jg.edgelist)
    g = dsss_from_arrays(fields)
    sess = rt.GraphSession(g, device="cpu")
    ref = sess.run(rt.ExecutionPlan(rt.PageRank(), strategy="spu", max_iters=1, tol=0.0))
    want_jax = jc.GraphSession(jg).run(
        jc.ExecutionPlan(jc.PageRank(), strategy="fused", max_iters=1, tol=0.0)
    )

    isz = g.interval_size
    x = np.zeros(g.n_pad, np.float32)
    x[: g.n] = 1.0 / g.n
    deg = np.asarray(g.out_degree, np.float32)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(np.float32)
    contrib = torch.from_numpy(x * inv)
    dangling = x[(deg == 0) & (np.arange(g.n_pad) < g.n)].sum()
    new = np.zeros(g.n_pad, np.float32)
    before = tk.launches
    for j in range(g.P):
        acc = torch.zeros(isz)
        for i in range(g.P):
            if (i, j) not in sess.block_keys:
                continue
            blk = sess.host_blocks[(i, j)]
            ops = sess.kernel_operands(i, j, torch.float32, gather_op="mul", reduce="sum")
            hub = tops.subshard_update(
                contrib[i * isz:(i + 1) * isz], *ops, blk["u"], gather_op="mul", reduce="sum"
            )
            hub_dst = torch.from_numpy(blk["hub_dst"][: blk["u"]].astype(np.int64))
            acc[hub_dst] = acc[hub_dst] + hub
        new[j * isz:(j + 1) * isz] = 0.15 / g.n + 0.85 * (acc.numpy() + dangling / g.n)
    assert tk.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(new[: g.n], ref.attrs, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(new[: g.n], want_jax.attrs, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The pass entry
# ---------------------------------------------------------------------------
_RMAT10: dict = {}


def _rmat10(P):
    """R-MAT scale 10 in both packages, and the port's CPU session on it."""
    if P not in _RMAT10:
        el = j_densify(*j_rmat(10, edge_factor=8, seed=1), drop_self_loops=True)
        jg = jc.build_dsss(el, P)
        fields = {f: getattr(jg, f) for f in jg.__dataclass_fields__}
        fields["edgelist"] = vars(jg.edgelist)
        g = dsss_from_arrays(fields)
        _RMAT10[P] = (g, rt.GraphSession(g, device="cpu"))
    return _RMAT10[P]


def _session_pass(P, gather_op, reduce, dtype, seed=0):
    """Every sub-shard's operands, their pass staging, and values for every interval."""
    g, sess = _rmat10(P)
    keys = sorted(sess.block_keys)
    ops = [sess.kernel_operands(i, j, dtype, gather_op=gather_op, reduce=reduce) for i, j in keys]
    isz = g.interval_size
    slots = [sess.host_blocks[key]["u"] for key in keys]
    sp = tops.prepare_subshard_pass(
        ops, [i * isz for i, _ in keys], [isz] * len(keys), slots,
        gather_op=gather_op, reduce=reduce,
    )
    vals = np.random.default_rng(seed).random(g.n_pad).astype(np.float32) + 0.05
    return keys, ops, slots, sp, torch.from_numpy(vals).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
@pytest.mark.parametrize("P", [4, 8])
def test_pass_equals_per_subshard_calls_bitwise(P, gather_op, reduce, dtype):
    """The plain pass equals one plain call per sub-shard, bit for bit, on every sub-shard."""
    keys, ops, slots, sp, vals = _session_pass(P, gather_op, reduce, DTYPES[dtype][1])
    isz = _rmat10(P)[0].interval_size
    hubs, offsets = tk.subshard_update_pass(vals, sp)
    assert offsets.tolist() == np.concatenate([[0], np.cumsum(slots)]).tolist()
    assert hubs.shape == (sum(slots),) and hubs.dtype == vals.dtype
    for k, (i, _) in enumerate(keys):
        want = tops.subshard_update(
            vals[i * isz:(i + 1) * isz], *ops[k], slots[k], gather_op=gather_op, reduce=reduce
        )
        _same_bits(hubs[offsets[k]:offsets[k + 1]], want.view(torch.int16).numpy()
                   if want.dtype == torch.bfloat16 else want.numpy())
    assert sp.flags.sum() == 0  # destination-sorted: every sub-shard on the fast path


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_pass_subshards_match_jax(gather_op, reduce, dtype):
    """A few sub-shards of the pass against the JAX kernel (interpret mode), in its bounds."""
    keys, ops, _, sp, vals = _session_pass(4, gather_op, reduce, DTYPES[dtype][1])
    isz = _rmat10(4)[0].interval_size
    hubs, offsets = tk.subshard_update_pass(vals, sp)
    jdt = DTYPES[dtype][0]
    for k in (0, len(keys) // 2, len(keys) - 1):
        i = keys[k][0]
        jin = [jnp.asarray(t.float().numpy() if t.is_floating_point() else t.numpy()) for t in ops[k]]
        jin[2] = jin[2].astype(jdt)
        jvals = jnp.asarray(vals[i * isz:(i + 1) * isz].float().numpy(), jdt)
        jhub = jops.subshard_update(
            jvals, *jin, int(offsets[k + 1] - offsets[k]), gather_op=gather_op, reduce=reduce
        )
        _close(hubs[offsets[k]:offsets[k + 1]], jhub, reduce, dtype)


def _bf16(x):
    """float32 → bfloat16 → float32, round to nearest even (numpy scalar)."""
    if np.isnan(x):
        return np.float32(np.nan)
    u = np.uint64(np.array([x], np.float32).view(np.uint32)[0])
    u = ((u + ((u >> np.uint64(16)) & np.uint64(1)) + np.uint64(0x7FFF)) >> np.uint64(16)) << np.uint64(16)
    return np.array([u], np.uint64).astype(np.uint32).view(np.float32)[0]


def _emulate_pass(src_vals, sp):
    """csrc/dsss_spmv.cu over a SubshardPass, lane by lane, in numpy float32.

    Phase 1 gives each 512-edge block to a warp, 16 edges a lane; on a
    sub-shard whose slots never decrease, the lane holding a run's first
    edge folds the run up to the next run start (a suffix min of the lanes'
    first starts) and writes fill ⊕ partial, fills the slots no edge
    reaches, or leaves the partial in head/tail when the run crosses into a
    neighbouring block; phase 2 walks those runs. A flagged sub-shard's
    blocks write their whole window of partials, and phase 2 folds one slot
    at a time over the covering blocks. Returns the hub vectors and how many
    times each slot was written.
    """
    rnd = _bf16 if sp.weights.dtype == torch.bfloat16 else np.float32
    red = sp.reduce
    ident = np.float32({"sum": 0.0, "min": np.inf, "max": -np.inf}[red])

    def comb(acc, x):
        if red == "sum":
            return np.float32(acc + x)
        if red == "min":
            return x if x < acc else acc
        return x if x > acc else acc

    E, L, PER = tk.E_BLK, 32, tk.E_BLK // 32
    sv = src_vals.float().numpy()
    src, hub_inv = sp.src_idx.numpy(), sp.hub_inv.numpy().astype(np.int64)
    w, bases = sp.weights.float().numpy(), sp.block_base.numpy().astype(np.int64)
    fb, meta, flags = sp.first_block, sp.meta, sp.flags
    out = np.zeros(int(meta[:, 2].sum()), np.float32)
    writes = np.zeros(out.shape, np.int64)
    head, tail, partials = {}, {}, {}

    def put(i, v):
        out[i] = v
        writes[i] += 1

    def sub_shard(b):
        k = int(np.searchsorted(fb[:-1], b, side="right") - 1)
        return k, int(fb[k]), int(fb[k + 1]), *(int(x) for x in meta[k])

    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(bases.shape[0]):
            k, first, end_b, src_off, isize, num_slots, out_off = sub_shard(b)
            base, e0 = int(bases[b]), b * E
            val = np.empty(E, np.float32)
            for p in range(E):
                s = int(src[e0 + p])
                v = sv[src_off + s] if 0 <= s < isize else np.float32(np.nan)
                val[p] = rnd(v * w[e0 + p] if sp.gather_op == "mul" else v + w[e0 + p])
            hub = hub_inv[e0:e0 + E]
            if flags[0, k]:
                acc = np.full(E, ident, np.float32)
                for p in range(E):
                    if 0 <= hub[p] - base < E:
                        acc[hub[p] - base] = comb(acc[hub[p] - base], val[p])
                partials[b] = [rnd(x) for x in acc]
                continue
            starts = [sum(int(p == 0 or hub[p] != hub[p - 1]) << j
                          for j, p in enumerate(range(lane * PER, (lane + 1) * PER)))
                      for lane in range(L)]
            firsts = [lane * PER + (st & -st).bit_length() - 1 if st else E
                      for lane, st in enumerate(starts)]
            has_prev, has_next = b > first, b + 1 < end_b
            prev_last = int(hub_inv[e0 - 1]) if has_prev else 0
            next_first = int(hub_inv[e0 + E]) if has_next else 0
            for lane in range(L):
                end = min(firsts[lane + 1:], default=E)
                for j in reversed(range(PER)):
                    if not starts[lane] >> j & 1:
                        continue
                    p = lane * PER + j
                    h = int(hub[p])
                    acc = ident
                    for i in range(p, end):
                        acc = comb(acc, val[i])
                    part = rnd(acc)
                    prev_shared = p == 0 and has_prev and prev_last == h
                    next_shared = end == E and has_next and next_first == h
                    if prev_shared:
                        head[b] = part
                    if next_shared:
                        tail[b] = part
                    if not prev_shared and not next_shared and 0 <= h < num_slots:
                        put(out_off + h, rnd(comb(ident, part)) if 0 <= h - base < E else ident)
                    lo = int(hub[p - 1]) + 1 if p > 0 else (prev_last + 1 if has_prev else 0)
                    for s in range(max(lo, 0), min(h, num_slots)):
                        put(out_off + s, ident)
                    if end == E and not has_next:
                        for s in range(max(h + 1, 0), num_slots):
                            put(out_off + s, ident)
                    end = p
        for b in range(bases.shape[0]):  # phase 2: runs that cross blocks
            k, first, end_b, _, _, num_slots, out_off = sub_shard(b)
            e = b * E
            if flags[0, k] or b + 1 >= end_b or hub_inv[e + E] != hub_inv[e + E - 1]:
                continue
            h = int(hub_inv[e + E - 1])
            if b > first and hub_inv[e - 1] == h:
                continue
            v = rnd(comb(ident, tail[b])) if 0 <= h - bases[b] < E else ident
            for c in range(b + 1, end_b):
                if hub_inv[c * E] != h:
                    break
                if 0 <= h - bases[c] < E:
                    v = rnd(comb(v, head[c]))
                if hub_inv[c * E + E - 1] != h:
                    break
            if 0 <= h < num_slots:
                put(out_off + h, v)
        for k in np.flatnonzero(flags[0]):  # phase 2: flagged sub-shards, a slot at a time
            first, end_b, num_slots, out_off = int(fb[k]), int(fb[k + 1]), int(meta[k, 2]), int(meta[k, 3])
            for s in range(num_slots):
                v = ident
                for c in range(first, end_b):
                    if 0 <= s - bases[c] < E:
                        v = rnd(comb(v, partials[c][s - bases[c]]))
                put(out_off + s, v)
    return out, writes


def _edge_cases_pass(gather_op, reduce, dtype):
    """The JAX tests' shapes, slots out of order, and a hand-made stream.

    The hand-made sub-shard has a run crossing three blocks, gaps (slots no
    edge reaches, before the first, between runs and after the last), a
    jump past the 512-slot window, and slots beyond the last edge. Sources
    outside the interval give NaN contribs; zero weights on negative and
    -0.0 values give -0.0 contribs under a sum.
    """
    tdt = DTYPES[dtype][1]
    ops, isizes, slots = [], [], []
    for isize, e, nslots in SHAPES + [(300, 2000, 150)]:
        src_local, hub_inv, w = _random_subshard(isize, e, nslots, e + isize, len(ops) < len(SHAPES))
        ops.append(tops.prepare_subshard_operands(
            src_local, hub_inv, w, tdt, gather_op=gather_op, reduce=reduce, device="cpu"))
        isizes.append(isize)
        slots.append(nslots)
    rng = np.random.default_rng(7)
    e = 3000
    hub_inv = np.concatenate([
        np.full(1400, 3), np.arange(4, 300), np.full(700, 900), np.arange(1000, 1604)
    ]).astype(np.int32)
    w = rng.random(e).astype(np.float32) + 0.1
    if reduce == "sum":
        w[::3] = 0.0
    ops.append(tops.prepare_subshard_operands(
        rng.integers(0, 50, e).astype(np.int32), hub_inv, w, tdt,
        gather_op=gather_op, reduce=reduce, device="cpu"))
    isizes.append(50)
    slots.append(1800)
    src_idx = ops[0][0].clone()
    src_idx[[5, 40]] = torch.tensor([70, -2], dtype=torch.int32)
    ops[0] = (src_idx, *ops[0][1:])
    vals = rng.random(sum(isizes)).astype(np.float32) + 0.5
    vals[::7] *= -1
    vals[::11] = -0.0
    sp = tops.prepare_subshard_pass(
        ops, np.cumsum([0] + isizes[:-1]).tolist(), isizes, slots,
        gather_op=gather_op, reduce=reduce,
    )
    return sp, torch.from_numpy(vals).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gather_op,reduce", SEMIRINGS)
def test_kernel_emulation_matches_plain(gather_op, reduce, dtype):
    """The kernel's algorithm gives the plain version's bits and writes every slot once.

    On the edge cases, on every sub-shard of R-MAT scale 10 (P = 4), and on
    a src_sorted build of it, whose sub-shards take the general path.
    """
    tdt = DTYPES[dtype][1]
    src, dst = j_rmat(10, edge_factor=8, seed=1)
    el = j_densify(src, dst, drop_self_loops=True)
    jg = jc.build_dsss(el, 4, src_sorted=True)
    fields = {f: getattr(jg, f) for f in jg.__dataclass_fields__}
    fields["edgelist"] = vars(jg.edgelist)
    g = dsss_from_arrays(fields)
    sess = rt.GraphSession(g, device="cpu")
    keys = sorted(sess.block_keys)
    src_sorted = tops.prepare_subshard_pass(
        [sess.kernel_operands(i, j, tdt, gather_op=gather_op, reduce=reduce) for i, j in keys],
        [i * g.interval_size for i, _ in keys], [g.interval_size] * len(keys),
        [sess.host_blocks[key]["u"] for key in keys], gather_op=gather_op, reduce=reduce,
    )
    assert src_sorted.flags[0].all()
    passes = [
        _edge_cases_pass(gather_op, reduce, dtype),
        _session_pass(4, gather_op, reduce, tdt)[3:],
        (src_sorted, torch.from_numpy(np.random.default_rng(2).random(g.n_pad).astype(np.float32)).to(tdt)),
    ]
    for sp, vals in passes:
        got, writes = _emulate_pass(vals, sp)
        want = tk.subshard_update_pass_ref(vals, sp)[0].float().numpy()
        np.testing.assert_array_equal(writes, 1)
        same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), np.flatnonzero(~same)[:10]
    sp, vals = passes[0]
    got, _ = _emulate_pass(vals, sp)
    assert np.isnan(got).any() == (reduce == "sum")


@pytest.mark.parametrize("bad", [
    "not_a_pass", "src_dtype", "weights_dtype", "short_src_vals", "first_block",
    "out_offsets", "negative_slots", "block_base", "semiring", "device",
])
def test_pass_refuses_malformed_staging(bad):
    """Staging the pass cannot run is refused, when built or when called; nothing else runs."""
    _, _, _, sp, vals = _session_pass(4, "mul", "sum", torch.float32)
    first_block, meta = sp.first_block.copy(), sp.meta.copy()

    def malformed():
        nonlocal vals
        if bad == "not_a_pass":
            return dataclasses.astuple(sp)
        if bad == "src_dtype":
            vals = vals.double()
        elif bad == "weights_dtype":
            return dataclasses.replace(sp, weights=sp.weights.to(torch.bfloat16))
        elif bad == "short_src_vals":
            vals = vals[:-1]
        elif bad == "first_block":
            first_block[1] = first_block[2]
        elif bad == "out_offsets":
            meta[1, 3] += 1
        elif bad == "negative_slots":
            meta[0, 2] = -1
        elif bad == "block_base":
            return dataclasses.replace(sp, block_base=sp.block_base[:-1])
        elif bad == "semiring":
            return dataclasses.replace(sp, reduce="mean")
        else:
            vals = vals.to("meta")
        return dataclasses.replace(sp, first_block=first_block, meta=meta)

    before = tk.launches
    with pytest.raises((ValueError, TypeError)):
        staged = malformed()
        tk.subshard_update_pass(vals, staged)
    assert tk.launches == before


def test_prepare_subshard_pass_refuses_mismatched_operands():
    _, ops, slots, _, _ = _session_pass(4, "mul", "sum", torch.float32)
    kw = dict(gather_op="mul", reduce="sum")
    with pytest.raises(ValueError, match="one source offset"):
        tops.prepare_subshard_pass(ops, [0] * len(ops), [1] * len(ops), slots[:-1], **kw)
    with pytest.raises(ValueError, match="padded"):
        bad = [(ops[0][0][:-1], *ops[0][1:])] + ops[1:]
        tops.prepare_subshard_pass(bad, [0] * len(ops), [1] * len(ops), slots, **kw)
    with pytest.raises(ValueError, match="dtype"):
        bad = [(*ops[0][:2], ops[0][2].to(torch.bfloat16), ops[0][3])] + ops[1:]
        tops.prepare_subshard_pass(bad, [0] * len(ops), [1] * len(ops), slots, **kw)
    with pytest.raises(ValueError, match="slot counts"):
        tops.prepare_subshard_pass(ops, [0] * len(ops), [1] * len(ops), [-1] + slots[1:], **kw)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's CUDA path."""

    @property
    def device(self):
        return torch.device("cuda")


class _FellBack(Exception):
    pass


@pytest.mark.parametrize("kind", ["cuda", "meta"])
def test_wrapper_never_falls_back_to_the_plain_version(kind, monkeypatch):
    """A non-CPU tensor launches the kernel or raises (here: no card, no nvcc)."""

    def no_fallback(*a, **k):
        raise _FellBack("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(tk, "subshard_update_ref", no_fallback)
    monkeypatch.setattr(tk, "dsss_spmv_block_partials_ref", no_fallback)
    monkeypatch.setattr(tk, "subshard_update_pass_ref", no_fallback)
    _, _, (tvals, tin) = _both(64, 100, 32, "mul", "sum", "float32")
    sp = tops.prepare_subshard_pass([tin], [0], [64], [32], gather_op="mul", reduce="sum")
    if kind == "cuda":
        move = lambda t: t.as_subclass(_OnCuda)  # noqa: E731
    else:
        move = lambda t: t.to("meta")  # noqa: E731
    args = [move(t) for t in (tvals, *tin)]
    sp = copy.copy(sp)  # the staging as built, its tensors moved without rebuilding it
    for name in ("src_idx", "hub_inv", "weights", "block_base"):
        object.__setattr__(sp, name, move(getattr(sp, name)))
    object.__setattr__(sp, "tables", {k: move(v) for k, v in sp.tables.items()})
    before = tk.launches
    for call in (lambda: tk.subshard_update(*args, 32), lambda: tk.dsss_spmv_block_partials(*args),
                 lambda: tk.subshard_update_pass(args[0], sp)):
        with pytest.raises(Exception) as info:
            call()
        assert not isinstance(info.value, _FellBack)
    assert tk.launches == before


@pytest.mark.parametrize("bad", ["dtype", "weights", "e_pad", "block_base"])
def test_wrapper_refuses_malformed_operands(bad):
    _, _, (tvals, (src_idx, hub_inv, w, base)) = _both(64, 100, 32, "mul", "sum", "float32")
    if bad == "dtype":
        tvals = tvals.double()
    elif bad == "weights":
        w = w.to(torch.bfloat16)
    elif bad == "e_pad":
        src_idx = src_idx[:-1]
    else:
        base = torch.cat([base, base])
    with pytest.raises((ValueError, TypeError)):
        tk.subshard_update(tvals, src_idx, hub_inv, w, base, 32)


@pytest.mark.parametrize("entry", ["dsss_spmv_launch", "dsss_spmv_stage_one"])
def test_argtypes_match_the_c_signature(entry):
    """The ctypes binding of each C entry point matches its parameters in dsss_spmv.cu."""
    import ctypes
    import re
    from pathlib import Path

    text = (Path(tk.__file__).parent / "csrc" / "dsss_spmv.cu").read_text()
    match = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert match, entry
    params = [" ".join(p.split()) for p in match.group(1).split(",")]
    assert len(params) == len(tk._ARGTYPES[entry])
    for param, argtype in zip(params, tk._ARGTYPES[entry]):
        want = ctypes.c_void_p if "*" in param else {"int": ctypes.c_int}[param.rsplit(" ", 1)[0]]
        assert argtype is want, param
