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
"""
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
    _, _, (tvals, tin) = _both(64, 100, 32, "mul", "sum", "float32")
    if kind == "cuda":
        args = [t.as_subclass(_OnCuda) for t in (tvals, *tin)]
    else:
        args = [t.to("meta") for t in (tvals, *tin)]
    before = tk.launches
    for call in (lambda: tk.subshard_update(*args, 32), lambda: tk.dsss_spmv_block_partials(*args)):
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
