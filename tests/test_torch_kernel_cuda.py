"""The CUDA tile-sweep kernel against its plain version, on the card.

Needs a CUDA device (``-m cuda``); skips without one, since the kernel has
no CPU mode. Imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import identities as tid
from repro_torch.core import vertex_programs as vp
from repro_torch.core.dsss import build_dsss
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import GraphSession
from repro_torch.graph.generators import rmat, zipf
from repro_torch.graph.preprocess import degree_and_densify
from repro_torch.kernels import packed_sweep as ps

pytestmark = pytest.mark.cuda

PROGRAMS = [
    vp.PageRank(), vp.BFS(), vp.WCC(), vp.SSSP(), vp.MaxLabelForward(), vp.ReachBackward(),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile-sweep kernel has no CPU mode")
    return torch.device("cuda")


def _graph(kind, P, weighted):
    src, dst = rmat(10, edge_factor=8, seed=3) if kind == "rmat" else zipf(3000, 20000, seed=4)
    w = np.random.default_rng(5).random(src.shape[0]).astype(np.float32) + 0.01
    return build_dsss(
        degree_and_densify(src, dst, w if weighted else None, drop_self_loops=True), P
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
