"""The 2-D partitioned PageRank of the port against the JAX package's, on the CPU.

* ``build_device_blocks`` gives the reference's arrays bit for bit, for
  grids whose ``lcm(R, C)`` does not divide ``n`` (but (1, 1)'s, 1).
* ``distributed_pagerank`` on four spawned gloo CPU ranks (one spawn group
  running the meshes (2, 2), (2, 1, 2) with source axes ("pod", "data"),
  (4, 1) and (1, 4), 12 iterations, and (2, 2) again with ``tol``) is held
  within 1e-6 (max abs) of the JAX ``NXGraphEngine(..., strategy="fused")``
  and of the JAX ``distributed_pagerank``, which runs in a subprocess on
  four forced host devices, as ``tests/test_system.py`` runs it. Both sum
  the same float32 terms in other orders (B2's block windows and gloo's
  ring against XLA's scatter and psum); over 12 iterations of R-MAT 9 the
  two differ by about 1e-8.
* The ToHub stage numbers destinations densely, so a block whose
  destinations jump past B2's 512-slot window loses no edge.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import NXGraphEngine as JEngine  # noqa: E402
from repro.core import PageRank as JPageRank  # noqa: E402
from repro.core import build_dsss as j_build_dsss  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.graph.preprocess import degree_and_densify as j_densify  # noqa: E402

from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.graph.generators import rmat  # noqa: E402
from repro_torch.graph.preprocess import degree_and_densify  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ITERS = 12
TOL = 1e-6
# (shape, axes, src_axes, tol); the last runs until the L1 change is below 1e-4.
MESHES = (
    ((2, 2), ("data", "model"), ("data",), 0.0),
    ((2, 1, 2), ("pod", "data", "model"), ("pod", "data"), 0.0),
    ((4, 1), ("data", "model"), ("data",), 0.0),
    ((1, 4), ("data", "model"), ("data",), 0.0),
    ((2, 2), ("data", "model"), ("data",), 1e-4),
)
MESH_IDS = ["2x2", "2x1x2", "4x1", "1x4", "2x2-tol"]


def _graph():
    return degree_and_densify(*rmat(9, edge_factor=8, seed=5), drop_self_loops=True)


@pytest.fixture(scope="module")
def port_runs():
    """Every mesh on one spawn group of four gloo CPU ranks."""
    return tdist.spawn_gloo(tdist.run_meshes, 4, _graph(), MESHES, ITERS, "cpu")


@pytest.fixture(scope="module")
def jax_fused():
    src, dst = rmat(9, edge_factor=8, seed=5)
    el = j_densify(src, dst, drop_self_loops=True)
    return JEngine(j_build_dsss(el, 4), JPageRank(), strategy="fused").run(ITERS, tol=0.0).attrs


_JAX_SCRIPT = """
import json, sys
import jax, numpy as np
from repro.core.distributed import distributed_pagerank
from repro.graph.generators import rmat
from repro.graph.preprocess import degree_and_densify
el = degree_and_densify(*rmat(9, edge_factor=8, seed=5), drop_self_loops=True)
out = {}
for i, (shape, axes, src_axes, tol) in enumerate(json.loads(sys.argv[1])):
    mesh = jax.make_mesh(tuple(shape), tuple(axes))
    ranks, it = distributed_pagerank(el, mesh, iters=%d, src_axes=tuple(src_axes),
                                     dst_axis=axes[-1], tol=tol)
    out[f"r{i}"], out[f"i{i}"] = ranks, it
np.savez(sys.argv[2], **out)
""" % ITERS


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's distributed_pagerank on four forced host devices."""
    out = tmp_path_factory.mktemp("jax_dist") / "runs.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, json.dumps(MESHES), str(out)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    with np.load(out) as z:
        return [(z[f"r{i}"], int(z[f"i{i}"])) for i in range(len(MESHES))]


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (4, 1), (1, 4), (3, 2)])
def test_build_device_blocks_is_bitwise_the_reference(R, C):
    rng = np.random.default_rng(R * 10 + C)
    n = 1001  # 7·11·13: no lcm of these grids but (1, 1)'s divides it
    src = np.concatenate([np.arange(n), rng.integers(0, n, 6000)]).astype(np.int32)
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 6000)]).astype(np.int32)
    el, jel = degree_and_densify(src, dst, drop_self_loops=True), j_densify(src, dst, drop_self_loops=True)
    assert el.n == jel.n == n and (R * C == 1 or n % np.lcm(R, C))
    got, want = tdist.build_device_blocks(el, R, C), jdist.build_device_blocks(jel, R, C)
    for f in ("n", "n_pad", "R", "C", "row_chunk", "col_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("src_local", "dst_local", "weight"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    counts = got.edge_counts()
    assert counts.sum() == el.m and counts.max() == got.weight.shape[-1]


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_distributed_pagerank_matches_the_jax_fused_engine(port_runs, jax_fused, mesh):
    for rank, per_mesh in enumerate(port_runs):
        ranks, iters = per_mesh[mesh]
        assert ranks.shape == jax_fused.shape and ranks.dtype == np.float32
        if MESHES[mesh][3] == 0.0:
            assert iters == ITERS
            np.testing.assert_allclose(ranks, jax_fused, atol=TOL, rtol=0)
        # every rank returns the same vector
        np.testing.assert_array_equal(ranks, port_runs[0][mesh][0])


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_distributed_pagerank_matches_the_jax_distributed_pagerank(port_runs, jax_runs, mesh):
    want, want_iters = jax_runs[mesh]
    for per_mesh in port_runs:
        ranks, iters = per_mesh[mesh]
        assert iters == want_iters  # the tol run stops at the reference's iteration too
        np.testing.assert_allclose(ranks, want, atol=TOL, rtol=0)
    assert 1 < want_iters < ITERS or MESHES[mesh][3] == 0.0


def test_selftest_prints_ok():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.core.distributed", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "selftest OK" in out.stdout, out.stdout + out.stderr


def test_tohub_keeps_edges_past_the_slot_window():
    """Destinations with gaps far wider than 512 slots: ToHub equals a float64 sum."""
    rng = np.random.default_rng(3)
    col_chunk = 200_000
    dst = np.sort(np.concatenate([rng.integers(0, col_chunk, 3000), np.full(900, 7),
                                  [col_chunk - 1] * 3])).astype(np.int32)
    src = rng.integers(0, 500, len(dst)).astype(np.int32)
    w = rng.random(len(dst)).astype(np.float32) + 0.01
    x = torch.from_numpy(rng.random(500).astype(np.float32))
    ops = tdist.tohub_operands(src, dst, w, "cpu")
    assert ops.num_slots == len(np.unique(dst)) and int(ops.hub_inv.max()) == ops.num_slots - 1
    got = tdist.tohub(x, ops, col_chunk).numpy()
    want = np.zeros(col_chunk)
    np.add.at(want, dst, x.numpy()[src].astype(np.float64) * w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="non-decreasing"):
        tdist.tohub_operands(src, dst[::-1], w, "cpu")


def test_rank_block_round_trips_through_a_file(tmp_path):
    el = _graph()
    blocks = tdist.build_device_blocks(el, 2, 2)
    counts = blocks.edge_counts()
    for r in range(2):
        for c in range(2):
            blk = blocks.rank_block(r, c, el.out_degree)
            assert len(blk.src_local) == counts[r, c] and blk.e_max == counts.max()
            assert np.all(np.diff(blk.dst_local) >= 0) and np.all(blk.weight > 0)
            blk.save(tmp_path / f"b{r}{c}.npz")
            back = tdist.RankBlock.load(tmp_path / f"b{r}{c}.npz")
            for f, v in vars(blk).items():
                assert np.array_equal(getattr(back, f), v), f
    dang = np.zeros(blocks.n_pad, np.float32)
    dang[: el.n] = el.out_degree == 0
    assert np.array_equal(blocks.rank_block(1, 0, el.out_degree).dangling, dang[blocks.row_chunk:])


def test_meshes_need_an_initialised_group():
    import torch.distributed as dist

    from repro_torch.launch import mesh

    assert not dist.is_initialized()  # importing the module touched nothing
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    assert tdist.GRAPH_SCALES == jdist.GRAPH_SCALES
