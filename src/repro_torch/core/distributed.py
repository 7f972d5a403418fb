"""Multi-GPU NXgraph: the DSSS grid partitioned over a 2-D device mesh.

Port of the JAX package's ``repro.core.distributed``. The sub-shard grid
becomes a (source-axis × destination-axis) grid of ranks: rank (r, c) owns
the edges with source in row chunk r and destination in column chunk c, a
device-granular sub-shard, destination-sorted within. One iteration is:

  ToHub    — kernel B2 (``kernels/dsss_spmv.subshard_update``) gathers
             ``x[src] · w`` over the rank's block and folds it into one
             slot per destination it reaches; the slots are placed into
             the column chunk's partial (the *hub*);
  FromHub  — ``all_reduce(SUM)`` of the hubs over the source-axis group
             (the paper's column-major hub fold as a collective);
  Exchange — ``all_gather`` of the column chunks over the destination
             axis into the ``(n_pad,)`` vector, of which each rank keeps
             its source row chunk.

The reference runs one single-controller ``shard_map``; the port runs one
process per mesh position under ``torch.distributed`` (a ``DeviceMesh``
from :func:`repro_torch.launch.mesh.make_mesh`), and every rank calls
:func:`distributed_pagerank`. Single pod: source axes ``("data",)``;
multi-pod: ``("pod", "data")``, which needs one group per column over two
mesh axes (``_axes_group``).

B2 folds in a fixed order with no float atomics, so a run gives the same
bits every time on the same mesh. Its 512-slot window needs slots that
step by at most one from edge to edge, so the block's destinations are
numbered densely (the rank's hub slots) and placed into the column chunk
by index afterwards.

``graph_input_specs`` (the dry run's stand-ins) is not ported yet
(ROADMAP A13 item 5).
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.graph.preprocess import EdgeList
from repro_torch.kernels import dsss_spmv
from repro_torch.kernels.ops import prepare_subshard_operands

__all__ = [
    "DeviceBlocks",
    "RankBlock",
    "Placement",
    "PageRankStep",
    "ToHubOperands",
    "tohub_operands",
    "tohub",
    "build_device_blocks",
    "make_pagerank_step",
    "distributed_pagerank",
    "spawn_gloo",
    "run_meshes",
    "GRAPH_SCALES",
]


@dataclasses.dataclass
class DeviceBlocks:
    """Edge blocks stacked per device: (R, C, E_max) arrays, bitwise the reference's."""

    n: int
    n_pad: int
    R: int
    C: int
    src_local: np.ndarray  # (R, C, E) int32, row-chunk-local source ids
    dst_local: np.ndarray  # (R, C, E) int32, column-chunk-local dst ids
    weight: np.ndarray  # (R, C, E) f32: 1/outdeg(src), 0 for padding
    row_chunk: int
    col_chunk: int

    def edge_counts(self) -> np.ndarray:
        """(R, C) real edges per block. A real edge's weight 1/outdeg(src) is
        positive and the padding's is 0, and real edges come first."""
        return np.count_nonzero(self.weight, axis=-1)

    def rank_block(self, r: int, c: int, out_degree: np.ndarray) -> RankBlock:
        """Block (r, c) without its padding, with the row chunk's dangling mask."""
        e = int(np.count_nonzero(self.weight[r, c]))
        dang = np.zeros(self.n_pad, np.float32)
        dang[: self.n] = (np.asarray(out_degree) == 0).astype(np.float32)
        lo = r * self.row_chunk
        return RankBlock(
            n=self.n, n_pad=self.n_pad, R=self.R, C=self.C, row=r, col=c,
            row_chunk=self.row_chunk, col_chunk=self.col_chunk,
            e_max=int(self.weight.shape[-1]),
            src_local=self.src_local[r, c, :e].copy(), dst_local=self.dst_local[r, c, :e].copy(),
            weight=self.weight[r, c, :e].copy(), dangling=dang[lo: lo + self.row_chunk],
        )


@dataclasses.dataclass
class RankBlock:
    """What one rank stages: its block's real edges (destination-sorted) and
    its row chunk of the dangling mask. ``e_max`` is the grid's padded
    block length, kept for reports. :meth:`save`/:meth:`load` carry it in
    a ``.npz`` file, so a launcher builds the grid once and each rank reads
    only its own block."""

    n: int
    n_pad: int
    R: int
    C: int
    row: int
    col: int
    row_chunk: int
    col_chunk: int
    e_max: int
    src_local: np.ndarray  # (e,) int32
    dst_local: np.ndarray  # (e,) int32, non-decreasing
    weight: np.ndarray  # (e,) float32
    dangling: np.ndarray  # (row_chunk,) float32, 1 where out_degree == 0

    def save(self, path) -> None:
        np.savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path) -> RankBlock:
        with np.load(path) as z:
            return cls(**{
                f.name: (z[f.name] if z[f.name].ndim else int(z[f.name]))
                for f in dataclasses.fields(cls)
            })


def build_device_blocks(el: EdgeList, R: int, C: int) -> DeviceBlocks:
    """Partition (degreed) edges into the R×C device grid, DSSS-sorted."""
    n = el.n
    n_pad = int(np.lcm(R, C) * -(-n // np.lcm(R, C)))
    row_chunk, col_chunk = n_pad // R, n_pad // C
    src, dst = el.src.astype(np.int64), el.dst.astype(np.int64)
    r = src // row_chunk
    c = dst // col_chunk
    order = np.lexsort((src, dst, c, r))  # destination-sorted within block
    src, dst = src[order], dst[order]
    r, c = r[order], c[order]
    block = r * C + c
    counts = np.bincount(block, minlength=R * C)
    e_max = max(int(counts.max()), 1)
    src_l = np.zeros((R * C, e_max), np.int32)
    dst_l = np.zeros((R * C, e_max), np.int32)
    w = np.zeros((R * C, e_max), np.float32)
    deg = el.out_degree.astype(np.float32)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    starts = np.zeros(R * C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    for b in range(R * C):
        lo, hi = int(starts[b]), int(starts[b + 1])
        e = hi - lo
        src_l[b, :e] = (src[lo:hi] - (b // C) * row_chunk).astype(np.int32)
        dst_l[b, :e] = (dst[lo:hi] - (b % C) * col_chunk).astype(np.int32)
        w[b, :e] = inv[src[lo:hi]]
    return DeviceBlocks(
        n=n, n_pad=n_pad, R=R, C=C,
        src_local=src_l.reshape(R, C, e_max),
        dst_local=dst_l.reshape(R, C, e_max),
        weight=w.reshape(R, C, e_max),
        row_chunk=row_chunk, col_chunk=col_chunk,
    )


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where the calling rank's data lives, the port's stand-in for the
    reference's ``(src_spec, blk_spec)``: ``x`` and the dangling mask are
    split over ``src_axes`` into ``R`` row chunks of ``row_chunk`` and
    repeated along ``dst_axis``; the edge blocks are split over both, one
    per rank. This rank holds row chunk ``row`` of ``x``
    (``x_full[row_slice]``) and block ``(row, col)``, whose destinations
    are column chunk ``col``."""

    src_axes: tuple[str, ...]
    dst_axis: str
    R: int
    C: int
    row: int
    col: int
    row_chunk: int
    col_chunk: int

    @property
    def row_slice(self) -> slice:
        return slice(self.row * self.row_chunk, (self.row + 1) * self.row_chunk)

    @classmethod
    def on(cls, mesh, n_pad: int, *, src_axes, dst_axis) -> Placement:
        """The calling rank's placement on ``mesh``: its row is its
        coordinates on ``src_axes`` read as one number (the first axis
        most significant), its column its coordinate on ``dst_axis``."""
        src_axes = tuple(src_axes)
        shape, coord = tuple(mesh.mesh.shape), mesh.get_coordinate()
        R, C = _grid(mesh, src_axes, dst_axis)
        if n_pad % R or n_pad % C:
            raise ValueError(f"n_pad {n_pad} is not a multiple of R={R} and C={C}")
        row = 0
        for a in src_axes:
            i = _axis_index(mesh, a)
            row = row * shape[i] + coord[i]
        return cls(src_axes, dst_axis, R, C, row, coord[_axis_index(mesh, dst_axis)], n_pad // R, n_pad // C)


class ToHubOperands(NamedTuple):
    """Kernel B2's operands for one block (``ops.prepare_subshard_operands``),
    its slot count, and each slot's column-chunk-local destination."""

    src_idx: torch.Tensor
    hub_inv: torch.Tensor
    weights: torch.Tensor
    block_base: torch.Tensor
    num_slots: int
    hub_dst: torch.Tensor  # (num_slots,) int64


def tohub_operands(src_local, dst_local, weight, device=None) -> ToHubOperands:
    """Kernel B2's operands for a block's real edges (padding dropped first).

    The destinations must be non-decreasing; each distinct one gets the
    next hub slot, so slots step by at most one from edge to edge and every
    512-edge block stays inside B2's window whatever gaps the destinations
    leave. ``device=None`` is the CUDA card.
    """
    dst = np.asarray(dst_local, np.int64)
    if len(dst) and np.any(np.diff(dst) < 0):
        raise ValueError("the block's destinations must be non-decreasing")
    first = np.ones(len(dst), bool)
    first[1:] = dst[1:] != dst[:-1]
    hub_inv = (np.cumsum(first) - 1).astype(np.int32)
    dev = resolve_device(device)
    ops = prepare_subshard_operands(
        np.asarray(src_local, np.int32), hub_inv, np.asarray(weight, np.float32), torch.float32,
        gather_op="mul", reduce="sum", device=dev,
    )
    return ToHubOperands(*ops, num_slots=int(first.sum()), hub_dst=torch.from_numpy(dst[first]).to(dev))


def tohub(x: torch.Tensor, ops: ToHubOperands, col_chunk: int) -> torch.Tensor:
    """ToHub: the block's ``x[src] · w`` summed per destination by kernel B2
    (its plain version on a CPU tensor), as a ``(col_chunk,)`` partial."""
    hub = dsss_spmv.subshard_update(
        x, ops.src_idx, ops.hub_inv, ops.weights, ops.block_base, ops.num_slots,
        gather_op="mul", reduce="sum",
    )
    y_c = torch.zeros(col_chunk, dtype=x.dtype, device=x.device)
    y_c[ops.hub_dst] = hub
    return y_c


def _axis_index(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    return names.index(axis)


def _grid(mesh, src_axes, dst_axis) -> tuple[int, int]:
    """(R, C): the source axes' sizes multiplied, the destination axis' size."""
    shape = tuple(mesh.mesh.shape)
    return math.prod(shape[_axis_index(mesh, a)] for a in src_axes), shape[_axis_index(mesh, dst_axis)]


def _axes_group(mesh, axes: tuple[str, ...]):
    """``(group, made)``: the group of ranks that share this rank's
    coordinates off ``axes``, and the groups made here for it.

    One mesh axis: the mesh's own group, nothing made. Several: one
    ``dist.new_group`` per setting of the other axes, created by every rank
    in the same order; ``made`` holds the one this rank belongs to."""
    if len(axes) == 1:
        return mesh.get_group(axes[0]), []
    dims = [_axis_index(mesh, a) for a in axes]
    others = [d for d in range(mesh.mesh.ndim) if d not in dims]
    grid = mesh.mesh.permute(*others, *dims).reshape(-1, math.prod(mesh.mesh.shape[d] for d in dims))
    me = dist.get_rank()
    mine = None
    for ranks in grid.tolist():
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine, [mine]


class PageRankStep:
    """One PageRank iteration for the calling rank (``make_pagerank_step``).

    ``step(x, dang, ops)`` takes the rank's row chunk of ``x`` and of the
    dangling mask and its block's B2 operands (:func:`tohub_operands`, built
    once on :attr:`device`), and returns the next row chunk and the global
    L1 change (a ``(1,)`` tensor, the same on every rank). :attr:`full`
    holds the last iteration's ``(n_pad,)`` vector, which every rank
    computes. :meth:`close` destroys the process groups the step made.
    """

    def __init__(self, mesh, n: int, n_pad: int, *, src_axes, dst_axis, damping):
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError("the mesh must hold every rank of the default group")
        self.placement = Placement.on(mesh, n_pad, src_axes=src_axes, dst_axis=dst_axis)
        src_axes, d = self.placement.src_axes, _axis_index(mesh, dst_axis)
        self.n, self.n_pad, self.damping = n, n_pad, damping
        self.device = resolve_device(mesh.device_type)
        self._valid = torch.arange(n_pad, device=self.device) < n  # padding rows stay zero
        self.src_group, self._made = _axes_group(mesh, src_axes)
        self.dst_group = mesh.get_group(dst_axis)
        # all_gather lists by group rank; the exchange wants column order.
        line = list(mesh.get_coordinate())
        line[d] = slice(None)
        self._column_order = [dist.get_group_rank(self.dst_group, int(r)) for r in mesh.mesh[tuple(line)].tolist()]
        self.full: torch.Tensor | None = None

    def __call__(self, x: torch.Tensor, dang: torch.Tensor, ops: ToHubOperands):
        p = self.placement
        y_c = tohub(x, ops, p.col_chunk)
        # -- FromHub: fold the hubs over the source axes
        dist.all_reduce(y_c, group=self.src_group)
        dm = (x * dang).sum().reshape(1)  # dangling mass, global after the sum
        dist.all_reduce(dm, group=self.src_group)
        # -- Exchange: the new attributes back to source-axis chunks
        parts = [torch.empty_like(y_c) for _ in range(p.C)]
        dist.all_gather(parts, y_c, group=self.dst_group)
        y_full = torch.cat([parts[g] for g in self._column_order])
        base = (1.0 - self.damping) / self.n
        new_full = base + self.damping * (y_full + dm / self.n)
        # padding rows stay zero so they never contribute mass
        new_full = torch.where(self._valid, new_full, torch.zeros_like(new_full))
        my = new_full[p.row_slice]
        diff = (my - x).abs().sum().reshape(1)
        dist.all_reduce(diff)
        self.full = new_full
        return my, diff / p.C

    def close(self) -> None:
        """Destroy the groups this step made (several source axes); the
        mesh's own groups stay."""
        for group in self._made:
            dist.destroy_process_group(group)
        self._made = []


def make_pagerank_step(
    mesh,
    n: int,
    n_pad: int,
    *,
    src_axes: tuple[str, ...] = ("data",),
    dst_axis: str = "model",
    damping: float = 0.85,
):
    """One PageRank iteration on the calling rank's mesh position.

    Returns ``(step, placement)``: a :class:`PageRankStep` and the
    :class:`Placement` of this rank's data (what the reference's
    ``PartitionSpec`` pair says for the whole grid)."""
    step = PageRankStep(mesh, n, n_pad, src_axes=src_axes, dst_axis=dst_axis, damping=damping)
    return step, step.placement


def distributed_pagerank(
    el: EdgeList | RankBlock,
    mesh,
    *,
    iters: int = 20,
    damping: float = 0.85,
    src_axes: tuple[str, ...] = ("data",),
    dst_axis: str = "model",
    tol: float = 0.0,
    step: PageRankStep | None = None,
):
    """Run PageRank on the mesh; every rank calls it and gets ``(ranks (n,), iterations)``.

    ``el`` is the whole edge list (each rank builds the grid and keeps its
    block) or this rank's :class:`RankBlock` (built once elsewhere, e.g.
    loaded with :meth:`RankBlock.load` at ``step.placement``). Each rank
    stages only its own block, on the mesh's device. ``step``: a
    :func:`make_pagerank_step` of this mesh to run (the caller closes it);
    without one, a step is made here and closed at the end.
    """
    R, C = _grid(mesh, src_axes, dst_axis)
    blocks = None if isinstance(el, RankBlock) else build_device_blocks(el, R, C)
    n, n_pad = (el.n, el.n_pad) if blocks is None else (blocks.n, blocks.n_pad)
    own = step is None
    if own:
        step, _ = make_pagerank_step(mesh, n, n_pad, src_axes=src_axes, dst_axis=dst_axis, damping=damping)
    elif (step.n, step.n_pad, step.damping) != (n, n_pad, damping):
        raise ValueError("the step was made for another graph or damping")
    blk = el if blocks is None else blocks.rank_block(step.placement.row, step.placement.col, el.out_degree)
    del blocks
    try:
        return _run(blk, step, R, C, n, n_pad, iters, tol)
    finally:
        if own:
            step.close()


def _run(blk: RankBlock, step: PageRankStep, R: int, C: int, n: int, n_pad: int, iters: int, tol: float):
    place = step.placement
    if (blk.R, blk.C, blk.row, blk.col) != (R, C, place.row, place.col):
        raise ValueError(f"block ({blk.row}, {blk.col}) of a {blk.R}x{blk.C} grid given to rank "
                         f"({place.row}, {place.col}) of a {R}x{C} grid")
    ops = tohub_operands(blk.src_local, blk.dst_local, blk.weight, step.device)
    x0 = np.zeros(n_pad, np.float32)
    x0[:n] = 1.0 / n
    x = torch.from_numpy(x0[place.row_slice]).to(step.device)
    dang = torch.from_numpy(np.ascontiguousarray(blk.dangling, np.float32)).to(step.device)
    it = 0
    for it in range(1, iters + 1):
        x, diff = step(x, dang, ops)
        if tol and float(diff) < tol:
            break
    full = step.full.cpu().numpy() if it else x0
    return full[:n], it


# ---------------------------------------------------------------------------
# Paper-scale graphs, as data (the dry run that uses them is ROADMAP A13 item 5).
# ---------------------------------------------------------------------------
GRAPH_SCALES = {
    # name: (n, m) from paper Table III
    "live-journal": (4_850_000, 69_000_000),
    "twitter": (41_700_000, 1_470_000_000),
    "yahoo-web": (720_000_000, 6_640_000_000),
}


# ---------------------------------------------------------------------------
# Ranks on one host: spawned processes over gloo
# ---------------------------------------------------------------------------
def _gloo_rank(rank: int, fn, world_size: int, tmp: str, args) -> None:
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world_size),
        rank=rank, world_size=world_size,
    )
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_gloo(fn, world_size: int, *args) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined by a
    gloo default group (a ``FileStore`` in a temporary directory, no port);
    returns each rank's result, in rank order. ``fn`` and ``args`` must
    pickle (``fn`` at module level). A rank that raises fails the call."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gloo-") as tmp:
        mp.start_processes(_gloo_rank, args=(fn, world_size, tmp, args), nprocs=world_size,
                           start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# Meshes of four ranks: (shape, axes, src_axes, tol).
SELFTEST_MESHES = (
    ((2, 2), ("data", "model"), ("data",), 0.0),
    ((2, 1, 2), ("pod", "data", "model"), ("pod", "data"), 0.0),
)


def run_meshes(rank: int, el: EdgeList, meshes, iters: int, device) -> list:
    """Every ``(shape, axes, src_axes, tol)`` of ``meshes`` in turn on this
    rank (the last axis is the destination axis): a list of ``(ranks, iterations)``.
    For :func:`spawn_gloo`; on the card every rank uses card ``rank % count``."""
    from repro_torch.launch.mesh import make_mesh

    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    out = []
    for shape, axes, src_axes, tol in meshes:
        mesh = make_mesh(shape, axes, device=device)
        out.append(distributed_pagerank(el, mesh, iters=iters, src_axes=src_axes, dst_axis=axes[-1], tol=tol))
    return out


def _selftest(device=None) -> None:
    from repro_torch.core import NXGraphEngine, PageRank, build_dsss
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.preprocess import degree_and_densify

    src, dst = rmat(9, edge_factor=8, seed=5)
    el = degree_and_densify(src, dst, drop_self_loops=True)
    results = spawn_gloo(run_meshes, 4, el, SELFTEST_MESHES, 12, device)
    ref = NXGraphEngine(build_dsss(el, 4), PageRank(), strategy="fused", device=device).run(12, tol=0.0)
    for m, (shape, _, src_axes, _) in enumerate(SELFTEST_MESHES):
        for rank, per_mesh in enumerate(results):
            ranks, iters = per_mesh[m]
            err = float(np.abs(ranks - ref.attrs).max())
            assert iters == 12 and err < 1e-6, (shape, rank, iters, err)
        print(f"selftest {shape} src_axes={src_axes}: n={el.n} m={el.m} iters={iters} max_err={err:.3e}")
    print("selftest OK")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="gloo ranks on meshes (2, 2) and (2, 1, 2) against the fused engine")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; cpu for a CPU selftest)")
    _selftest(ap.parse_args().device)
