"""Hand-made tile layouts that reach every branch of kernel B1.

Kernel B1 (``kernels/csrc/packed_sweep.cu``) folds runs in chunks, long
runs in windows with a carried value, and checks activity and the tile
selection once per chunk. The layouts here put run ends on both sides of
each chunk and window edge, hold a run of 20,000 edges, feed −0.0 and NaN
contribs to the float sum and to SSSP's min, weight inactive intervals'
edges with negative and infinite numbers, leave out the tile that holds
the longest run, batch K = 8 queries with stacked aux, build a
``src_sorted`` graph whose runs are reached through ``perm``, and drop the
weights (unweighted long runs take the kernel's cp.async ring).

``CASES`` names each case; :func:`case` gives its layout and its inputs for
one program, made with numpy from a seed, so the CPU tests (through an
emulation of the kernel), the card tests and ``chip_smoke.py`` hold the
kernel against ``packed_sweep_update_ref`` on the same data.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.dsss import PackedSweep, build_dsss
from repro_torch.core.identities import INF_DEPTH
from repro_torch.graph.preprocess import degree_and_densify

__all__ = ["CASES", "PROGRAMS", "case", "hand_packed"]

# The programs of the kernel's table, by the name their inputs are made for.
PROGRAMS = ("pagerank", "bfs", "wcc", "sssp", "maxlabel", "reach")

ISZ = 1024  # vertices per interval of the hand-made layouts
P = 4

# name: (layout, weighted, K, stacked aux, rows active, selection, special values)
CASES = {
    "long_runs": ("long", True, 1, False, "all", None, False),
    "long_runs_unweighted": ("long", False, 1, False, "all", None, False),
    "long_runs_skip_longest": ("long", True, 3, False, "all", "skip_longest", False),
    "window_edges": ("edges", True, 1, False, "all", None, False),
    "window_edges_unweighted": ("edges", False, 1, False, "partial", None, False),
    "window_edges_k8_stacked": ("edges", True, 8, True, "partial", "half", False),
    "neg_zero_nan": ("edges", True, 1, False, "all", None, True),
    "inactive_inf_weights": ("edges", True, 1, False, "partial", None, False),
    "src_sorted_build": ("src_sorted", True, 1, False, "all", None, False),
    "src_sorted_build_k8": ("src_sorted", True, 8, True, "partial", "half", False),
}


def hand_packed(tiles: list, n_pad: int, isz: int) -> PackedSweep:
    """A destination-sorted :class:`PackedSweep` from explicit runs.

    ``tiles`` is a list of tiles, each a list of runs ``(dst, src, w)``:
    the destination, the sources (one interval) and the weights of the
    run's edges in edge order.
    """
    T = 1 << int(np.ceil(np.log2(max(8, max(sum(len(s) for _, s, _ in t) for t in tiles)))))
    NT = len(tiles)
    src = np.zeros((NT, T), np.int32)
    dst = np.zeros((NT, T), np.int32)
    run_local = np.zeros((NT, T), np.int32)
    run_dst = np.full((NT, T), n_pad, np.int32)
    weights = np.zeros((NT, T), np.float32)
    e_valid = np.zeros(NT, np.int32)
    u = np.zeros(NT, np.int32)
    for t, runs in enumerate(tiles):
        e = 0
        for slot, (d, s, w) in enumerate(runs):
            src[t, e:e + len(s)] = s
            dst[t, e:e + len(s)] = d
            run_local[t, e:e + len(s)] = slot
            weights[t, e:e + len(s)] = w
            run_dst[t, slot] = d
            e += len(s)
        e_valid[t], u[t] = e, len(runs)
    return PackedSweep(
        mode="subshard", m=int(e_valid.sum()), n_pad=n_pad, tile_edges=T,
        src=src, dst=dst, run_local=run_local, run_dst=run_dst, weights=weights,
        e_valid=e_valid, src_interval=src[:, 0] // isz, dst_interval=dst[:, 0] // isz,
        base_slot=np.concatenate([[0], np.cumsum(u)[:-1]]).astype(np.int64), u=u,
        row_offset=np.concatenate([[0], np.cumsum(e_valid)[:-1]]).astype(np.int64),
        interval_size=isz,
    )


def _run(rng, d: int, iv: int, n: int, w_kind: str) -> tuple:
    s = (iv * ISZ + rng.integers(0, ISZ, n)).astype(np.int32)
    w = (rng.random(n) + 0.01).astype(np.float32)
    if w_kind == "wild":  # negative, -0.0 and infinite weights
        w = np.where(rng.random(n) < 0.5, -w, w).astype(np.float32)
        pick = rng.random(n)
        w[pick < 0.1] = -np.inf
        w[(pick >= 0.1) & (pick < 0.2)] = np.inf
        w[(pick >= 0.2) & (pick < 0.3)] = -0.0
    return d, s, w


def _layout(kind: str, rng, w_kind: str):
    n_pad = P * ISZ
    if kind == "long":
        # The longest run (20,000 edges, 40 windows) sits in tile 1 between
        # short runs; 513 is just long (one edge into a second window), 1,025
        # crosses two window edges, 900 one; 257 and 256 are short.
        tiles = [
            [_run(rng, 5, 0, 3, w_kind), _run(rng, 9, 0, 513, w_kind), _run(rng, 9, 1, 1025, w_kind),
             _run(rng, 11, 1, 40, w_kind)],
            [_run(rng, 2, 0, 7, w_kind), _run(rng, 7, 1, 20_000, w_kind), _run(rng, 8, 1, 1, w_kind),
             _run(rng, 9, 2, 257, w_kind), _run(rng, 12, 3, 256, w_kind)],
            [_run(rng, 7, 2, 900, w_kind), _run(rng, 7, 3, 5, w_kind)],
        ]
        return hand_packed(tiles, n_pad, ISZ)
    # Run lengths on both sides of 32 (a lane's stride), 256, 512 (LONG_RUN:
    # a window, and the most a short chunk holds) and 1024, the interval
    # changing every few runs and destinations repeating across tiles.
    lens = [31, 32, 33, 511, 512, 513, 255, 256, 257, 1, 1, 2, 31, 32, 33, 63, 64, 65,
            127, 128, 129, 300, 1, 95, 160, 200, 3, 250, 6, 1024, 1025, 17]
    tiles = []
    for t in range(3):
        runs = []
        for i, n in enumerate(lens[t:] + lens[:t]):
            runs.append(_run(rng, int(rng.integers(0, 40)), (i // 3 + t) % P, n, w_kind))
        tiles.append(runs)
    return hand_packed(tiles, n_pad, ISZ)


def _src_sorted_graph():
    """A graph with hub destinations, built src_sorted (runs through perm)."""
    rng = np.random.default_rng(17)
    n = 4096
    hubs = rng.choice(n, 6, replace=False)
    src = [rng.integers(0, n, 12_000)]
    dst = [rng.integers(0, n, 12_000)]
    for h in hubs:
        src.append(rng.choice(n, 1500, replace=False))
        dst.append(np.full(1500, h))
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = (rng.random(src.shape[0]) + 0.01).astype(np.float32)
    return build_dsss(degree_and_densify(src, dst, w, drop_self_loops=True), 2, src_sorted=True)


def _values(name: str, K: int, n_pad: int, rng, special: bool):
    """attrs and acc of one program, (K, n_pad) numpy."""
    if name in ("pagerank", "sssp"):
        attrs = (rng.random((K, n_pad)) * 3).astype(np.float32)
        acc = (rng.random((K, n_pad)) * 2 + (1 if name == "sssp" else 0)).astype(np.float32)
        if name == "sssp":
            attrs = attrs + 1  # no +0.0 contribs: a ±0 tie would be the atomics' choice
            attrs[rng.random((K, n_pad)) < 0.3] = np.inf
        if special:
            pick = rng.random((K, n_pad))
            attrs[pick < 0.1] = -0.0
            attrs[(pick >= 0.1) & (pick < 0.13)] = np.nan
            if name == "pagerank":
                attrs[(pick >= 0.13) & (pick < 0.16)] = np.inf
        return attrs, acc
    if name == "reach":
        return (rng.integers(0, 2, (K, n_pad)).astype(np.int32),
                rng.integers(0, 2, (K, n_pad)).astype(np.int32))
    attrs = rng.integers(-50, 50, (K, n_pad)).astype(np.int32)
    attrs[rng.random((K, n_pad)) < 0.2] = INF_DEPTH
    return attrs, rng.integers(-60, 60, (K, n_pad)).astype(np.int32)


def _aux(name: str, K: int, n_pad: int, stacked: bool, rng, special: bool) -> dict:
    shape = (K, n_pad) if stacked else (n_pad,)
    if name == "pagerank":
        inv = (1.0 / rng.integers(1, 50, shape)).astype(np.float32)
        inv[rng.random(shape) < 0.1] = 0.0
        if special:
            inv[rng.random(shape) < 0.05] = -0.0
        return {"inv_out_degree": inv}
    if name == "maxlabel":
        return {"mask": (rng.random(shape) < 0.8).astype(np.int32)}
    if name == "reach":
        return {"mask": (rng.random(shape) < 0.8).astype(np.int32),
                "color": rng.integers(0, 3, shape).astype(np.int32)}
    return {}


def case(name: str, program: str) -> dict:
    """One case's layout and numpy inputs for ``program`` (a name of PROGRAMS).

    Returns ``packed``, ``weighted``, ``K``, ``stacked``, ``attrs``,
    ``acc`` ``(K, n_pad)``, ``aux`` (numpy leaves), ``row`` ``(P,)`` bool
    and ``idx`` (ascending selected tiles, or None).
    """
    kind, weighted, K, stacked, rows, select, special = CASES[name]
    rng = np.random.default_rng(zlib.crc32(f"{name}/{program}".encode()))
    w_kind = "wild" if name == "inactive_inf_weights" or special else "plain"
    if kind == "src_sorted":
        packed = _src_sorted_graph().packed_sweep("subshard")
    else:
        packed = _layout(kind, np.random.default_rng(zlib.crc32(name.encode())), w_kind)
    if not weighted:
        packed = dataclasses.replace(packed, weights=None)
    n_pad = packed.n_pad
    nP = n_pad // packed.interval_size
    attrs, acc = _values(program, K, n_pad, rng, special)
    if special and program == "sssp":
        acc = acc + 1  # above every -0.0 partial
    row = np.ones(nP, bool)
    if rows == "partial":
        row[1::2] = False
    idx = None
    if select == "half":
        idx = np.flatnonzero(rng.random(packed.num_tiles) < 0.6).astype(np.int32)
    elif select == "skip_longest":
        longest = int(np.argmax([np.bincount(r[:e]).max() for r, e in zip(packed.run_local, packed.e_valid)]))
        idx = np.setdiff1d(np.arange(packed.num_tiles), [longest]).astype(np.int32)
    return {
        "packed": packed, "weighted": packed.weights is not None, "K": K, "stacked": stacked,
        "attrs": attrs, "acc": acc, "aux": _aux(program, K, n_pad, stacked, rng, special),
        "row": row, "idx": idx,
    }
