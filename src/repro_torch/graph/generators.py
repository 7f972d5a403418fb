"""Synthetic graph generators (numpy; port of ``repro.graph.generators``).

Each generator makes the same numpy RNG calls in the same order as the
JAX package's, so one seed gives the same ``(src, dst)`` edges in both.
All return int64 numpy arrays of raw indices (possibly with duplicates),
the input of :func:`repro_torch.graph.preprocess.degree_and_densify`.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "rmat",
    "zipf",
    "erdos_renyi",
    "random_geometric",
    "ring",
    "star",
    "complete",
    "paper_dataset",
    "paper_dataset_names",
]


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT power-law generator (Chakrabarti et al.), Graph500 defaults.

    ``2**scale`` vertices, ``edge_factor * 2**scale`` directed edges.
    """
    m = edge_factor << scale
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    if 1.0 - a - b - c < -1e-9:
        raise ValueError("RMAT probabilities must sum to <= 1")
    # One quadrant draw per address bit: thresholds [a, a+b, a+b+c, 1].
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    return src, dst


def zipf(
    n: int, m: int, alpha: float = 1.8, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Zipf in-degree graph: dst ~ rank^(-alpha), src uniform.

    Destination ids are a random permutation of the ranks, so hubs are
    spread over the intervals.
    """
    if n < 1:
        raise ValueError("zipf needs n >= 1")
    rng = np.random.default_rng(seed)
    p = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    p /= p.sum()
    perm = rng.permutation(n)
    dst = perm[rng.choice(n, size=m, p=p)]
    src = rng.integers(0, n, size=m, dtype=np.int64)
    return src.astype(np.int64), dst.astype(np.int64)


def erdos_renyi(n: int, m: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """G(n, m) uniform random directed graph (with possible duplicates)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return src, dst


def random_geometric(
    n: int, k: int = 6, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Stand-in for the paper's delaunay_nXX meshes: each point joined to its
    ~k neighbours in index order within a grid bucket of the unit square.

    Planar-ish, bounded near-uniform degree, like the Delaunay graphs the
    paper uses. Returns a symmetric (both directions) edge list.
    """
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    g = max(1, int(np.sqrt(n / 4)))
    cell = np.minimum((pts * g).astype(np.int64), g - 1)
    cell_id = cell[:, 0] * g + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    sorted_ids = cell_id[order]
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    # Within each bucket, join points (in index order) in a small window.
    starts = np.searchsorted(sorted_ids, np.arange(g * g), side="left")
    ends = np.searchsorted(sorted_ids, np.arange(g * g), side="right")
    for b in range(g * g):
        idx = order[starts[b] : ends[b]]
        if len(idx) < 2:
            continue
        for off in range(1, min(k // 2 + 1, len(idx))):
            srcs.append(idx[:-off])
            dsts.append(idx[off:])
    # A chain through one point of each non-empty bucket connects the mesh.
    bucket_rep = order[starts[starts < ends]] if np.any(starts < ends) else order[:1]
    if len(bucket_rep) > 1:
        srcs.append(bucket_rep[:-1])
        dsts.append(bucket_rep[1:])
    src = np.concatenate(srcs) if srcs else np.zeros(0, dtype=np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, dtype=np.int64)
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def ring(n: int) -> tuple[np.ndarray, np.ndarray]:
    v = np.arange(n, dtype=np.int64)
    return v, (v + 1) % n


def star(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Hub vertex 0 -> all others (worst case for destination skew)."""
    leaves = np.arange(1, n, dtype=np.int64)
    return np.full(n - 1, 0, dtype=np.int64), leaves


def complete(n: int) -> tuple[np.ndarray, np.ndarray]:
    s, t = np.meshgrid(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64))
    mask = s != t
    return s[mask].ravel(), t[mask].ravel()


# Stand-ins for the paper's benchmark graphs, generated offline: scaled
# down, skew-matched. name: (generator, kwargs, paper n, paper m).
_PAPER_DATASETS = {
    "live-journal": ("rmat", dict(scale=15, edge_factor=14, seed=1), 4.85e6, 69.0e6),
    "twitter": ("rmat", dict(scale=16, edge_factor=22, seed=2), 41.7e6, 1.47e9),
    "yahoo-web": ("rmat", dict(scale=17, edge_factor=9, seed=3), 720e6, 6.64e9),
    "delaunay_n15": ("geo", dict(n=1 << 15, seed=20), 1.05e6, 6.29e6),
    "delaunay_n16": ("geo", dict(n=1 << 16, seed=21), 2.10e6, 12.6e6),
    "delaunay_n17": ("geo", dict(n=1 << 17, seed=22), 4.19e6, 25.2e6),
    "delaunay_n18": ("geo", dict(n=1 << 18, seed=23), 8.39e6, 50.3e6),
    "delaunay_n19": ("geo", dict(n=1 << 19, seed=24), 16.8e6, 101e6),
}


def paper_dataset(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Scaled-down, skew-matched stand-in for a paper benchmark graph."""
    kind, kwargs, _, _ = _PAPER_DATASETS[name]
    if kind == "rmat":
        return rmat(**kwargs)
    return random_geometric(**kwargs)


def paper_dataset_names() -> list[str]:
    return list(_PAPER_DATASETS)
