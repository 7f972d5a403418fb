"""Synthetic graph generators (numpy; port of ``repro.graph.generators``).

Each generator makes the same numpy RNG calls in the same order as the
JAX package's, so one seed gives the same ``(src, dst)`` edges in both.
All return int64 numpy arrays of raw indices (possibly with duplicates),
the input of :func:`repro_torch.graph.preprocess.degree_and_densify`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rmat", "zipf", "erdos_renyi", "ring", "star"]


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


def ring(n: int) -> tuple[np.ndarray, np.ndarray]:
    v = np.arange(n, dtype=np.int64)
    return v, (v + 1) % n


def star(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Hub vertex 0 -> all others (worst case for destination skew)."""
    leaves = np.arange(1, n, dtype=np.int64)
    return np.full(n - 1, 0, dtype=np.int64), leaves
