"""Degreeing: raw sparse indices -> dense ids (port of ``repro.graph.preprocess``).

Host-side numpy, array-for-array what the JAX package produces.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EdgeList", "degree_and_densify", "merge_unique_ids", "map_to_dense"]


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Pre-shard: dense-id edge list plus degree metadata.

    ``src``/``dst`` are int32 dense ids in ``[0, n)``, deduplicated;
    ``out_degree``/``in_degree`` int32 ``(n,)``; ``id_to_index`` the int64
    reverse mapping; ``weights`` optional float32 per edge.
    """

    src: np.ndarray
    dst: np.ndarray
    n: int
    out_degree: np.ndarray
    in_degree: np.ndarray
    id_to_index: np.ndarray
    weights: np.ndarray | None = None

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def index_to_id(self, indices: np.ndarray) -> np.ndarray:
        """Raw index -> dense id (vectorised binary search on the mapping)."""
        pos = np.searchsorted(self.id_to_index, indices)
        pos = np.clip(pos, 0, len(self.id_to_index) - 1)
        ok = self.id_to_index[pos] == indices
        if not np.all(ok):
            raise KeyError("index not present in graph (isolated or unknown)")
        return pos.astype(np.int32)

    def reversed(self) -> "EdgeList":
        """The transpose graph (SCC's backward phase)."""
        return EdgeList(
            src=self.dst,
            dst=self.src,
            n=self.n,
            out_degree=self.in_degree,
            in_degree=self.out_degree,
            id_to_index=self.id_to_index,
            weights=self.weights,
        )

    def symmetrized(self) -> "EdgeList":
        """Undirected view: both edge directions, deduplicated (for WCC)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        key = src.astype(np.int64) * self.n + dst
        if self.weights is None:
            # Sort and drop repeats: np.unique without return_* takes a hash
            # table from NumPy 2.3 on, which is far slower than a sort at
            # 10^8 keys.
            key = np.sort(key)
            first = np.ones(key.shape, dtype=bool)
            first[1:] = key[1:] != key[:-1]
            uniq = key[first]
            w2 = None
        else:
            w = np.concatenate([self.weights] * 2)
            uniq, keep = np.unique(key, return_index=True)
            w2 = w[keep]
        src2 = (uniq // self.n).astype(np.int32)
        dst2 = (uniq % self.n).astype(np.int32)
        # The symmetrized set is closed under transposition: out == in.
        deg = np.bincount(src2, minlength=self.n).astype(np.int32)
        return EdgeList(
            src=src2,
            dst=dst2,
            n=self.n,
            out_degree=deg,
            in_degree=deg,
            id_to_index=self.id_to_index,
            weights=w2,
        )


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by a sort and a drop of repeats.

    ``np.unique`` without ``return_*`` takes a hash table from NumPy 2.3 on,
    which is far slower than a sort on large arrays; the result is the same.
    """
    a = np.sort(a)
    if a.size:
        keep = np.ones(a.shape, dtype=bool)
        keep[1:] = a[1:] != a[:-1]
        a = a[keep]
    return a


def merge_unique_ids(acc: np.ndarray, *chunks: np.ndarray) -> np.ndarray:
    """Fold edge-chunk endpoints into a sorted unique id array.

    The chunked (external-memory) counterpart of the unique pass over all
    endpoints in :func:`degree_and_densify`: called per streamed chunk, it
    accumulates exactly the dense-id mapping of the one-shot pass, with
    peak memory O(vertices + chunk).
    """
    parts = [np.asarray(acc, dtype=np.int64).reshape(-1)]
    parts += [np.asarray(c, dtype=np.int64).reshape(-1) for c in chunks]
    return _sorted_unique(np.concatenate(parts))


def map_to_dense(id_to_index: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Raw indices -> dense ids against a sorted mapping (validated).

    :meth:`EdgeList.index_to_id` as a free function over an explicit
    mapping, so the streaming build can map chunks before the
    :class:`EdgeList` exists.
    """
    values = np.asarray(values, dtype=np.int64)
    pos = np.searchsorted(id_to_index, values)
    pos = np.clip(pos, 0, max(len(id_to_index) - 1, 0))
    if len(id_to_index) == 0 or not np.all(id_to_index[pos] == values):
        raise KeyError("index not present in the accumulated id mapping")
    return pos.astype(np.int32)


def degree_and_densify(
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray | None = None,
    *,
    drop_self_loops: bool = False,
    dedup: bool = True,
) -> EdgeList:
    """The degreeing pass: raw sparse indices -> dense contiguous ids.

    Vertices with no incident edge are eliminated.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if weights is not None:
            weights = weights[keep]
    id_to_index, inverse = np.unique(
        np.concatenate([src, dst]), return_inverse=True
    )
    m = src.shape[0]
    src_id = inverse[:m].astype(np.int32)
    dst_id = inverse[m:].astype(np.int32)
    n = int(id_to_index.shape[0])
    if dedup:
        key = src_id.astype(np.int64) * n + dst_id
        _, keep_idx = np.unique(key, return_index=True)
        src_id, dst_id = src_id[keep_idx], dst_id[keep_idx]
        if weights is not None:
            weights = weights[keep_idx]
    return EdgeList(
        src=src_id,
        dst=dst_id,
        n=n,
        out_degree=np.bincount(src_id, minlength=n).astype(np.int32),
        in_degree=np.bincount(dst_id, minlength=n).astype(np.int32),
        id_to_index=id_to_index,
        weights=None if weights is None else weights.astype(np.float32),
    )
