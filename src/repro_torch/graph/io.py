"""Binary + text graph I/O (port of ``repro.graph.io``).

The paper stores the pre-shard and sub-shards as binary files; we keep the
same separation (raw edge list <-> preprocessed artifacts) but use npz
containers so a single file holds all sub-shard slices (avoids the paper's
OS open-file-handle limitation, §IV-D). For graphs that should never be
fully memory-resident, the sharded binary container lives in
:mod:`repro_torch.storage` — the chunked text reader here
(:func:`iter_text_edges`) is its build pipeline's front end.

Dtype contract: ``save_edges`` / ``save_edgelist`` persist arrays with the
caller's exact dtypes (``np.savez`` stores the dtype alongside the data;
inputs are only wrapped with ``np.asarray``, never cast), and the loaders
return them unchanged — asserted by ``tests/test_torch_graph_io.py``.
"""
from __future__ import annotations

import itertools
import os
from typing import Iterator

import numpy as np

from repro_torch.graph.preprocess import EdgeList

__all__ = [
    "save_edges",
    "load_edges",
    "iter_text_edges",
    "load_text_edges",
    "save_edgelist",
    "load_edgelist",
]


def save_edges(path: str, src: np.ndarray, dst: np.ndarray, weights=None) -> None:
    """Persist a raw edge list, preserving the caller's dtypes exactly."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"src": np.asarray(src), "dst": np.asarray(dst)}
    if weights is not None:
        payload["weights"] = np.asarray(weights)
    np.savez_compressed(path, **payload)


def load_edges(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    with np.load(path) as z:
        return z["src"], z["dst"], (z["weights"] if "weights" in z else None)


def _parse_lines(
    lines: list[str], comment: str, dtype, weights: bool
) -> tuple[np.ndarray, ...] | None:
    """Vectorized-ish parse of one batch of edge-list lines."""
    tokens: list[str] = []
    wtokens: list[str] = []
    for line in lines:
        line = line.strip()  # handles CRLF and stray whitespace
        if not line or line.startswith(comment):
            continue
        parts = line.split()
        if len(parts) < 2 or (weights and len(parts) < 3):
            raise ValueError(f"malformed edge-list line: {line!r}")
        tokens.append(parts[0])
        tokens.append(parts[1])
        if weights:
            wtokens.append(parts[2])
    if not tokens:
        return None
    ids = np.array(tokens, dtype=dtype).reshape(-1, 2)
    out: tuple[np.ndarray, ...] = (
        np.ascontiguousarray(ids[:, 0]),
        np.ascontiguousarray(ids[:, 1]),
    )
    if weights:
        out += (np.array(wtokens, dtype=np.float32),)
    return out


def iter_text_edges(
    path: str,
    *,
    comment: str = "#",
    dtype=np.int64,
    weights: bool = False,
    chunk_edges: int = 1 << 20,
) -> Iterator[tuple[np.ndarray, ...]]:
    """Stream a SNAP-style whitespace edge list in bounded chunks.

    Yields ``(src, dst)`` — or ``(src, dst, weights)`` with
    ``weights=True`` (third column, float32) — arrays of at most
    ``chunk_edges`` edges per chunk, so arbitrarily large text inputs
    never materialize. Comment lines (``comment`` prefix), blank lines
    and CRLF line endings are handled; extra trailing columns are
    ignored; ``dtype`` sets the id dtype. This is the front end of the
    external-memory ``.dsss`` build (``repro_torch.storage.build``), re-opened
    per pass.
    """
    with open(path, "r", newline=None) as f:
        while True:
            batch = list(itertools.islice(f, chunk_edges))
            if not batch:
                return
            parsed = _parse_lines(batch, comment, dtype, weights)
            if parsed is not None:
                yield parsed


def load_text_edges(
    path: str,
    comment: str = "#",
    *,
    dtype=np.int64,
    weights: bool = False,
    chunk_edges: int = 1 << 20,
) -> tuple[np.ndarray, ...]:
    """SNAP-style whitespace edge list (``src dst [weight]`` per line).

    A thin concatenation over :func:`iter_text_edges` (the streaming
    reader replaced the old pure-Python line loop); returns
    ``(src, dst)``, plus ``weights`` (float32) when ``weights=True``.
    """
    chunks = list(
        iter_text_edges(
            path, comment=comment, dtype=dtype, weights=weights,
            chunk_edges=chunk_edges,
        )
    )
    ncol = 3 if weights else 2
    if not chunks:
        empty = (np.zeros(0, dtype=dtype), np.zeros(0, dtype=dtype))
        return empty + ((np.zeros(0, np.float32),) if weights else ())
    return tuple(
        np.concatenate([c[k] for c in chunks]) for k in range(ncol)
    )


def save_edgelist(path: str, el: EdgeList) -> None:
    """Persist a preprocessed (degreed) edge list, dtypes preserved."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = dict(
        src=np.asarray(el.src),
        dst=np.asarray(el.dst),
        n=np.int64(el.n),
        out_degree=np.asarray(el.out_degree),
        in_degree=np.asarray(el.in_degree),
        id_to_index=np.asarray(el.id_to_index),
    )
    if el.weights is not None:
        payload["weights"] = np.asarray(el.weights)
    np.savez_compressed(path, **payload)


def load_edgelist(path: str) -> EdgeList:
    with np.load(path) as z:
        return EdgeList(
            src=z["src"],
            dst=z["dst"],
            n=int(z["n"]),
            out_degree=z["out_degree"],
            in_degree=z["in_degree"],
            id_to_index=z["id_to_index"],
            weights=(z["weights"] if "weights" in z else None),
        )
