"""Vertex programs — Initialize / Update / Output (port of ``repro.core.vertex_programs``).

A :class:`VertexProgram` factors the per-sub-shard update into the
semiring decomposition every strategy (SPU/DPU/MPU) shares:

  ``contribution = gather(src_attr, edge_weight, src_aux)``  (per edge)
  ``reduced      = ⊕ contributions grouped by destination``  (sum/min/max)
  ``new_attr     = apply(old_attr, reduced, aux, globals)``  (per vertex)

The semiring pieces are plain functions on tensors of any leading shape,
so the session applies them to all K queries at once. The lifecycle
methods (``init_attrs``/``init_active``/``make_aux``) build their tensors
on the CPU; the session moves them to its device. Each program keeps the
JAX package's dtype, and for the same inputs every piece gives the same
bits as the JAX program run eagerly.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any

import numpy as np
import torch

from repro_torch.core.identities import INF_DEPTH, reduce_identity

__all__ = [
    "VertexProgram",
    "PageRank",
    "BFS",
    "WCC",
    "SSSP",
    "MaxLabelForward",
    "ReachBackward",
    "INF_DEPTH",
    "reduce_identity",
]


def _check_root(g, root: int) -> None:
    if not 0 <= int(root) < g.n:
        raise ValueError(
            f"root {root} out of range for graph with n={g.n} vertices"
        )


def _int_tensor(values) -> torch.Tensor:
    return torch.tensor(np.array(values, dtype=np.int32))


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """Base class. Subclasses override gather/apply/changed as pure fns."""

    name: str = "base"
    reduce: str = "sum"  # "sum" | "min" | "max"
    dtype: Any = torch.float32
    monotone: bool = False
    attr_bytes: int = 4  # Ba in the paper's I/O model
    needs_dst_aux: bool = False  # gather also sees destination-side aux

    # -- lifecycle ----------------------------------------------------------
    def init_attrs(self, g, **kw) -> torch.Tensor:  # (n_pad,)
        raise NotImplementedError

    def init_active(self, g, **kw) -> np.ndarray:  # (P,) bool
        return np.ones(g.P, dtype=bool)

    def make_aux(self, g, **kw) -> dict[str, torch.Tensor]:
        """Per-vertex auxiliary tensors, gathered alongside attributes."""
        return {}

    def accepted_kwargs(self) -> frozenset:
        """The Initialize kwarg names this program accepts.

        The named parameters of ``init_attrs``/``init_active``/``make_aux``;
        their ``**kw`` catch-alls exist only so the three can share one
        kwargs dict.
        """
        names = set()
        for fn in (self.init_attrs, self.init_active, self.make_aux):
            for p in inspect.signature(fn).parameters.values():
                if p.name in ("self", "g") or p.kind in (
                    inspect.Parameter.VAR_KEYWORD,
                    inspect.Parameter.VAR_POSITIONAL,
                ):
                    continue
                names.add(p.name)
        return frozenset(names)

    def pre_iteration(self, attrs: torch.Tensor, aux) -> dict[str, torch.Tensor]:
        """Iteration-level scalars over the last axis (e.g. dangling mass)."""
        return {}

    # -- semiring pieces -------------------------------------------------------
    def gather(self, src_vals, weights, src_aux, dst_aux=None) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, old, reduced, aux, globals_) -> torch.Tensor:
        raise NotImplementedError

    def changed(self, old, new, tol) -> torch.Tensor:
        return torch.abs(new - old) > tol

    def output(self, attrs, g):
        return np.asarray(attrs[: g.n])


@dataclasses.dataclass(frozen=True)
class PageRank(VertexProgram):
    """Synchronous (personalized) PageRank with dangling-mass redistribution.

    ``p' = damping · (Aᵀ (p/outdeg) + dangling·r) + (1−damping)·r`` with
    ``r`` uniform ``1/n``, one-hot at ``personalize=v``, or the normalized
    ``reset_dist``.
    """

    name: str = "pagerank"
    reduce: str = "sum"
    dtype: Any = torch.float32
    monotone: bool = False
    attr_bytes: int = 8
    damping: float = 0.85

    def _reset(self, g, personalize, reset_dist) -> np.ndarray | None:
        """The (n_pad,) reset distribution, or None for uniform 1/n."""
        if personalize is not None and reset_dist is not None:
            raise ValueError(
                "pass either personalize (a vertex id) or reset_dist "
                "(an (n,) distribution), not both"
            )
        if personalize is not None:
            _check_root(g, personalize)
            r = np.zeros(g.n_pad, np.float32)
            r[int(personalize)] = 1.0
            return r
        if reset_dist is not None:
            rd = np.asarray(reset_dist, np.float64)
            if rd.shape != (g.n,):
                raise ValueError(
                    f"reset_dist must have shape ({g.n},), got {rd.shape}"
                )
            total = rd.sum()
            if rd.min() < 0 or not total > 0:
                raise ValueError(
                    "reset_dist must be non-negative with positive sum"
                )
            r = np.zeros(g.n_pad, np.float32)
            r[: g.n] = (rd / total).astype(np.float32)
            return r
        return None

    def init_attrs(self, g, personalize=None, reset_dist=None, **kw):
        r = self._reset(g, personalize, reset_dist)
        if r is None:
            a = torch.zeros(g.n_pad, dtype=self.dtype)
            a[: g.n] = 1.0 / g.n
            return a
        return torch.from_numpy(r).to(self.dtype)

    def make_aux(self, g, personalize=None, reset_dist=None, **kw):
        deg = np.asarray(g.out_degree, np.float32)
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(np.float32)
        dangling = ((deg == 0) & (np.arange(g.n_pad) < g.n)).astype(np.float32)
        aux = {
            "inv_out_degree": torch.from_numpy(inv),
            "dangling": torch.from_numpy(dangling),
            "inv_n": torch.tensor(1.0 / g.n, dtype=torch.float32),
        }
        r = self._reset(g, personalize, reset_dist)
        if r is not None:
            aux["reset"] = torch.from_numpy(r)
        return aux

    def pre_iteration(self, attrs, aux):
        return {"dangling_mass": torch.sum(attrs * aux["dangling"], dim=-1)}

    def gather(self, src_vals, weights, src_aux, dst_aux=None):
        contrib = src_vals * src_aux["inv_out_degree"]
        if weights is not None:
            contrib = contrib * weights
        return contrib

    def apply(self, old, reduced, aux, globals_):
        reset = aux["reset"] if "reset" in aux else aux["inv_n"]
        base = (1.0 - self.damping) * reset
        return base + self.damping * (
            reduced + globals_["dangling_mass"] * reset
        )

    def output(self, attrs, g):
        return np.asarray(attrs[: g.n], np.float64)


@dataclasses.dataclass(frozen=True)
class BFS(VertexProgram):
    """Min-depth propagation from a root."""

    name: str = "bfs"
    reduce: str = "min"
    dtype: Any = torch.int32
    monotone: bool = True
    attr_bytes: int = 4

    def init_attrs(self, g, root: int = 0, **kw):
        _check_root(g, root)
        a = torch.full((g.n_pad,), INF_DEPTH, dtype=self.dtype)
        a[root] = 0
        return a

    def init_active(self, g, root: int = 0, **kw):
        _check_root(g, root)
        act = np.zeros(g.P, dtype=bool)
        act[root // g.interval_size] = True
        return act

    def gather(self, src_vals, weights, src_aux, dst_aux=None):
        # depth+1, saturating so INF stays INF.
        return torch.where(src_vals >= INF_DEPTH, INF_DEPTH, src_vals + 1)

    def apply(self, old, reduced, aux, globals_):
        return torch.minimum(old, reduced)

    def changed(self, old, new, tol):
        return new != old

    def output(self, attrs, g):
        """Max finite depth (spanning-tree depth)."""
        a = np.asarray(attrs[: g.n])
        finite = a[a < INF_DEPTH]
        return int(finite.max()) if finite.size else 0


@dataclasses.dataclass(frozen=True)
class WCC(VertexProgram):
    """Weakly connected components: min-label propagation (symmetrized graph)."""

    name: str = "wcc"
    reduce: str = "min"
    dtype: Any = torch.int32
    monotone: bool = True
    attr_bytes: int = 4

    def init_attrs(self, g, **kw):
        a = torch.full((g.n_pad,), INF_DEPTH, dtype=self.dtype)
        a[: g.n] = torch.arange(g.n, dtype=self.dtype)
        return a

    def gather(self, src_vals, weights, src_aux, dst_aux=None):
        return src_vals

    def apply(self, old, reduced, aux, globals_):
        return torch.minimum(old, reduced)

    def changed(self, old, new, tol):
        return new != old


@dataclasses.dataclass(frozen=True)
class SSSP(VertexProgram):
    """Single-source shortest path (weighted Bellman-Ford flavour)."""

    name: str = "sssp"
    reduce: str = "min"
    dtype: Any = torch.float32
    monotone: bool = True
    attr_bytes: int = 4

    def init_attrs(self, g, root: int = 0, **kw):
        _check_root(g, root)
        a = torch.full((g.n_pad,), float("inf"), dtype=self.dtype)
        a[root] = 0.0
        return a

    def init_active(self, g, root: int = 0, **kw):
        _check_root(g, root)
        act = np.zeros(g.P, dtype=bool)
        act[root // g.interval_size] = True
        return act

    def gather(self, src_vals, weights, src_aux, dst_aux=None):
        w = weights if weights is not None else 1.0
        return src_vals + w

    def apply(self, old, reduced, aux, globals_):
        return torch.minimum(old, reduced)

    def changed(self, old, new, tol):
        return new < old


@dataclasses.dataclass(frozen=True)
class MaxLabelForward(VertexProgram):
    """Forward max-label propagation over the masked subgraph (SCC)."""

    name: str = "scc_fwd"
    reduce: str = "max"
    dtype: Any = torch.int32
    monotone: bool = True
    attr_bytes: int = 4

    def init_attrs(self, g, labels=None, **kw):
        if labels is not None:
            return _int_tensor(labels).to(self.dtype)
        a = torch.full((g.n_pad,), -INF_DEPTH, dtype=self.dtype)
        a[: g.n] = torch.arange(g.n, dtype=self.dtype)
        return a

    def make_aux(self, g, mask=None, **kw):
        if mask is None:
            mask = np.ones(g.n_pad, np.int32)
        return {"mask": _int_tensor(mask)}

    def gather(self, src_vals, weights, src_aux, dst_aux=None):
        return torch.where(src_aux["mask"] > 0, src_vals, -INF_DEPTH)

    def apply(self, old, reduced, aux, globals_):
        new = torch.maximum(old, reduced)
        return torch.where(aux["mask"] > 0, new, old)

    def changed(self, old, new, tol):
        return new != old


@dataclasses.dataclass(frozen=True)
class ReachBackward(VertexProgram):
    """Backward reachability within a colour class (run on the transpose).

    attr is 1 for vertices known to reach their colour root, else 0; a
    vertex inherits reachability from an out-neighbour of the same colour.
    """

    name: str = "scc_bwd"
    reduce: str = "max"
    dtype: Any = torch.int32
    monotone: bool = True
    attr_bytes: int = 4
    needs_dst_aux: bool = True

    def init_attrs(self, g, reach=None, **kw):
        if reach is None:
            raise ValueError("ReachBackward needs reach= (seed the colour roots)")
        return _int_tensor(reach).to(self.dtype)

    def make_aux(self, g, mask=None, colors=None, **kw):
        if colors is None:
            raise ValueError("ReachBackward needs colors=")
        if mask is None:
            mask = np.ones(g.n_pad, np.int32)
        return {"mask": _int_tensor(mask), "color": _int_tensor(colors)}

    def gather(self, src_vals, weights, src_aux, dst_aux=None):
        live = (src_aux["mask"] > 0) & (src_vals > 0)
        same_color = src_aux["color"] == dst_aux["color"]
        return torch.where(live & same_color, 1, 0).to(self.dtype)

    def apply(self, old, reduced, aux, globals_):
        hit = (reduced > 0) & (aux["mask"] > 0)
        return torch.where(hit, torch.ones_like(old), old)

    def changed(self, old, new, tol):
        return new != old
