"""The ⊕-identities of the reduce monoids (port of ``repro.core.identities``).

Three families, each with one consumer, and they differ on purpose:

* :func:`reduce_identity` — the algorithmic identity folded into
  accumulators and masked-off contributions. For integer min/max it is
  ``±INF_DEPTH`` (2³⁰), the programs' "unreached" sentinel.
* :func:`padding_identity` / :func:`padding_identity_value` — the
  segment-op-compatible padding value (±inf for floats, the integer
  dtype's ``±iinfo.max`` for ints).
* :func:`segment_fill_value` — what an empty segment of a segment
  reduction holds, and so the start value of a run partial in the tile
  sweep. For int max it is ``iinfo.min``, one below ``-iinfo.max``.
"""
from __future__ import annotations

import torch

__all__ = [
    "INF_DEPTH",
    "reduce_identity",
    "padding_identity",
    "padding_identity_value",
    "segment_fill_value",
]

# Saturating "infinite depth" of integer min/max attributes; small enough
# that ``x + 1`` never overflows int32.
INF_DEPTH = 2**30


def _is_float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point


def reduce_identity(reduce: str, dtype: torch.dtype) -> torch.Tensor:
    """Algorithmic ⊕-identity (engine accumulators, masked contributions)."""
    if reduce == "sum":
        return torch.zeros((), dtype=dtype)
    if reduce == "min":
        v = float("inf") if _is_float(dtype) else INF_DEPTH
        return torch.tensor(v, dtype=dtype)
    if reduce == "max":
        v = float("-inf") if _is_float(dtype) else -INF_DEPTH
        return torch.tensor(v, dtype=dtype)
    raise ValueError(f"unknown reduce {reduce!r}")


def padding_identity(reduce: str, dtype: torch.dtype) -> torch.Tensor:
    """Segment-op-compatible identity, as a 0-d tensor."""
    return torch.tensor(padding_identity_value(reduce, dtype), dtype=dtype)


def padding_identity_value(reduce: str, dtype: torch.dtype) -> float | int:
    """Python-scalar variant of :func:`padding_identity`."""
    if reduce == "sum":
        return 0.0
    if _is_float(dtype):
        big: float | int = float("inf")
    else:
        big = int(torch.iinfo(dtype).max)
    if reduce == "min":
        return big
    if reduce == "max":
        return -big
    raise ValueError(f"unknown reduce {reduce!r}")


def segment_fill_value(reduce: str, dtype: torch.dtype) -> torch.Tensor:
    """The empty-segment fill: the start value of a run partial."""
    if reduce == "sum":
        return torch.zeros((), dtype=dtype)
    if _is_float(dtype):
        lo, hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max
    if reduce == "min":
        return torch.tensor(hi, dtype=dtype)
    if reduce == "max":
        return torch.tensor(lo, dtype=dtype)
    raise ValueError(f"unknown reduce {reduce!r}")
