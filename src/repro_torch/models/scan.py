"""A parallel prefix scan with the fold tree of JAX's ``lax.associative_scan``.

PyTorch has no public associative scan. This is the odd/even recursion of
``jax.lax.associative_scan`` written as plain tensor slicing: combine
adjacent pairs, scan the half-length result recursively, combine each odd
prefix with the next even element, and interleave. It applies ``fn`` to the
same operands in the same tree as the reference, so a recurrence folds its
terms in the same order (the Mamba and RG-LRU scans of
``models/ssm.py`` and ``models/rglru.py``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["associative_scan"]


def _slice(t: torch.Tensor, axis: int, start: int, stop: int | None, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * t.ndim
    idx[axis] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along ``axis``; ``a`` may be one longer."""
    shape = list(a.shape)
    shape[axis] = a.shape[axis] + b.shape[axis]
    out = a.new_empty(shape)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(
    fn: Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], Sequence[torch.Tensor]],
    elems: Sequence[torch.Tensor],
    axis: int = 0,
) -> list[torch.Tensor]:
    """Inclusive scan of the tuple ``elems`` along ``axis`` under the
    associative ``fn(earlier, later)``, which maps two tuples of tensors
    to one."""
    elems = list(elems)
    axis = axis % elems[0].ndim
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn([_slice(e, axis, 0, n - 1, 2) for e in elems],
                 [_slice(e, axis, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([_slice(e, axis, 0, -1) for e in odd], [_slice(e, axis, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_slice(e, axis, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis) for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]
