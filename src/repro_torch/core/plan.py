"""Execution plans — frozen, hashable job descriptions (port of ``repro.core.plan``).

An :class:`ExecutionPlan` says what to run: a vertex program, a strategy,
iteration limits, the residency/execution/activity axes and the program's
Initialize kwargs. Array-valued kwargs (numpy arrays or tensors) are
frozen into content-hashed :class:`FrozenArray` values, so plans stay
hashable with value semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.vertex_programs import VertexProgram
from repro_torch.obs.trace import TraceSpec
from repro_torch.reliability.checkpoint import CheckpointSpec

__all__ = ["CheckpointSpec", "ExecutionPlan", "FrozenArray", "TraceSpec"]


@dataclasses.dataclass(frozen=True)
class FrozenArray:
    """An immutable, content-hashed snapshot of an array-valued kwarg."""

    data: bytes
    shape: tuple[int, ...]
    dtype: str

    @classmethod
    def freeze(cls, value) -> "FrozenArray":
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value)
        return cls(data=arr.tobytes(), shape=arr.shape, dtype=str(arr.dtype))

    def thaw(self) -> np.ndarray:
        return np.frombuffer(self.data, dtype=np.dtype(self.dtype)).reshape(
            self.shape
        )


def _freeze_value(v):
    if isinstance(v, FrozenArray):
        return v
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return FrozenArray.freeze(v)
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_value(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _thaw_value(v):
    if isinstance(v, FrozenArray):
        return v.thaw()
    if isinstance(v, tuple):
        return tuple(_thaw_value(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One job against a staged graph.

    Args:
      program: the vertex program (frozen dataclass — hashable).
      strategy: "auto" | "spu" | "dpu" | "mpu" | "fused" | a registered
        custom strategy. "auto" resolves against the session's memory
        budget (the paper's adaptive choice).
      max_iters: update-sweep budget.
      tol: convergence tolerance handed to ``program.changed``.
      residency: per-plan override of the session's residency axis
        (``None`` inherits).
      execution: per-plan override of the session's execution axis
        (``None`` inherits).
      activity: ``"auto"`` lets monotone programs skip tiles whose source
        intervals did not change; ``"off"`` forces full sweeps. Results
        are bit-identical either way.
      checkpoint: sweep-level checkpoint/resume
        (:class:`repro_torch.reliability.CheckpointSpec`): ``None`` takes
        no snapshots; otherwise the session atomically snapshots the
        vertex state, activity bitmaps and cumulative meters to
        ``checkpoint.directory`` every ``checkpoint.every`` sweeps
        (keep-N pruned), and ``session.run(plan, resume_from=...)``
        restores one and continues, bit-identical to an uninterrupted
        run. Part of :meth:`batch_key`.
      trace: a :class:`repro_torch.obs.TraceSpec` turns the span recorder
        on for this run (staging, each sweep with its byte deltas, the
        run) and, with ``trace.path``, exports its spans as Chrome
        ``trace_event`` JSON when it ends. Observational only, so it is
        not part of :meth:`batch_key`: traced and untraced plans fuse.
      program_kwargs: Initialize kwargs (e.g. ``{"root": 3}``), validated
        against ``program.accepted_kwargs()``.
    """

    program: VertexProgram
    strategy: str = "auto"
    max_iters: int = 200
    tol: float = 1e-10
    residency: str | None = None
    execution: str | None = None
    activity: str = "auto"
    checkpoint: CheckpointSpec | None = None
    trace: TraceSpec | None = None
    program_kwargs: Any = ()

    def __post_init__(self):
        if self.checkpoint is not None and not isinstance(
            self.checkpoint, CheckpointSpec
        ):
            raise TypeError(
                "checkpoint must be a repro_torch.reliability.CheckpointSpec or "
                f"None, got {type(self.checkpoint).__name__}"
            )
        if self.trace is not None and not isinstance(self.trace, TraceSpec):
            raise TypeError(
                "trace must be a repro_torch.obs.TraceSpec or None, "
                f"got {type(self.trace).__name__}"
            )
        if self.residency not in (None, "device", "host", "disk", "auto"):
            raise ValueError(
                "residency must be None, 'device', 'host', 'disk' or 'auto', "
                f"got {self.residency!r}"
            )
        if self.execution not in (
            None, "per_block", "packed", "packed_kernel", "auto"
        ):
            raise ValueError(
                "execution must be None, 'per_block', 'packed', "
                f"'packed_kernel' or 'auto', got {self.execution!r}"
            )
        if self.activity not in ("auto", "off"):
            raise ValueError(
                f"activity must be 'auto' or 'off', got {self.activity!r}"
            )
        kw = self.program_kwargs
        items = kw.items() if isinstance(kw, Mapping) else tuple(kw)
        frozen = tuple(sorted((str(k), _freeze_value(v)) for k, v in items))
        accepted = self.program.accepted_kwargs()
        unknown = sorted(k for k, _ in frozen if k not in accepted)
        if unknown:
            hint = (
                f"accepted kwargs: {sorted(accepted)}"
                if accepted
                else "it accepts no program_kwargs"
            )
            raise TypeError(
                f"unknown program_kwargs {unknown} for program "
                f"{self.program.name!r}; {hint}"
            )
        object.__setattr__(self, "program_kwargs", frozen)

    def kwargs_dict(self) -> dict[str, Any]:
        """Thawed Initialize kwargs, ready for ``program.init_attrs(...)``."""
        return {k: _thaw_value(v) for k, v in self.program_kwargs}

    def with_kwargs(self, **kw) -> "ExecutionPlan":
        """A copy of this plan with updated program kwargs (e.g. a new root)."""
        merged = self.kwargs_dict()
        merged.update(kw)
        return dataclasses.replace(self, program_kwargs=merged)

    def batch_key(self) -> tuple:
        """Plans sharing a batch_key may fuse into one sweep sequence.

        Program, strategy, limits, the residency/execution/activity axes
        and the checkpoint spec must agree (the serving micro-batcher
        buckets requests by ``(graph, batch_key())``); Initialize kwargs
        and the trace spec may differ. ``run_batch`` also needs
        the plans' aux to be identical or stackable.
        """
        return (
            self.program,
            self.strategy,
            self.max_iters,
            self.tol,
            self.residency,
            self.execution,
            self.activity,
            self.checkpoint,
        )

    def compatible_with(self, other: "ExecutionPlan") -> bool:
        """True iff the two plans may fuse into one sweep sequence."""
        return self.batch_key() == other.batch_key()
