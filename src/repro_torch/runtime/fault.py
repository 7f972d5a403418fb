"""Compatibility shim: the train-loop fault primitives live in
:mod:`repro_torch.reliability` (port of ``repro.runtime.fault``).

:class:`FailureInjector`, :class:`StragglerWatchdog`,
:func:`elastic_device_count` and :class:`StepTimer` are defined in
``repro_torch.reliability.faults`` beside the engine's
:class:`~repro_torch.reliability.faults.FaultPlan`; this module re-exports
the old names.
"""
from __future__ import annotations

from repro_torch.reliability.faults import (
    FailureInjector,
    SimulatedFailure,
    StepTimer,
    StragglerWatchdog,
    elastic_device_count,
)

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerWatchdog", "elastic_device_count"]
