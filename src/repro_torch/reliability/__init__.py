"""repro_torch.reliability — fault injection, checkpoint/resume, degraded reads.

Port of ``repro.reliability``: deterministic fault plans injected at every
real I/O boundary of the port (:mod:`.faults`: the ``.dsss`` store's
checksum reads, the host→device copies of streamed topology, the sweep
loop), atomic sweep-level snapshot/resume for iterative runs
(:mod:`.checkpoint`), and the rebuild of a damaged ``.dsss`` container
(:mod:`.repair` — imported lazily, since it pulls in the storage build
pipeline).

This package's eager imports are stdlib and numpy only, so ``core.plan``
and ``storage.format`` can depend on it without cycles.
"""
from repro_torch.reliability.checkpoint import (
    CheckpointSpec,
    SnapshotError,
    latest_snapshot,
    list_snapshots,
    load_snapshot,
    save_snapshot,
)
from repro_torch.reliability.faults import (
    DeadlineExceeded,
    FailureInjector,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedCrash,
    SimulatedFailure,
    StepTimer,
    StragglerWatchdog,
    TransientFault,
    elastic_device_count,
    with_transient_retries,
)

__all__ = [
    "CheckpointSpec",
    "DeadlineExceeded",
    "FailureInjector",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedCrash",
    "SimulatedFailure",
    "SnapshotError",
    "StepTimer",
    "StragglerWatchdog",
    "TransientFault",
    "elastic_device_count",
    "latest_snapshot",
    "list_snapshots",
    "load_snapshot",
    "save_snapshot",
    "with_transient_retries",
]
