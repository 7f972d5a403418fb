"""repro_torch — the NXgraph engine ported to PyTorch and CUDA (H100).

The port of the JAX package ``repro``, which stays the reference. It
mirrors that package's layout and names; it imports ``torch`` and numpy,
never JAX and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card, ``device=None`` raises. On the CPU each
kernel's plain PyTorch version runs in its place.

Ported so far, at device, host and disk residency (``residency="host"``,
or a ``memory_budget`` under ``"auto"``: the unpinned edge topology
streams from page-locked host memory every sweep; ``"disk"``, a session
opened from a ``.dsss`` file with ``GraphSession.open``: it streams from
the file's mmap views under a host memory budget): the packed path — ``GraphSession.run``
/ ``run_batch`` → the tile-sweep kernel (``kernels/csrc/packed_sweep.cu``),
or its plain version under ``execution="packed"`` — and the per-block path
(``execution="per_block"``: the SPU/DPU/MPU schedules, the fused strategy
and registered custom schedules such as the TurboGraph-like baseline of
``repro_torch.core.baselines``), with the sub-shard ToHub kernel
(``kernels/csrc/dsss_spmv.cu``) behind ``GraphSession.kernel_operands`` and
``repro_torch.kernels.ops.subshard_update``. Above the session: the §IV
drivers (``pagerank``, ``bfs``, ``wcc``, ``sssp``, ``scc``, ``multi_bfs``,
``multi_sssp``), the session cache (``get_session``) and the
``NXGraphEngine`` shim. Beside them: the ``.dsss`` store, its external
builder and CLI (``repro_torch.storage``), the graph text I/O
(``repro_torch.graph.io``), and observability (``repro_torch.obs``: the
metrics registry, the span tracer, the scrape endpoint;
``ExecutionPlan(trace=TraceSpec(...))``). Reliability
(``repro_torch.reliability``: fault plans, sweep snapshots and resume,
``ExecutionPlan(checkpoint=CheckpointSpec(...))``, self-healing reads and
repair) and graph serving (``repro_torch.serving``: the session pool and
the micro-batching ``GraphServer``).
"""
from repro_torch.core import (
    BFS,
    INF_DEPTH,
    MODEL_METER_FIELDS,
    SSSP,
    WCC,
    BatchResult,
    CheckpointSpec,
    DSSSGraph,
    ExecutionPlan,
    GraphSession,
    MaxLabelForward,
    Meters,
    NXGraphEngine,
    PackedSweep,
    PageRank,
    ReachBackward,
    Result,
    TraceSpec,
    VertexProgram,
    bfs,
    build_dsss,
    clear_session_cache,
    get_session,
    multi_bfs,
    multi_sssp,
    pagerank,
    scc,
    sssp,
    turbograph_like_io,
    wcc,
)
from repro_torch.device import resolve_device
from repro_torch.graph import EdgeList, degree_and_densify

__all__ = [
    "GraphSession",
    "ExecutionPlan",
    "TraceSpec",
    "CheckpointSpec",
    "BatchResult",
    "Result",
    "Meters",
    "MODEL_METER_FIELDS",
    "DSSSGraph",
    "PackedSweep",
    "build_dsss",
    "EdgeList",
    "degree_and_densify",
    "VertexProgram",
    "PageRank",
    "BFS",
    "WCC",
    "SSSP",
    "MaxLabelForward",
    "ReachBackward",
    "INF_DEPTH",
    "resolve_device",
    "get_session",
    "clear_session_cache",
    "NXGraphEngine",
    "turbograph_like_io",
    "pagerank",
    "bfs",
    "wcc",
    "sssp",
    "scc",
    "multi_bfs",
    "multi_sssp",
]
