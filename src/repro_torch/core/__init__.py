"""NXgraph core, ported to PyTorch: layout, programs, I/O model, session.

- :mod:`repro_torch.core.dsss` — Destination-Sorted Sub-Shard layout and tile packing
- :mod:`repro_torch.core.session` — GraphSession at device, host and disk residency, the session cache
- :mod:`repro_torch.core.streaming` — host→device payloads and the copy ring of host residency
- :mod:`repro_torch.core.plan` — ExecutionPlan
- :mod:`repro_torch.core.engine` — the NXGraphEngine shim over Session/Plan
- :mod:`repro_torch.core.algorithms` — PageRank/BFS/WCC/SSSP/SCC drivers (§IV),
  plus batched ``multi_bfs`` / ``multi_sssp``
- :mod:`repro_torch.core.baselines` — TurboGraph-like + GraphChi-like baselines (§III-C)
- :mod:`repro_torch.core.vertex_programs` — Initialize/Update/Output programs
- :mod:`repro_torch.core.iomodel` — Table II I/O closed forms + adaptive selection
- :mod:`repro_torch.core.identities` — the ⊕-identity families
"""
from repro_torch.core.dsss import DSSSGraph, PackedSweep, SubShard, build_dsss
from repro_torch.core.iomodel import (
    IOComparison,
    IOParams,
    StrategyChoice,
    calibrate_edge_bytes,
    compare_measured,
    disk_read_bytes,
    dpu_io,
    modelled_io,
    mpu_io,
    mpu_q,
    packed_disk_bytes,
    packed_h2d_bytes,
    select_strategy,
    spu_io,
    turbograph_like_io,
)
from repro_torch.core.plan import CheckpointSpec, ExecutionPlan, TraceSpec
from repro_torch.core.session import (
    MODEL_METER_FIELDS,
    BatchResult,
    GraphSession,
    Meters,
    Result,
    clear_session_cache,
    get_session,
)
from repro_torch.core.engine import NXGraphEngine
from repro_torch.core.vertex_programs import (
    BFS,
    INF_DEPTH,
    SSSP,
    WCC,
    MaxLabelForward,
    PageRank,
    ReachBackward,
    VertexProgram,
)
from repro_torch.core.algorithms import (
    bfs,
    multi_bfs,
    multi_sssp,
    pagerank,
    scc,
    sssp,
    wcc,
)

__all__ = [
    "DSSSGraph",
    "PackedSweep",
    "SubShard",
    "build_dsss",
    "GraphSession",
    "ExecutionPlan",
    "CheckpointSpec",
    "TraceSpec",
    "BatchResult",
    "get_session",
    "clear_session_cache",
    "NXGraphEngine",
    "Meters",
    "MODEL_METER_FIELDS",
    "Result",
    "IOParams",
    "StrategyChoice",
    "spu_io",
    "dpu_io",
    "mpu_io",
    "mpu_q",
    "modelled_io",
    "select_strategy",
    "turbograph_like_io",
    "IOComparison",
    "compare_measured",
    "calibrate_edge_bytes",
    "disk_read_bytes",
    "packed_disk_bytes",
    "packed_h2d_bytes",
    "VertexProgram",
    "PageRank",
    "BFS",
    "WCC",
    "SSSP",
    "MaxLabelForward",
    "ReachBackward",
    "INF_DEPTH",
    "pagerank",
    "bfs",
    "wcc",
    "sssp",
    "scc",
    "multi_bfs",
    "multi_sssp",
]
