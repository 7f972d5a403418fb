"""NXgraph core, ported to PyTorch: layout, programs, I/O model, session.

- :mod:`repro_torch.core.dsss` — Destination-Sorted Sub-Shard layout and tile packing
- :mod:`repro_torch.core.session` — GraphSession at device residency
- :mod:`repro_torch.core.plan` — ExecutionPlan
- :mod:`repro_torch.core.vertex_programs` — Initialize/Update/Output programs
- :mod:`repro_torch.core.iomodel` — Table II I/O closed forms + adaptive selection
- :mod:`repro_torch.core.identities` — the ⊕-identity families
"""
from repro_torch.core.dsss import DSSSGraph, PackedSweep, build_dsss
from repro_torch.core.iomodel import (
    IOParams,
    StrategyChoice,
    dpu_io,
    modelled_io,
    mpu_io,
    mpu_q,
    select_strategy,
    spu_io,
)
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.session import (
    MODEL_METER_FIELDS,
    BatchResult,
    GraphSession,
    Meters,
    Result,
)
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

__all__ = [
    "DSSSGraph",
    "PackedSweep",
    "build_dsss",
    "GraphSession",
    "ExecutionPlan",
    "BatchResult",
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
    "VertexProgram",
    "PageRank",
    "BFS",
    "WCC",
    "SSSP",
    "MaxLabelForward",
    "ReachBackward",
    "INF_DEPTH",
]
