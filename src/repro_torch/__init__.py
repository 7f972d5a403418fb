"""repro_torch — the NXgraph engine ported to PyTorch and CUDA (H100).

The port of the JAX package ``repro``, which stays the reference. It
mirrors that package's layout and names; it imports ``torch`` and numpy,
never JAX and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card, ``device=None`` raises. On the CPU each
kernel's plain PyTorch version runs in its place.

Ported so far, at device residency: the packed path — ``GraphSession.run``
/ ``run_batch`` → the tile-sweep kernel (``kernels/csrc/packed_sweep.cu``)
— and the per-block path (``execution="per_block"``: the SPU/DPU/MPU
schedules and the fused strategy), with the sub-shard ToHub kernel
(``kernels/csrc/dsss_spmv.cu``) behind ``GraphSession.kernel_operands`` and
``repro_torch.kernels.ops.subshard_update``.
"""
from repro_torch.core import (
    BFS,
    INF_DEPTH,
    MODEL_METER_FIELDS,
    SSSP,
    WCC,
    BatchResult,
    DSSSGraph,
    ExecutionPlan,
    GraphSession,
    MaxLabelForward,
    Meters,
    PackedSweep,
    PageRank,
    ReachBackward,
    Result,
    VertexProgram,
    build_dsss,
)
from repro_torch.device import resolve_device
from repro_torch.graph import EdgeList, degree_and_densify

__all__ = [
    "GraphSession",
    "ExecutionPlan",
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
]
