"""repro_torch.storage — the on-disk DSSS tier (port of ``repro.storage``).

A versioned, memory-mappable ``.dsss`` container
(:mod:`repro_torch.storage.format`), byte for byte the JAX package's; an
external-memory build pipeline that produces it in bounded RAM
(:mod:`repro_torch.storage.build`); and a CLI
(``python -m repro_torch.storage build|info|verify``). An opened store is
the engine's third residency tier: ``GraphSession.open(path)`` /
``residency="disk"`` stream sub-shard blocks and packed tile chunks
disk → host → device.
"""
from repro_torch.storage.build import BuildStats, build_dsss_file, build_from_text
from repro_torch.storage.format import (
    ChecksumError,
    DegradedReadError,
    DSSSStore,
    FormatError,
    ReadPolicy,
    open_dsss,
    store_info,
    verify_dsss,
    write_dsss,
)

__all__ = [
    "BuildStats",
    "build_dsss_file",
    "build_from_text",
    "ChecksumError",
    "DegradedReadError",
    "DSSSStore",
    "FormatError",
    "ReadPolicy",
    "open_dsss",
    "store_info",
    "verify_dsss",
    "write_dsss",
]
