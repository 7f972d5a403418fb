"""Closed-form slow-tier I/O models, paper Table II (port of ``repro.core.iomodel``).

They drive the adaptive SPU / MPU(Q) / DPU choice and are the oracle the
engine's modelled byte meters reproduce. Pure Python arithmetic, equal to
the JAX package's for the same inputs.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "IOParams",
    "spu_io",
    "dpu_io",
    "mpu_io",
    "mpu_q",
    "select_strategy",
    "StrategyChoice",
    "modelled_io",
    "turbograph_like_io",
]


@dataclasses.dataclass(frozen=True)
class IOParams:
    """Byte-size parameters of the I/O model (paper Table I)."""

    n: int  # vertices
    m: int  # edges
    Ba: int = 8  # bytes per vertex attribute
    Bv: int = 4  # bytes per vertex id
    Be: int = 8  # bytes per edge
    d: float = 15.0  # mean in-degree of sub-shard destinations (hub factor)
    P: int = 16  # number of intervals


def spu_io(p: IOParams, B_M: int) -> tuple[float, float]:
    """SPU: read ``m·Be + 2n·Ba − B_M`` clamped to ``[0, m·Be]``; write 0."""
    read = p.m * p.Be + 2 * p.n * p.Ba - B_M
    return float(min(max(read, 0), p.m * p.Be)), 0.0


def dpu_io(p: IOParams, B_M: int = 0) -> tuple[float, float]:
    """DPU: read ``m·Be + m(Ba+Bv)/d + n·Ba``; write ``m(Ba+Bv)/d + n·Ba``."""
    hub = p.m * (p.Ba + p.Bv) / p.d
    return float(p.m * p.Be + hub + p.n * p.Ba), float(hub + p.n * p.Ba)


def mpu_q(p: IOParams, B_M: int) -> int:
    """``Q ≤ B_M / (2·ceil(n/P)·Ba)`` ping-pong-resident intervals."""
    per_interval = 2 * -(-p.n // p.P) * p.Ba
    return max(0, min(p.P, int(B_M // per_interval)))


def mpu_io(p: IOParams, B_M: int) -> tuple[float, float]:
    """MPU: Q=P is SPU-like, Q=0 is DPU.

    read  = m·Be + ((P−Q)/P)·n·Ba + ((P−Q)²/P²)·m·(Ba+Bv)/d
    write =        ((P−Q)/P)·n·Ba + ((P−Q)²/P²)·m·(Ba+Bv)/d
    """
    cold = (p.P - mpu_q(p, B_M)) / p.P
    hub = cold * cold * p.m * (p.Ba + p.Bv) / p.d
    iv = cold * p.n * p.Ba
    return float(p.m * p.Be + iv + hub), float(iv + hub)


def turbograph_like_io(p: IOParams, B_M: int) -> tuple[float, float]:
    """TurboGraph/GridGraph-style block-load strategy (paper §III-C).

    With the I/O-optimal partitioning ``P* = 2n·Ba/B_M``:
      read  = m·Be + 2(n·Ba)²/B_M + n·Ba
      write = n·Ba
    """
    read = p.m * p.Be + 2 * (p.n * p.Ba) ** 2 / max(B_M, 1) + p.n * p.Ba
    return float(read), float(p.n * p.Ba)


@dataclasses.dataclass(frozen=True)
class StrategyChoice:
    strategy: str  # "spu" | "mpu" | "dpu"
    Q: int
    modelled_read: float
    modelled_write: float

    @property
    def modelled_total(self) -> float:
        return self.modelled_read + self.modelled_write


def modelled_io(p: IOParams, B_M: int | None, strategy: str) -> tuple[float, float]:
    """Closed-form (read, write) for one strategy; ``B_M=None`` is unlimited."""
    if strategy == "spu":
        if B_M is None:
            return 0.0, 0.0
        return spu_io(p, B_M)
    if strategy == "dpu":
        return dpu_io(p)
    if strategy == "mpu":
        return mpu_io(p, B_M if B_M is not None else 0)
    if strategy == "turbograph-like":
        # Its P* term needs a B_M; "unlimited" is both attribute copies fitting.
        return turbograph_like_io(p, B_M if B_M is not None else 2 * p.n * p.Ba)
    raise ValueError(f"no closed form for strategy {strategy!r}")


def select_strategy(p: IOParams, B_M: int | None) -> StrategyChoice:
    """SPU when both padded attribute copies fit, else MPU with the largest Q
    (DPU at Q == 0)."""
    if B_M is None:
        return StrategyChoice("spu", p.P, 0.0, 0.0)
    if B_M >= 2 * p.P * -(-p.n // p.P) * p.Ba:  # 2 · n_pad · Ba
        r, w = spu_io(p, B_M)
        return StrategyChoice("spu", p.P, r, w)
    Q = mpu_q(p, B_M)
    r, w = mpu_io(p, B_M)
    return StrategyChoice("dpu" if Q == 0 else "mpu", Q, r, w)
