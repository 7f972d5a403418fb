"""Device resolution for the port.

Every entry point of :mod:`repro_torch` runs on the CUDA card unless the
caller asks for the CPU. ``device=None`` means ``"cuda"``; when no CUDA
device is present that is an error, never a quiet fall-back to the CPU —
a CPU run of this package is a correctness check, not a measurement.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → the first CUDA device; anything else as given.

    Raises :class:`RuntimeError` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; repro_torch runs on the GPU by "
            "default — pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
