"""Timing on the card, shared by ``chip_smoke.py`` and the bench launchers.

``cuda_ms`` and ``host_ms`` give a total per call (CUDA events, the host
clock); ``device_kernels`` gives, per kernel name, the launches a
``torch.profiler`` trace holds and their mean device µs. A trace may miss
some launches (a window of 5 passes once held 3), so totals come from the
events, never from a sum over the trace.
"""
from __future__ import annotations

import time

import torch

__all__ = ["cuda_ms", "host_ms", "device_kernels", "device_busy"]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host-clock ms per call of ``fn`` over ``reps`` calls, ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def device_kernels(fn, reps: int = 5, width: int = 60) -> dict:
    """Per kernel name (cut to ``width``), from torch.profiler over ``reps``
    calls of ``fn`` after a warm-up call: the launches the trace holds and
    their mean device µs."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps), acc_events=True) as prof:
        for _ in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    seen: dict[str, list] = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and not e.name.startswith("ProfilerStep"):
            seen.setdefault(e.name[:width], []).append(e.time_range.elapsed_us())
    return {name: {"launches": len(us), "us_per_launch": sum(us) / len(us)} for name, us in seen.items()}


def device_busy(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms (host clock, ending
    in a synchronize), the ms in which the device ran anything (the union of
    its kernels' and copies' intervals, so work of two streams that overlaps
    counts once) and the busy share. A trace that misses events gives a
    share below the true one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if str(e.device_type).endswith("CUDA") and not e.name.startswith("ProfilerStep")
    )
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us, "device_events": len(spans)}
