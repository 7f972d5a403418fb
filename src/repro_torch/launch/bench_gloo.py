"""Time gloo's collectives among ranks that share one card.

    python -m repro_torch.launch.bench_gloo [--ranks 4] [--mib 64 512] [--reps 3]

The smoke's distributed phases run their ranks on the one card of the
machine, joined by gloo (NCCL takes one card per rank). For each size (MiB
of bf16 that a rank receives) each rank times, on the host clock after a
warm call and a barrier, ending in a synchronize: ``all_gather`` and
``all_to_all_single`` of bf16 and ``all_reduce`` of bf16 and float32, each
on CUDA tensors (gloo's CUDA path) and on page-locked host tensors (its
CPU path), and the device-to-host copy into page-locked memory that the
host form costs first. ``sharding/fsdp.py`` moves its gathers and
reduce-scatters through ``all_to_all_single`` on host copies after these
readings. Prints one JSON line with each form's ms and GB/s (bytes a rank
receives, or reduces, over the time; the slowest rank) and the card's
name and power limit. Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def _rank(rank: int, mib: tuple, reps: int) -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    world = dist.get_world_size()
    out = {}

    def timed(name, fn, nbytes):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        s = (time.perf_counter() - t) / reps
        out[name] = {"ms": 1e3 * s, "gb_per_s": nbytes / s / 1e9}

    for m in mib:
        n = m * 2**20 // 2  # bf16 elements a rank receives
        for where in ("cuda", "host"):
            def make(numel, dtype, where=where):
                if where == "cuda":
                    return torch.randn(numel, device=dev).to(dtype)
                return torch.randn(numel).to(dtype).pin_memory()

            piece = make(n // world, torch.bfloat16)
            parts = [make(n // world, torch.bfloat16) for _ in range(world)]
            timed(f"all_gather_{where}_{m}MiB", lambda: dist.all_gather(parts, piece), n * 2)
            send, recv = make(n, torch.bfloat16), make(n, torch.bfloat16)
            timed(f"all_to_all_{where}_{m}MiB", lambda: dist.all_to_all_single(recv, send), n * 2)
            timed(f"all_reduce_bf16_{where}_{m}MiB", lambda: dist.all_reduce(send), n * 2)
            wide = make(n, torch.float32)
            timed(f"all_reduce_f32_{where}_{m * 2}MiB", lambda: dist.all_reduce(wide), n * 4)
            del piece, parts, send, recv, wide
        src, host = make(n, torch.bfloat16, "cuda"), make(n, torch.bfloat16, "host")
        timed(f"d2h_pinned_{m}MiB", lambda: host.copy_(src), n * 2)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.distributed import spawn_gloo

    if not torch.cuda.is_available():
        raise SystemExit("bench_gloo: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    per_rank = spawn_gloo(_rank, args.ranks, tuple(args.mib), args.reps)
    forms = {k: {"ms": max(r[k]["ms"] for r in per_rank), "gb_per_s": min(r[k]["gb_per_s"] for r in per_rank)}
             for k in per_rank[0]}
    out = {"ranks": args.ranks, "reps": args.reps, "forms": forms, "nvidia_smi": smi,
           "note": "ranks sharing one card through gloo: not a multi-GPU measurement"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
