"""Time kernel B3 at gemma-2b's two serving buckets on the card.

    python -m repro_torch.launch.bench_flash [--reps 20]

For each bucket (8 prompts of 1024 tokens, 4 of 2048; Hq 8 on one KV head,
D 256, causal) q, k and v are made (B, S, H, D) and transposed to
(B, H, S, D), as ``attn_apply`` passes them, and timed by CUDA events over
``--reps`` launches after a warm-up: the bf16 inputs (the tensor-core
body), the same inputs in float32 (the CUDA-core body) and
``scaled_dot_product_attention`` on the bf16 inputs (a yardstick, used
nowhere in the port). Prints one JSON line with the card's name and power
limit. The script takes whichever ``repro_torch`` is first on the path, so
two checkouts can be timed in one session (``PYTHONPATH=<checkout>/src``).
"""
from __future__ import annotations

import argparse
import json
import subprocess

BUCKETS = ((8, 1024), (4, 2048))


def cuda_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"source": fa.__file__, "nvidia_smi": smi, "buckets": {}}
    for count, length in BUCKETS:
        g = torch.Generator(device=dev).manual_seed(length)
        q, k, v = (
            torch.randn((count, length, h, 256), generator=g, device=dev, dtype=torch.bfloat16).transpose(1, 2)
            for h in (8, 1, 1)
        )
        qf, kf, vf = q.float(), k.float(), v.float()
        out["buckets"][f"{count}x{length}"] = {
            "bf16_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), args.reps),
            "f32_ms": cuda_ms(lambda: fa.flash_attention(qf, kf, vf, causal=True), max(1, args.reps // 4)),
            "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), args.reps),
        }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
