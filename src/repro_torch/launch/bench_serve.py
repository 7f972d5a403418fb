"""Time the LM serving path (``ServeEngine``) on the card, for A/B runs.

    python -m repro_torch.launch.bench_serve [--runs N]

Serves ``chip_smoke.py``'s LM requests (8 prompts of 1024 tokens and 4 of
2048, ids from numpy's rng seed 0, 32 greedy tokens each) with
``ServeEngine(max_batch=8)`` over random bf16 weights from seed 0, gemma-2b
at full width and depth (the smoke's LM main path), ``attn_impl="pallas"``
(kernel B3).
One warm serve, then ``--runs`` timed ones. Reports each run's prefill ms
and decode ms a token per bucket (the engine's own clocks) and tokens/s,
and the medians, with the card's name and power limit, as one JSON line.
Two checkouts are compared by running this script from each, in turns,
on one card: it takes whichever ``repro_torch`` is first on the path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

ARCH = "gemma-2b"
BUCKETS = ((8, 1024), (4, 2048))  # (requests, prompt length)
NEW_TOKENS = 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.llm_demo import Request, ServeEngine

    if not torch.cuda.is_available():
        raise SystemExit("bench_serve: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="pallas")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    def serve() -> tuple[float, list]:
        rng = np.random.default_rng(0)
        engine = ServeEngine(cfg, params, max_batch=8)
        rid = 0
        for count, length in BUCKETS:
            for _ in range(count):
                engine.submit(Request(rid, rng.integers(0, cfg.vocab_size, length).tolist(),
                                      max_new_tokens=NEW_TOKENS))
                rid += 1
        t0 = time.perf_counter()
        out = engine.run()
        torch.cuda.synchronize()
        return sum(len(t) for t in out.values()) / (time.perf_counter() - t0), engine.stats

    serve()  # cuBLAS and the kernels warm up
    runs = []
    for _ in range(args.runs):
        tps, stats = serve()
        runs.append({
            "tokens_per_s": tps,
            "prefill_ms": {f"{s['batch']}x{s['prompt_len']}": 1e3 * (s["first_token_s"] - s["started_s"])
                           for s in stats},
            "decode_ms_per_token": {f"{s['batch']}x{s['prompt_len']}": 1e3 * s["decode_s"] / s["decode_steps"]
                                    for s in stats},
        })
    med = {"tokens_per_s": float(np.median([r["tokens_per_s"] for r in runs]))}
    for key in ("prefill_ms", "decode_ms_per_token"):
        med[key] = {b: float(np.median([r[key][b] for r in runs])) for b in runs[0][key]}
    out = {"bench": "serve", "tree": repro_torch.__file__, "arch": cfg.name, "layers": cfg.num_layers,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "runs": runs, "median": med}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
