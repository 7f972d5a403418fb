"""Time the device main path's PageRank sweeps through ``GraphSession.run`` on the card.

    python -m repro_torch.launch.bench_session [--edges PATH] [--runs N]

Builds the scale-22 graph of ``chip_smoke.py``'s main path (R-MAT, edge
factor 16, seed 0, P = 16; ``--edges`` caches the densified edge list as
in ``repro_torch.launch.bench_packed``) and a device-residency session
under the smoke's budget, warms it, then runs SPU, DPU and MPU PageRank
for 10 sweeps each, ``--runs`` times in turns, with no fault plan,
checkpoint or cancel. Reports each run's ms per sweep (the session's
sweep loop, ``meters.wall_seconds`` / sweeps, which ends in a device
synchronize) and the medians, with the card's name and power limit, as
one JSON line. Two checkouts are compared by running this script from
each, in turns, on one card: it takes whichever ``repro_torch`` is first
on the path.
"""
from __future__ import annotations

import argparse
import json
import subprocess

SWEEPS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", default=None, help="cache of the edge list (.npz)")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import repro_torch
    from repro_torch import core
    from repro_torch.launch.bench_packed import P, _edges

    if not torch.cuda.is_available():
        raise SystemExit("bench_session: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    g = core.build_dsss(_edges(args.edges), P)
    pr = core.PageRank()
    budget = 2 * g.interval_size * pr.attr_bytes * (g.P // 2)
    sess = core.GraphSession(g, residency="device", memory_budget=budget)
    for strategy in ("spu", "dpu", "mpu"):  # stage and warm
        sess.run(core.ExecutionPlan(pr, strategy=strategy, max_iters=2, tol=0.0))
    torch.cuda.synchronize()
    ms = {s: [] for s in ("spu", "dpu", "mpu")}
    for _ in range(args.runs):
        for strategy in ms:
            res = sess.run(core.ExecutionPlan(pr, strategy=strategy, max_iters=SWEEPS, tol=0.0))
            ms[strategy].append(1e3 * res.meters.wall_seconds / res.meters.iterations)
    out = {
        "bench": "session", "tree": repro_torch.__file__, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "n": g.n, "m": g.m, "sweeps": SWEEPS, "ms_per_sweep": ms,
        "median_ms": {s: float(np.median(v)) for s, v in ms.items()},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
