"""Time kernel B2 over a full pass of the scale-22 graph's sub-shards on the card.

    python -m repro_torch.launch.bench_dsss [--edges PATH]

Builds R-MAT scale 22 (edge factor 16, seed 0, self loops dropped) with
P = 16 intervals, the graph of ``chip_smoke.py`` phases 7-8, stages every
non-empty sub-shard's float32 mul/sum operands through
``GraphSession.kernel_operands``, and times the ToHub update of all of
them on PageRank's contribs: one ``subshard_update`` call per sub-shard,
and, where the package has it, one ``subshard_update_pass`` call, checked
bitwise against the calls. Each form gets CUDA-event and host-clock ms per
pass and, per kernel, the launches and mean device µs per launch that a
``torch.profiler`` trace holds (``repro_torch.launch.timing``, as in the
smoke). Prints one JSON line with the card's name and power limit. The
bound and the ``torch.sparse.mm`` yardstick are the smoke's (phase 8).

``--edges`` caches the densified edge list as a ``.npz`` (made on the first
run), so two checkouts can be timed in one session on the same graph: the
script takes whichever ``repro_torch`` is first on the path.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

SCALE = 22
P = 16
PASS_REPS = 20
CALL_REPS = 10


def _edges(path: str | None):
    import numpy as np

    from repro_torch.graph.generators import rmat
    from repro_torch.graph.preprocess import EdgeList, degree_and_densify

    fields = ("src", "dst", "n", "out_degree", "in_degree", "id_to_index")
    if path and os.path.exists(path):
        z = np.load(path)
        return EdgeList(**{f: int(z[f]) if f == "n" else z[f] for f in fields})
    el = degree_and_densify(*rmat(SCALE, edge_factor=16, seed=0), drop_self_loops=True)
    if path:
        np.savez(path, **{f: getattr(el, f) for f in fields})
    return el


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", default=None, help="cache of the edge list (.npz)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_dsss: no CUDA device is available")

    from repro_torch import core
    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.timing import cuda_ms, device_kernels, host_ms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    g = core.build_dsss(_edges(args.edges), P)
    sess = core.GraphSession(g, device=dev)
    keys = sorted(sess.block_keys)
    isz = g.interval_size
    ops = [sess.kernel_operands(i, j, torch.float32, gather_op="mul", reduce="sum") for i, j in keys]
    slots = [sess.host_blocks[key]["u"] for key in keys]
    pr = core.PageRank()
    contrib = pr.init_attrs(g).to(dev) * pr.make_aux(g)["inv_out_degree"].to(dev)
    torch.cuda.synchronize()

    def calls():
        return [
            dk.subshard_update(contrib[i * isz:(i + 1) * isz], *ops[k], slots[k])
            for k, (i, _) in enumerate(keys)
        ]

    def timed(fn, reps):
        return {"ms": cuda_ms(fn, reps), "wall_ms": host_ms(fn, reps), "kernels": device_kernels(fn)}

    out = {"source": dk.__file__, "nvidia_smi": smi, "scale": SCALE, "P": P,
           "subshards": len(keys), "calls": timed(calls, CALL_REPS)}
    if hasattr(dk, "subshard_update_pass"):
        sp = kops.prepare_subshard_pass(
            ops, [i * isz for i, _ in keys], [isz] * len(keys), slots, gather_op="mul", reduce="sum"
        )
        out["pass"] = timed(lambda: dk.subshard_update_pass(contrib, sp), PASS_REPS)
        hubs, offsets = dk.subshard_update_pass(contrib, sp)
        for k, hub in enumerate(calls()):
            if not torch.equal(hubs[offsets[k]:offsets[k + 1]].view(torch.int32), hub.view(torch.int32)):
                raise SystemExit(f"bench_dsss: pass != subshard_update on sub-shard {keys[k]}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
