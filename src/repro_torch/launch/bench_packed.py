"""Time kernel B1, the tile sweep, at the scale-22 graph's shapes on the card.

    python -m repro_torch.launch.bench_packed [--edges PATH]

Builds R-MAT scale 22 (edge factor 16, seed 0, self loops dropped) with
P = 16 intervals, the graph of ``chip_smoke.py``'s main path, stages its
packed tiles as ``GraphSession`` does, and times one full sweep of
``packed_sweep_update`` for PageRank (K = 1) and for a batch of 8 BFS
queries (K = 8, the fused batch of the smoke): CUDA-event ms per sweep
and, per kernel, the launches and mean device µs per launch that a
``torch.profiler`` trace holds (``repro_torch.launch.timing``, as in the
smoke). Each result is checked bitwise against the plain version once.
Prints one JSON line with the card's name and power limit.

The PageRank sweep is also traced with the work list cut: where the
staged tiles carry a chunk table, to its long chunks alone, to the longest
run's chunk alone and to its short chunks alone; where they carry a
``long_runs`` list (the kernel
before its redesign, whose ``run_partials_long`` launch folds those runs
one warp each), to the longest run alone and to every long run but that
one.

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
BFS_K = 8
REPS = 20


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

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_packed: no CUDA device is available")

    from repro_torch import core
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.launch.timing import cuda_ms, device_kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    g = core.build_dsss(_edges(args.edges), P)
    sess = core.GraphSession(g, device=dev)
    tiles = sess._staged.packed_tiles(sess.packing, dev)
    row = torch.ones(g.P, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(0)

    pr = core.PageRank()
    pr_attrs = torch.from_numpy(rng.random((1, g.n_pad)).astype(np.float32) / g.n).to(dev)
    pr_args = (pr, pr_attrs, torch.zeros_like(pr_attrs), {k: v.to(dev) for k, v in pr.make_aux(g).items()},
               tiles, row, False)
    bfs = core.BFS()
    depth = rng.integers(0, 12, (BFS_K, g.n_pad)).astype(np.int32)
    depth[rng.random((BFS_K, g.n_pad)) < 0.5] = core.INF_DEPTH
    bfs_attrs = torch.from_numpy(depth).to(dev)
    bfs_args = (bfs, bfs_attrs, bfs_attrs.clone(), {}, tiles, row, False, True)

    out = {"source": ps.__file__, "nvidia_smi": smi, "scale": SCALE, "P": P, "n": g.n, "m": g.m,
           "runs": int(tiles["run_start"].shape[0])}
    for name, a in (("pagerank_k1", pr_args), ("bfs_k8", bfs_args)):
        got = ps.packed_sweep_update(*a)
        want = ps.packed_sweep_update_ref(*a)
        if not torch.equal(got, want):
            raise SystemExit(f"bench_packed: kernel != plain version ({name})")
        out[name] = {"ms": cuda_ms(lambda a=a: ps.packed_sweep_update(*a), REPS),
                     "kernels": device_kernels(lambda a=a: ps.packed_sweep_update(*a))}
    if "chunks" in tiles:
        ch = tiles["chunks"]
        n_long = int(((ch[:, 1] - ch[:, 0] == 1) & (ch[:, 3] - ch[:, 2] > ps.LONG_RUN)).sum())
        out["chunk_probe"] = {"chunks": int(ch.shape[0]), "long_chunks": n_long}
        cuts = (("long_only", ch[:n_long]), ("longest_only", ch[:1]), ("short_only", ch[n_long:]))
        for name, cut in cuts:
            a = (pr_args[:4] + ({**tiles, "chunks": cut.contiguous()},) + pr_args[5:])
            out["chunk_probe"][name] = device_kernels(lambda a=a: ps.packed_sweep_update(*a))
    if "long_runs" in tiles and tiles["long_runs"].numel():
        lens = tiles["run_end"] - tiles["run_start"]
        long_runs = tiles["long_runs"]
        top = int(torch.argmax(lens[long_runs.long()]))
        cuts = {"longest_only": long_runs[top:top + 1],
                "all_but_longest": torch.cat([long_runs[:top], long_runs[top + 1:]])}
        out["long_run_probe"] = {"longest_run_edges": int(lens[long_runs[top]])}
        for name, cut in cuts.items():
            a = (pr_args[:4] + ({**tiles, "long_runs": cut.contiguous()},) + pr_args[5:])
            out["long_run_probe"][name] = {"long_runs": int(cut.shape[0]),
                                           "kernels": device_kernels(lambda a=a: ps.packed_sweep_update(*a))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
