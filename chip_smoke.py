"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit; the kernels are built from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, started together).
2. kernel_vs_plain: the tile-sweep kernel against its plain PyTorch version
   on the card — R-MAT scale 14 and a zipf graph, P in {4, 16}, adaptive and
   subshard packing, all six programs, weighted and unweighted, K=1 full
   sweeps and K=8 with stacked aux, a partial row_active and a selective
   tile list. Tolerance: none, the results must be bitwise equal, and a
   second launch must give the same bits.
3. main_path: R-MAT scale 22, edge factor 16, seed 0, P=16 (the paper's
   live-journal at its own size) through ``GraphSession.run`` for PageRank
   under SPU/DPU/MPU and ``run_batch`` of 8 BFS roots. Checks: the kernel
   launched on every sweep; the strategies agree bitwise; PageRank sums to
   1 within 1e-4 and is within L1 1e-4 of a float64 ``torch.sparse`` power
   iteration of the same formula; the BFS batch equals the plain version's
   run bitwise.
4. timing: the kernel, its plain version and one ``torch.sparse.mm`` of the
   same PageRank gather-reduce (the yardstick, used nowhere in the port),
   at the main path's shapes.

The last line is ``{"ok": true, "device": {...}}``; any failed check raises
and the script exits non-zero. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_PER_S = 67e12  # float32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from repro_torch import core
    from repro_torch.core import session as session_mod
    from repro_torch.core import vertex_programs as vp
    from repro_torch.core.identities import reduce_identity
    from repro_torch.graph.generators import rmat, zipf
    from repro_torch.graph.preprocess import degree_and_densify
    from repro_torch.kernels import _build
    from repro_torch.kernels import packed_sweep as ps

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    emit(
        "device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
    )

    # -- phase 2: the kernel against its plain version on the card ----------
    rng = np.random.default_rng(0)

    def state(prog, g, K, stacked, r):
        n_pad = g.n_pad
        if prog.dtype == torch.float32:
            attrs = (r.random((K, n_pad)) * 2).astype(np.float32)
            if isinstance(prog, vp.SSSP):
                attrs[r.random((K, n_pad)) < 0.3] = np.inf
        elif isinstance(prog, vp.ReachBackward):
            attrs = r.integers(0, 2, (K, n_pad)).astype(np.int32)
        else:
            attrs = r.integers(-50, 50, (K, n_pad)).astype(np.int32)
            attrs[r.random((K, n_pad)) < 0.2] = core.INF_DEPTH
        acc = torch.full(
            (K, n_pad), reduce_identity(prog.reduce, prog.dtype).item(), dtype=prog.dtype
        )

        def aux_of(q):
            if isinstance(prog, vp.PageRank):
                return prog.make_aux(g, personalize=q if stacked else None)
            if isinstance(prog, vp.MaxLabelForward):
                return prog.make_aux(g, mask=(r.random(n_pad) < 0.8).astype(np.int32))
            if isinstance(prog, vp.ReachBackward):
                return prog.make_aux(
                    g, mask=(r.random(n_pad) < 0.8).astype(np.int32),
                    colors=r.integers(0, 3, n_pad).astype(np.int32),
                )
            return prog.make_aux(g)

        if stacked:
            per_q = [aux_of(q) for q in range(K)]
            aux = {k: torch.stack([a[k] for a in per_q]) for k in per_q[0]}
        else:
            aux = aux_of(0)
        return (
            torch.from_numpy(attrs).to(dev), acc.to(dev),
            {k: v.to(dev) for k, v in aux.items()},
        )

    programs = [vp.PageRank(), vp.BFS(), vp.WCC(), vp.SSSP(), vp.MaxLabelForward(), vp.ReachBackward()]
    cases = 0
    max_abs_err = 0.0
    t0 = time.perf_counter()
    before = ps.launches
    for gname in ("rmat14", "zipf"):
        src, dst = rmat(14, edge_factor=16, seed=1) if gname == "rmat14" else zipf(
            1 << 14, 1 << 18, seed=2
        )
        for weighted in (False, True):
            w = rng.random(src.shape[0]).astype(np.float32) + 0.01 if weighted else None
            el = degree_and_densify(src, dst, w, drop_self_loops=True)
            for P in (4, 16):
                g = core.build_dsss(el, P)
                for packing in ("adaptive", "subshard"):
                    packed = g.packed_sweep(packing)
                    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device=dev)
                    for prog in programs:
                        for K, stacked, partial in ((1, False, False), (8, True, True)):
                            attrs, acc, aux = state(prog, g, K, stacked, rng)
                            row = np.ones(P, bool)
                            idx = None
                            if partial:
                                row = rng.random(P) < 0.5
                                row[rng.integers(P)] = True
                                local = np.flatnonzero(rng.random(packed.num_tiles) < 0.6)
                                idx = torch.from_numpy(local.astype(np.int32)).to(dev)
                            row_t = torch.from_numpy(row).to(dev)
                            args = (prog, attrs, acc, aux, tiles, row_t, weighted, stacked, idx)
                            got = ps.packed_sweep_update(*args)
                            again = ps.packed_sweep_update(*args)
                            want = ps.packed_sweep_update_ref(*args)
                            torch.cuda.synchronize()
                            label = f"{gname} w={weighted} P={P} {packing} {prog.name} K={K}"
                            check(torch.equal(got, again), f"kernel not deterministic: {label}")
                            check(torch.equal(got, want), f"kernel != plain: {label}")
                            diff = (got.double() - want.double()).abs()
                            diff = diff[torch.isfinite(diff)]
                            if diff.numel():
                                max_abs_err = max(max_abs_err, float(diff.max()))
                            cases += 1
    emit(
        "kernel_vs_plain", cases=cases, launches=ps.launches - before,
        bitwise=True, max_abs_err=max_abs_err, seconds=time.perf_counter() - t0,
    )

    # -- phase 3: the main path at full size ---------------------------------
    t0 = time.perf_counter()
    src, dst = rmat(22, edge_factor=16, seed=0)
    t_rmat = time.perf_counter() - t0
    el = degree_and_densify(src, dst, drop_self_loops=True)
    del src, dst
    t_densify = time.perf_counter() - t0 - t_rmat
    g = core.build_dsss(el, 16)
    t_build = time.perf_counter() - t0 - t_rmat - t_densify
    pr = vp.PageRank()
    # Room for Q = P/2 ping-pong intervals of PageRank: MPU with 0 < Q < P.
    budget = 2 * g.interval_size * pr.attr_bytes * (g.P // 2)
    sess = core.GraphSession(g, device=None, residency="device", memory_budget=budget)
    packed = sess._staged.packed_host(sess.packing)
    t1 = time.perf_counter()
    tiles = sess._staged.packed_tiles(sess.packing, sess.device)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t1
    host_s = time.perf_counter() - t0
    emit(
        "main_path_graph", n=g.n, m=g.m, P=g.P, T=packed.tile_edges,
        NT=packed.num_tiles, runs=int(tiles["run_start"].shape[0]),
        long_runs=int(tiles["long_runs"].shape[0]),
        max_run=int((tiles["run_end"] - tiles["run_start"]).max()),
        padding_ratio=packed.padding_ratio, host_rmat_s=t_rmat,
        host_densify_s=t_densify, host_build_dsss_and_pack_s=t_build,
        host_stage_s=t_stage, host_total_s=host_s,
    )
    # One warm sweep (staging and build are done; first launches warm up).
    sess.run(core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ps.launches = 0  # every count to 0 just before the main path
    runs = {}
    pr_sweep_ms = {}  # the sweep loop's host clock, ending in a synchronize
    pr_run_ms = {}  # the whole run() call, set-up and result copy included
    pr_launches = {}
    for strategy in ("spu", "dpu", "mpu"):
        before = ps.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = sess.run(core.ExecutionPlan(pr, strategy=strategy, max_iters=10, tol=0.0))
        end.record()
        torch.cuda.synchronize()
        runs[strategy] = res
        pr_sweep_ms[strategy] = 1e3 * res.meters.wall_seconds / res.meters.iterations
        pr_run_ms[strategy] = start.elapsed_time(end)
        pr_launches[strategy] = ps.launches - before
        check(res.meters.iterations == 10, f"{strategy}: ran {res.meters.iterations} sweeps")
        check(pr_launches[strategy] == res.meters.iterations,
              f"{strategy}: {pr_launches[strategy]} launches for {res.meters.iterations} sweeps")
    rng = np.random.default_rng(0)
    roots = rng.choice(np.flatnonzero(g.out_degree[: g.n] > 0), size=8, replace=False)
    bfs_plans = [
        core.ExecutionPlan(vp.BFS(), max_iters=g.n + 1, program_kwargs={"root": int(r)})
        for r in roots
    ]
    before = ps.launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    bfs = sess.run_batch(bfs_plans)
    end.record()
    torch.cuda.synchronize()
    bfs_launches = ps.launches - before
    main_launches = ps.launches  # read just after the main path
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    check(bfs.fused and bfs.converged, "BFS batch did not fuse or converge")
    check(bfs_launches == bfs.iterations,
          f"BFS: {bfs_launches} launches over {bfs.iterations} sweeps")

    ref = runs["spu"].attrs
    for s in ("dpu", "mpu"):
        check(np.array_equal(runs[s].attrs.view(np.int32), ref.view(np.int32)),
              f"PageRank {s} != spu bitwise")
    total = float(ref.astype(np.float64).sum())
    check(abs(total - 1.0) < 1e-4, f"PageRank sums to {total}")

    # Independent float64 check: p' = (1-d)/n + d (Aᵀ(p/outdeg) + mass/n).
    n = g.n
    e_src = torch.from_numpy(el.src.astype(np.int64)).to(dev)
    e_dst = torch.from_numpy(el.dst.astype(np.int64)).to(dev)
    order = torch.argsort(e_dst * n + e_src)
    col = e_src[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(e_dst, minlength=n), 0)
    outdeg = torch.from_numpy(el.out_degree.astype(np.float64)).to(dev)
    inv64 = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1), torch.zeros_like(outdeg))
    at64 = torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], dtype=torch.float64, device=dev), (n, n))
    p = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    for _ in range(10):
        mass = p[outdeg == 0].sum()
        p = (1 - pr.damping) / n + pr.damping * ((at64 @ (p * inv64)[:, None])[:, 0] + mass / n)
    l1 = float((torch.from_numpy(ref.astype(np.float64)).to(dev) - p).abs().sum())
    check(l1 < 1e-4, f"PageRank L1 distance to float64 power iteration {l1}")
    del at64

    # The BFS batch against the plain version's run on the card, bitwise.
    session_mod.packed_sweep_update = ps.packed_sweep_update_ref
    try:
        bfs_plain = sess.run_batch(bfs_plans)
    finally:
        session_mod.packed_sweep_update = ps.packed_sweep_update
    for a, b in zip(bfs, bfs_plain):
        check(np.array_equal(a.attrs, b.attrs), "BFS batch != plain version")
    check(bfs.iterations == bfs_plain.iterations, "BFS sweeps differ from plain")
    mean_ms = float(np.mean(list(pr_sweep_ms.values())))
    pr_mteps = {s: r.meters.mteps() for s, r in runs.items()}
    emit(
        "main_path", launches=main_launches, pr_launches=pr_launches,
        pr_ms_per_sweep=pr_sweep_ms, pr_run_ms=pr_run_ms,
        pr_mteps=pr_mteps,
        pr_sum=total, pr_l1_vs_float64=l1, bfs_sweeps=bfs.iterations,
        bfs_launches=bfs_launches,
        bfs_ms_per_sweep=1e3 * bfs.meters.wall_seconds / bfs.iterations,
        bfs_run_ms=start.elapsed_time(end),
        bfs_edges_processed=bfs.meters.edges_processed, bfs_max_depth=[r.output for r in bfs],
        peak_device_bytes=peak_bytes,
    )

    # -- phase 3b: where a sweep's device time goes (torch.profiler) ---------
    from torch.profiler import ProfilerActivity, profile

    plan3 = core.ExecutionPlan(pr, strategy="spu", max_iters=3, tol=0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res3 = sess.run(plan3)
        torch.cuda.synchronize()
        run_wall_us = (time.perf_counter() - t1) * 1e6
    # Device-side events only: an aten op's row repeats its kernels' time.
    on_device = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in on_device)
    by_name: dict[str, float] = {}
    for e in on_device:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(
        "profile", sweeps=res3.meters.iterations, run_wall_ms=run_wall_us / 1e3,
        sweep_loop_ms=1e3 * res3.meters.wall_seconds, device_busy_ms=busy_us / 1e3,
        device_busy_share_of_run=busy_us / run_wall_us,
        device_us_per_sweep={k: v / res3.meters.iterations for k, v in top},
    )

    # -- phase 4: timing at the main path's shapes ---------------------------
    attrs = torch.from_numpy(
        np.concatenate([ref, np.zeros(g.n_pad - n, np.float32)])
    ).to(dev)[None, :]
    aux = {k: v.to(dev) for k, v in pr.make_aux(g).items()}
    acc = torch.zeros_like(attrs)
    row = torch.ones(g.P, dtype=torch.bool, device=dev)
    args = (pr, attrs, acc, aux, tiles, row, False)
    k_out = ps.packed_sweep_update(*args)
    p_out = ps.packed_sweep_update_ref(*args)
    check(torch.equal(k_out, p_out), "kernel != plain at the main path's shapes")
    kernel_ms = cuda_ms(lambda: ps.packed_sweep_update(*args), reps=20)
    plain_ms = cuda_ms(lambda: ps.packed_sweep_update_ref(*args), reps=2)
    inv32 = aux["inv_out_degree"][:n]
    at32 = torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], dtype=torch.float32, device=dev), (n, n))
    x = (attrs[0, :n] * inv32)[:, None]
    library_ms = cuda_ms(lambda: torch.sparse.mm(at32, x), reps=20)
    # The rest of a sweep, for the breakdown: the batched apply alone.
    old = attrs.reshape(1, g.P, g.interval_size)
    new_acc = k_out.reshape(1, g.P, g.interval_size)
    valid = (torch.arange(g.n_pad, device=dev) < n).reshape(g.P, g.interval_size)
    tol = torch.tensor(0.0, device=dev)
    globals_ = pr.pre_iteration(attrs, aux)
    apply_ms = cuda_ms(
        lambda: session_mod._apply_all_impl(pr, old, new_acc, aux, globals_, valid, tol),
        reps=20,
    )
    # Least bytes: attrs, inv_out_degree, acc in and out (4·n_pad each), the
    # sources of the m edges, each run's span, the destination CSR, P flags.
    R = int(tiles["run_start"].shape[0])
    L = int(tiles["long_runs"].shape[0])
    min_bytes = 16 * g.n_pad + 4 * g.m + 12 * R + 4 * L + 4 * (g.n_pad + 1) + g.P
    ops = 2 * g.m  # one multiply per edge, one add per edge
    bound_ms = 1e3 * max(min_bytes / H100_BYTES_PER_S, ops / H100_FP32_PER_S)
    emit(
        "timing", kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, min_bytes=min_bytes, ops=ops,
        apply_ms=apply_ms, sweep_ms=mean_ms,
        kernel_share_of_sweep=kernel_ms / mean_ms, nvidia_smi=smi,
    )
    print(json.dumps({"kernels": [{
        "name": "packed_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/packed_sweep.cu",
        "replaces": "src/repro/kernels/packed_sweep.py:86",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if min_bytes / H100_BYTES_PER_S >= ops / H100_FP32_PER_S else "operations",
        "library_ms": library_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
