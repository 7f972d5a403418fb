"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit; the kernels are built from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, started together).
   b3_build: what ptxas reports for each body of kernel B3 (registers,
   spills, wgmma serialized or not) and the tensor-core instructions in the
   built library's SASS (``cuobjdump -sass``: HGMMA for wgmma, HMMA for
   mma.sync); the run fails if there are none.
2. kernel_vs_plain: the tile-sweep kernel against its plain PyTorch version
   on the card — R-MAT scale 14 and a zipf graph, P in {4, 16}, adaptive and
   subshard packing, and a src_sorted build of the R-MAT graph (subshard
   packing, runs reached through the edge permutation), all six programs,
   weighted and unweighted, K=1 full sweeps and K=8 with stacked aux, a
   partial row_active and a selective tile list; then the hand-made layouts
   of ``repro_torch.launch.b1_cases`` (a run of 20,000 edges, run ends at
   window and chunk edges, -0.0 and NaN contribs, inactive intervals with
   negative and infinite weights, a selection without the longest run's
   tile, K=8 stacked, a src_sorted build) for all six programs. Tolerance:
   none, the results must be bitwise equal, and a second launch must give
   the same bits.
3. main_path: R-MAT scale 22, edge factor 16, seed 0, P=16 (the paper's
   live-journal at its own size) through ``GraphSession.run`` for PageRank
   under SPU/DPU/MPU and ``run_batch`` of 8 BFS roots. Checks: the kernel
   launched on every sweep; the strategies agree bitwise; PageRank sums to
   1 within 1e-4 and is within L1 1e-4 of a float64 ``torch.sparse`` power
   iteration of the same formula; the BFS batch equals the plain version's
   run bitwise.
4. timing: the kernel, its plain version and one ``torch.sparse.mm`` of the
   same PageRank gather-reduce (the yardstick, used nowhere in the port),
   at the main path's shapes, with each of the kernel's launches and its
   mean device µs (torch.profiler). b1_k8: the kernel alone for a batch of
   8 BFS queries (K=8, the fused batch's shape) beside its plain version
   and its byte bound; no single PyTorch call computes a min-plus fold, so
   it has no library time. Before it, src_sorted_path: R-MAT scale 18,
   P=8, built src_sorted, through ``GraphSession(g)`` (execution "auto")
   for 10 PageRank sweeps: one B1 launch per sweep, bitwise equal to the
   same run with the plain version; beside it, the destination-sorted
   build's ms per sweep.
5. dsss_spmv_vs_plain (after phase 2): the sub-shard ToHub kernel against
   its plain version on the card — the JAX tests' five shapes, slots out of
   order, and every sub-shard of R-MAT scale 14 (P=4) through
   ``GraphSession.kernel_operands``; mul/sum, add/min, add/max in float32
   and bfloat16. Then the pass entry (``subshard_update_pass``): the same
   shapes plus a hand-made sub-shard (a run across blocks, gaps, a jump past
   the window, NaN and -0.0 contribs) in one pass, and every sub-shard of
   R-MAT 14 and of its src_sorted build in one pass, against the plain pass
   and against one ``subshard_update`` per sub-shard. Bitwise, and a second
   launch gives the same bits.
6. per_block_path: the same scale-22 graph through
   ``GraphSession(..., execution="per_block")``: PageRank under
   SPU/DPU/MPU/fused, 10 sweeps, and ``run_batch`` of the 8 BFS roots.
   SPU/DPU/MPU equal each other and the packed_kernel runs bitwise, fused
   is within rtol 3e-5 of them and within L1 1.3e-6 of the float64 power
   iteration, model meters equal the packed path's, and the BFS batch
   equals the packed batch bitwise. Its block primitives are
   plain PyTorch (ordered ``segment_reduce`` folds), so it launches neither
   kernel; the counts are read to show that.
7. subshard_kernel_path: one PageRank sweep at scale 22 built from
   ``kernel_operands`` over every non-empty sub-shard, twice: through the
   pass entry (``ops.prepare_subshard_pass`` once, then one call) and
   through ``subshard_update`` (one call each). Both against the session's
   sweep within rtol 1e-5, and against each other bitwise.
8. dsss_spmv timing: a full pass over all sub-shards — both forms (CUDA
   events and host clock), the plain version, the bound, and one
   ``torch.sparse.mm`` CSR SpMV of the global hub-slot × source-vertex
   matrix (the yardstick); each kernel's launches and mean device time per
   launch in both forms (torch.profiler). The plain pass's hub vectors are held against two
   runs of each form, bitwise, for every sub-shard.
9. flash_attention_vs_plain: the flash-attention kernel (B3) against its
   plain version (a materialized float32 softmax) on the card — the JAX
   tests' cases (five shapes, windows, softcaps, non-causal), ragged
   lengths, rows that see no key, gemma-2b's two serving shapes, gemma2-9b's
   and qwen2.5-14b's; float32 (the CUDA-core body) and bfloat16 (the
   tensor-core body), and whisper-medium's and internvl2-26b's shapes.
   Tolerance: the JAX tests' own bounds, rtol = atol = 2e-5 (float32) and
   3e-2 (bfloat16), and for bfloat16 each query row within 2**-6 of its
   largest |value| (two bf16 steps); a second launch gives the same bits.
   Then a tail-mask case at whisper's non-causal shapes (Sk = 1500, a
   28-key tail tile): k and v are views of longer buffers whose rows past
   Sk would dominate every softmax, and the scores of the real keys sit
   near -8 so that a zero-filled tail left unmasked would too; both leaks,
   made in the plain version, land over 10 times the row bar.
10. lm_serving: the LM main path, ``ServeEngine(max_batch=8)`` over
    gemma-2b at full width and depth (18 layers, 2.51 B parameters, bf16
    weights drawn on the card from ``torch.Generator`` seed 0),
    ``attn_impl="pallas"``: 8 prompts of 1024 tokens and 4 of 2048
    (numpy seed 0), 32 greedy tokens each, two buckets. Checks: B3 launched
    once per layer and bucket (36), the other kernels not at all; ids in
    range; the same tokens as a first (warm-up) run; each bucket's prefill
    logits finite and within 2**-4 of the largest |logit| of the same
    weights under ``attn_impl="ref"``. Prints prefill, time to first token,
    decode ms per token, tokens/s, peak memory, and (line b3_timing) B3
    per launch at each bucket's shapes beside its plain version, its bound,
    ``scaled_dot_product_attention`` (the yardstick, used nowhere in the
    port) and the float32 body at the same shapes, with the achieved
    TFLOP/s and the share of the bound.
11. lm_serving_f32: the same requests with float32 weights and no TF32,
    under ``attn_impl="pallas"`` and ``"ref"``: the greedy tokens must be
    equal, or part only where the top-2 logit gap is below 1e-4 of the
    logit.
12. distributed (after wcc_scc, on the scale-22 graph): the 2-D
    partitioned PageRank of ``repro_torch.core.distributed``. The grids
    1 × 1 and 2 × 2 are built once (``build_device_blocks``) and each
    block written to a file under ``build/``; gloo ranks spawned on card 0
    (one card shared by the ranks, the collectives through gloo: not a
    multi-GPU measurement) make one step each (its placement names the
    rank's block file), run ``distributed_pagerank`` with it for 12
    iterations, ``tol=0``, on the meshes (1, 1), (2, 2) twice
    and (2, 1, 2) with source axes ("pod", "data"). Checks: every rank
    returns the same vector; within 1e-6 max abs of the fused per-block
    PageRank's 12 sweeps; sums to 1 within 1e-4; L1 within 1e-4 of the
    float64 power iteration's 12; the two (2, 2) runs give the same bits;
    each rank's first hub is bitwise ``subshard_update_ref`` on the card;
    B2 launched ranks × iterations times. Prints each mesh's ms per
    iteration (the step alone, staging outside the clock) and its split
    into ToHub (B2), ``all_reduce`` and ``all_gather`` (a second run with
    the device synchronised around each), per-block edges, E_max and each
    rank's peak device memory.
13. lm_families (after lm_serving_f32, gemma-2b freed): deepseek-moe-16b
    at full width and depth (28 layers, bf16, random weights from seed 0)
    and qwen2-moe-a2.7b, falcon-mamba-7b and recurrentgemma-9b at full
    width with 2, 4 and 3 layers (the last one ``(recurrent, recurrent,
    local)`` pattern), each through ``ServeEngine(max_batch=8)`` on
    lm_serving's 12 requests: B3 once per attention layer and bucket
    (falcon-mamba launches none), ids in range, the same tokens as a warm
    run, prefill logits within 2**-4 of the largest |logit| under
    ``"ref"``; prefill and decode ms, tokens/s, peak memory, the capacity
    path's dropped fraction; B3 per launch at the MoE families' (MHA,
    D = 128) and recurrentgemma's (MQA, D = 256, window 2048) buckets
    beside its plain version, SDPA and its bound. Then each in float32
    (no TF32) at a cut depth (deepseek-moe 2 layers): prefill of 192
    tokens then 8 decode steps within 1e-3 of the largest |logit| of
    ``forward`` over the 200, and greedy tokens under ``"pallas"`` and
    ``"ref"`` equal (or parting only at a top-2 gap below 1e-4).
14. lm_encdec (after lm_families): whisper-medium at full width and depth
    (24 encoder and 24 decoder layers) and internvl2-26b at full width and
    depth (48 layers, 39.7 GB), bf16, ``attn_impl="pallas"``, through
    ``Model.prefill`` (4 prompts of 64 tokens with 1500 seeded stub frames
    each; 4 of 256 tokens behind 256 seeded stub patch embeddings) and 31
    greedy ``decode`` steps: B3 once per attention in prefill (72: encoder,
    self and cross; 48), none in decode; ids in range and equal to a warm
    run's; whisper's cross cache filled; prefill logits within 2**-4 of
    the largest |logit| under ``"ref"``. Then B3 at the new shapes (the
    encoder's 1500 x 1500 and the cross S x 1500, non-causal, D = 64,
    k and v from an einsum as the model makes them; internvl2's causal
    256 + S, GQA 48/8) against its plain version, SDPA and its bound, and
    each model in float32 at 2 (+ 2) layers: prefill + decode within 1e-3
    of ``forward``, greedy tokens equal under "pallas" and "ref".
15. training (last): gemma-2b at full width and depth, float32 masters and
    bf16 compute, ``make_train_step`` with AdamW on ``SyntheticLM`` 8 x 1024
    batches for 10 steps: finite, falling loss, step s, tokens/s, peak
    memory; no kernel launched (B3 has no backward). The ``train()`` loop
    at full width and 1 layer, in a spawned process of its own that alone
    runs under ``torch.use_deterministic_algorithms`` and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, checkpoints in the system's
    temporary directory: 16 steps uninterrupted; 12 with a
    ``SimulatedFailure`` at step 10 (recovered from step 8); that directory
    resumed to 16: losses, weights and moments bitwise the uninterrupted
    run's. One whisper-medium step at full size with frames: encoder and
    cross-attention gradients finite and non-zero. B3 under autograd
    raises (``ops.attention`` and a "pallas" loss) without launching.
16. fsdp (after training): the FSDP training profile. deepseek-moe-16b at
    full width, depth 28 -> 2 (the dense layer 0 and one MoE layer, 1.09 B
    parameters), float32 masters and bf16 compute, under
    ``activate_mesh(mesh, TRAIN_FSDP_RULES)`` on gloo ranks sharing card 0
    (deterministic kernels), meshes (1, 1) and (2, 2) over ("data",
    "model"): ``make_train_state`` (each rank keeps its shards),
    ``make_train_step`` with AdamW on 4 ``SyntheticLM`` batches of 8 x 1024,
    then one forward of the rank's rows with ``attn_impl="pallas"``.
    Checks: on (1, 1) the losses, grad norms, parameters and moments are
    bitwise the unsharded step's; on (2, 2) each rank's CE and MoE terms of
    step 1 equal the unsharded loss on its rows (2048 tokens: the sorted
    path on both sides) within 1e-5, and its parameters after step 1 lie
    within 5e-5 of a one-process replay (rank 0: the four rows' gradients
    averaged, clipped, AdamW; grad_norm within 2**-8); each rank's resident
    state equals the specs' closed form (a quarter of (1, 1)'s) and its
    gathered and summed bytes a step theirs; the loss is finite and falls;
    no kernel launches in training; B3 once per attention layer per rank in
    the forward, logits within 2**-4 of the largest |logit| of "ref". Prints
    ms per step per mesh and rank, the bytes, peak memory per rank and the
    B3 launches.

The engine's surface above the session, on the main path's scale-22 graph
(after phase 3, 6 and 8; each with every count set to 0 just before it):

- packed_scan_path: ``execution="packed"`` (the tile sweep's plain
  version, by name) for 3 PageRank sweeps and the 8-root BFS batch: no B1
  launch, attrs bitwise equal to the same runs under ``packed_kernel``,
  model meters field-identical; ms per sweep.
- drivers: ``pagerank(g, iters=10)`` bitwise equal to the main path's
  PageRank; ``bfs(g, r)`` equal to the batch's member and ``multi_bfs``
  to the batch (fused); ``sssp``/``multi_sssp`` equal to the BFS depths as
  float32 (+inf unreached); one B1 launch per sweep; a second call gets
  the same cached session with no new staging; ms per sweep and job ms.
- baselines: ``TurboGraphLikeEngine`` over the per-block session, 10
  PageRank sweeps: bitwise equal to SPU per-block and packed, interval
  bytes per sweep exactly (P + non-empty blocks)·isz·Ba read and P·isz·Ba
  written; ms per sweep.
- host_path (after phase 6): host residency. First h2d_yardstick, a
  pinned and a pageable 1 GiB host→device copy (CUDA events, GB/s). Then,
  sharing the main path's staged graph, ``residency="host"`` under budget
  A (the main path's, below ``2·n_pad·Ba``: nothing pinned, 998 one-tile
  chunks) and budget B (``2·n_pad·Ba + m·Be/2``: SPU pins about half the
  tiles): PageRank SPU/DPU/MPU, 10 sweeps after a warm one, bitwise equal
  to device residency's, model meters identical, ``bytes_h2d`` = sweeps ×
  the closed form ``packed_kernel_h2d_bytes`` counted from the layout, B1
  launched once per pinned slab and streamed chunk; ms per sweep, achieved
  GB/s, the pinned-copy bound, the peak device memory above the session's
  baseline beside the layout's device tile bytes, and the device-busy
  share of a 2-sweep SPU run (torch.profiler). Under budget A also: the
  8-root BFS batch bitwise equal to the device batch, its ``bytes_h2d``
  the closed form over its activity log, and a K = 8 batch streaming the
  same bytes a sweep as K = 1; one selective BFS below a full stream and
  equal to its closed form; ``execution="packed"`` for 2 sweeps (the JAX
  package's leaves, ``packed_h2d_bytes``); per-block SPU/DPU/MPU for 3
  sweeps against device per-block (``streamed_block_bytes``); and
  ``pagerank(g, memory_budget=budget)``, host residency by default.
- disk_path (after host_path): disk residency. The main path's graph is
  written with ``write_dsss`` into a directory under ``build/`` (file
  bytes, write and ``open(verify=True)`` seconds, the filesystem), then
  evicted from the page cache (fsync, ``POSIX_FADV_DONTNEED``). Under
  budget A, ``GraphSession.open`` with ``host_memory_budget`` 0 and with
  half of the streamed tiles' leaf bytes: PageRank SPU/DPU/MPU for 3
  sweeps each (traced: the cold first sweep apart from the warm ones),
  bitwise equal to device residency's, model meters identical,
  ``bytes_disk_read`` = sweeps × ``packed_disk_bytes`` of the uncached
  tiles, ``bytes_h2d`` = sweeps × host residency's closed form, B1 once per
  chunk; host memory and peak device memory above the baselines; the
  registry's byte deltas equal the meters over a warm DPU run, whose device
  busy share is read (torch.profiler). The 8-root BFS batch from a cold
  cache, traced to a Chrome JSON file whose sweep spans
  ``trace_analysis.run_summaries`` sums to the meters; one per-block SPU
  sweep (``disk_read_bytes``). The external builder at R-MAT scale 18
  (``build_dsss_file`` over 2^20-edge chunks) against ``write_dsss`` of the
  same graph, byte for byte; the main path's SPU ms per sweep with the
  registry on and off, twice each. The file stays for the next two phases.
- reliability (after disk_path): crash → snapshot → resume through B1.
  Device residency, SPU PageRank, 10 sweeps, ``CheckpointSpec(every=2,
  keep=2)`` under the checkout's ``build/``, an injected crash at sweep 7
  (7 launches), the resume from sweep 6 (4 launches): attrs bitwise and
  meters field-identical (wall excepted) to the main path's run; snapshot
  bytes, save ms (``checkpoint`` spans) and restore ms. The same plan cut
  to 6 sweeps, crash at 5, at host residency (budget A) and from the file
  (``host_memory_budget`` 0), against their uninterrupted runs; the fused
  8-root BFS batch crashed at 3 and resumed through ``run_batch``; host
  residency under ``FaultPlan.h2d_transient(rate=0.03)`` (bits, meters and
  B1 launches equal to the clean run's, ``fired("h2d")`` > 0, ms a sweep
  with and without the plan); and ``GraphSession.open`` under a
  ``ReadPolicy`` with a torn ``p_dst`` read that heals.
- graph_serving (after reliability): a ``SessionPool`` holding the scale-22
  graph at device residency (the main path's staged state) and
  ``GraphServer(max_batch=8, max_wait_ms=2)``: 32 BFS requests from seeded
  distinct roots and 8 PageRank requests, each bitwise equal to a solo
  ``session.run``, each batch's ``split_meters`` shares recombining to its
  meters, one B1 launch per fused sweep; qps, occupancy, p50/p99 latency.
  In a batch of 8 personalized PageRank queries (200 sweeps), one request
  whose deadline (the set-up and half the sweep loop of a traced solo run
  of the batch) expires mid-run, at a sweep boundary, gets
  ``DeadlineExceeded`` while its 7 batch-mates, re-run, stay bitwise;
  ``multi_bfs(..., server=)`` equals the direct batch; the ``.dsss`` file
  registered again at disk residency (budget A) serves the main path's 8
  roots in one fused batch equal to the device batch. The file is deleted
  at the end.
- wcc_scc: ``wcc(el)`` and ``scc(el)`` on the scale-22 edge list: WCC
  labels equal the least vertex id of each of scipy's weak components, the
  SCC labels give scipy's strong partition; one B1 launch per sweep;
  rounds, sweeps, and host seconds (builds, trim) apart from the seconds
  in sessions.

Before the card's line, the ``kernels`` line gives each kernel's launches
on its paths (B1: main path, drivers, wcc_scc, host_path, disk_path,
reliability and graph_serving, by path in ``launches_by_path``; on the host and disk paths one launch per pinned
slab and streamed chunk; ``host_path`` gives its launches and ms per sweep
beside the pinned-copy bound, ``disk_path`` its launches and the cold and
warm ms per sweep), time, plain time, bound and library time; B2's are the pass
entry's, with ``calls_ms``/``calls_launches`` for the per-call form, and its
launches by path add the distributed phase's (with each mesh's ms per
iteration); B3's add lm_families', lm_encdec's (with their times at
the new shapes) and fsdp's.
The last line is ``{"ok": true, "device": {...}}``; any failed check raises
and the script exits non-zero. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.launch.timing import cuda_ms, device_busy, device_kernels, host_ms  # noqa: E402

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_PER_S = 67e12  # float32 outside the tensor cores
H100_BF16_TC_PER_S = 989e12  # bfloat16 on the tensor cores, dense


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


# -- kernel B2's pass entry ------------------------------------------------
def b2_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def b2_edge_case_pass(kops, dev, dtype, gather_op, reduce):
    """The JAX tests' five shapes, slots out of order, and a hand-made sub-shard, as one pass.

    The hand-made one has a run across three blocks, slots no edge reaches,
    a jump past the 512-slot window and slots past its last edge; two
    sources lie outside the first interval (NaN contribs); under a sum, zero
    weights meet negative and -0.0 values (-0.0 contribs).
    """
    ops, isizes, slots = [], [], []
    shapes = [(64, 100, 32, True), (300, 2000, 150, True), (128, 513, 128, True),
              (1000, 4096, 999, True), (16, 8, 4, True), (300, 2000, 150, False)]
    for isize, e, nslots, sorted_slots in shapes:
        r = np.random.default_rng(e + isize)
        src_local = r.integers(0, isize, e).astype(np.int32)
        hub_inv = r.integers(0, nslots, e).astype(np.int32)
        if sorted_slots:
            hub_inv = np.sort(hub_inv)
        w = r.random(e).astype(np.float32) + 0.1
        ops.append(kops.prepare_subshard_operands(
            src_local, hub_inv, w, dtype, gather_op=gather_op, reduce=reduce, device=dev))
        isizes.append(isize)
        slots.append(nslots)
    r = np.random.default_rng(7)
    hub_inv = np.concatenate([
        np.full(1400, 3), np.arange(4, 300), np.full(700, 900), np.arange(1000, 1604)
    ]).astype(np.int32)
    w = r.random(3000).astype(np.float32) + 0.1
    if reduce == "sum":
        w[::3] = 0.0
    ops.append(kops.prepare_subshard_operands(
        r.integers(0, 50, 3000).astype(np.int32), hub_inv, w, dtype,
        gather_op=gather_op, reduce=reduce, device=dev))
    isizes.append(50)
    slots.append(1800)
    src_idx = ops[0][0].clone()
    src_idx[[5, 40]] = torch.tensor([70, -2], dtype=torch.int32, device=dev)
    ops[0] = (src_idx, *ops[0][1:])
    vals = r.random(sum(isizes)).astype(np.float32) + 0.5
    vals[::7] *= -1
    vals[::11] = -0.0
    sp = kops.prepare_subshard_pass(
        ops, np.cumsum([0] + isizes[:-1]).tolist(), isizes, slots, gather_op=gather_op, reduce=reduce,
    )
    return sp, torch.from_numpy(vals).to(dtype).to(dev)


def b2_pass_case(dk, vals, sp, label) -> float:
    """The pass == its plain version == one subshard_update per sub-shard, bitwise, twice."""
    hubs, offsets = dk.subshard_update_pass(vals, sp)
    again, _ = dk.subshard_update_pass(vals, sp)
    want, _ = dk.subshard_update_pass_ref(vals, sp)
    torch.cuda.synchronize()
    check(torch.equal(b2_bits(hubs), b2_bits(again)), f"dsss_spmv pass not deterministic: {label}")
    check(torch.equal(b2_bits(hubs), b2_bits(want)), f"dsss_spmv pass != plain: {label}")
    fb = sp.first_block
    for k, (src_off, isize, num_slots, _) in enumerate(sp.meta.tolist()):
        e = slice(int(fb[k]) * dk.E_BLK, int(fb[k + 1]) * dk.E_BLK)
        one = dk.subshard_update(
            vals[src_off:src_off + isize], sp.src_idx[e], sp.hub_inv[e], sp.weights[e],
            sp.block_base[int(fb[k]):int(fb[k + 1])], num_slots, gather_op=sp.gather_op, reduce=sp.reduce,
        )
        check(torch.equal(b2_bits(one), b2_bits(hubs[offsets[k]:offsets[k + 1]])),
              f"dsss_spmv pass != subshard_update on sub-shard {k}: {label}")
    diff = (hubs.double() - want.double()).abs()
    diff = diff[torch.isfinite(diff)]
    return float(diff.max()) if diff.numel() else 0.0


# -- the LM serving path (kernel B3) ---------------------------------------
LM_ARCH = "gemma-2b"  # full width and depth: 18 layers, d_model 2048, head 256, MQA
LM_BUCKETS = ((8, 1024), (4, 2048))  # (requests, prompt length): two buckets
LM_NEW_TOKENS = 32
B3_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # the JAX tests' bounds
# bf16 also: each query row within two bf16 steps of its largest |value|
# (one step is at most 2**-7 of it), whatever the values' scale.
B3_BF16_ROW = 2.0**-6


def b3_row_ratio(got, want) -> float:
    """The largest, over query rows, of max |got - want| / max |want|."""
    g, w = got.float(), want.float()
    num = (g - w).abs().amax(-1)
    return float((num / w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)).max())


def b3_close(got, want, label: str) -> tuple[float, float | None]:
    """Hold B3's output to its plain version's: the JAX tests' bound, and for
    bf16 the row bar. Returns (max abs error, row ratio or None)."""
    tol = B3_TOL[want.dtype]
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isclose(got.float(), want.float(), rtol=tol, atol=tol).all()),
          f"flash_attention != plain (max abs err {err}): {label}")
    if want.dtype != torch.bfloat16:
        return err, None
    ratio = b3_row_ratio(got, want)
    check(ratio <= B3_BF16_ROW, f"flash_attention != plain: a row off by {ratio} of its largest |value|: {label}")
    return err, ratio


def b3_work(q, k, causal=True, window=None):
    """(least bytes, operations) of one attention call: q, k, v and out each
    moved once; 4·D operations per visible (query, key) pair."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        vis &= qp >= kp
    if window is not None:
        vis &= qp - kp < window
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes, 4 * d * b * hq * int(vis.sum())


def b3_bound_ms(nbytes: int, ops: int, dtype) -> tuple[float, str, float]:
    """(bound ms, what bounds it, the float32 CUDA-core floor in ms). The
    bound takes the card's fastest rate for the input type: the tensor
    cores' for bfloat16, the CUDA cores' for float32."""
    rate = H100_BF16_TC_PER_S if dtype == torch.bfloat16 else H100_FP32_PER_S
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", 1e3 * ops / H100_FP32_PER_S


def b3_build_report(build) -> dict:
    """What ptxas said about each body of B3, and its SASS's tensor-core instructions."""
    import re

    kernels = {}
    log = build.build_log.get("flash_attention", "")
    for part in log.split("Compiling entry function ")[1:]:
        name = part.split("'")[1]
        body = "tensor_cores" if "flash_tc_kernel" in name else "cuda_cores"
        dp = re.search(r"Li(\d+)E", name).group(1)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        kernels[f"{body}_D{dp}"] = {
            "registers": int(re.search(r"Used (\d+) registers", part).group(1)),
            "spill_store_bytes": int(spills.group(1)), "spill_load_bytes": int(spills.group(2)),
        }
    serialized = re.findall(r"C7512\) Potential Performance Loss: wgmma.mma_async instructions "
                            r"are serialized[^']*'[^']*Li(\d+)E", log)
    for dp in serialized:
        kernels[f"tensor_cores_D{dp}"]["wgmma_serialized"] = True
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build._target("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    # ptxas counts registers at entry; after setmaxnreg the tensor-core
    # body's consumers may use more: the highest register its SASS names.
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        dp = re.search(r"Li(\d+)E", name)
        key = f"{'tensor_cores' if 'flash_tc_kernel' in name else 'cuda_cores'}_D{dp.group(1)}" if dp else None
        if key in kernels:
            kernels[key]["sass_highest_register"] = max(int(r) for r in re.findall(r"\bR(\d+)\b", func))
    return {"ptxas": kernels,
            "sass": {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}}


def flash_attention_vs_plain(dev) -> dict:
    """B3 against its plain version: the JAX tests' cases and the serving shapes."""
    from repro_torch.kernels import flash_attention as fa

    cases = [((2, 4, 4, 64, 64, 32), {}), ((1, 8, 2, 128, 128, 64), {}),
             ((1, 4, 1, 96, 160, 32), {}), ((2, 16, 8, 32, 32, 128), {}),
             ((1, 2, 2, 257, 130, 64), {})]
    cases += [((1, 4, 2, 128, 128, 32), {"window": w}) for w in (1, 8, 64, 1024)]
    cases += [((1, 4, 4, 64, 64, 32), {"softcap": c}) for c in (1.0, 30.0, 50.0)]
    cases += [((2, 4, 4, 64, 96, 32), {"causal": False}),
              ((1, 4, 2, 1000, 777, 64), {}),  # ragged: no length a multiple of a block
              ((1, 4, 2, 999, 999, 48), {"window": 100, "softcap": 30.0}),
              ((1, 4, 2, 96, 32, 32), {"window": 8}),  # rows past 38 see no key
              ((8, 8, 1, 1024, 1024, 256), {}), ((4, 8, 1, 2048, 2048, 256), {}),  # gemma-2b
              ((1, 16, 8, 2048, 2048, 256), {"window": 4096, "softcap": 50.0}),  # gemma2-9b
              ((1, 40, 8, 1024, 1024, 128), {}),  # qwen2.5-14b
              ((8, 16, 16, 1024, 1024, 128), {}), ((4, 16, 16, 2048, 2048, 128), {}),  # the MoE families
              ((8, 16, 1, 1024, 1024, 256), {"window": 2048}),  # recurrentgemma-9b's local layers
              ((4, 16, 1, 2048, 2048, 256), {"window": 2048}),
              ((4, 16, 16, 1500, 1500, 64), {"causal": False}),  # whisper-medium's encoder
              ((4, 16, 16, 64, 1500, 64), {"causal": False}),  # its cross-attention
              ((4, 48, 8, 512, 512, 128), {})]  # internvl2-26b: 256 patches + 256 tokens
    n = 0
    max_abs_err = 0.0
    readings = []
    t0 = time.perf_counter()
    before = fa.launches
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, sq, sk, d), kw in cases:
            kw = {"causal": True, **kw}
            r = np.random.default_rng(sq * 7 + sk + d)
            q, k, v = (
                torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)
                for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
            )
            got = fa.flash_attention(q, k, v, **kw)
            again = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            label = f"{dtype} {(b, hq, hkv, sq, sk, d)} {kw}"
            check(torch.equal(got, again), f"flash_attention not deterministic: {label}")
            check(bool(torch.isfinite(got).all()), f"flash_attention not finite: {label}")
            err, ratio = b3_close(got, want, label)
            if kw.get("window") == 8 and sq > sk:
                check(bool((got[:, :, sk + 7:] == 0).all()), f"fully masked rows not 0: {label}")
            if ratio is not None:
                readings.append([(b, hq, hkv, sq, sk, d), kw, err, ratio])
            max_abs_err = max(max_abs_err, err)
            n += 1
            del q, k, v, got, again, want
    tail = b3_tail_mask(dev)
    emit(
        "flash_attention_vs_plain", cases=n, launches=fa.launches - before,
        max_abs_err=max_abs_err, tolerance={"float32": 2e-5, "bfloat16": 3e-2, "bfloat16_row": B3_BF16_ROW},
        bf16_max_row_ratio=max(r[3] for r in readings), bf16_readings=readings, tail_mask=tail,
        repeat_bitwise=True, seconds=time.perf_counter() - t0,
    )
    return {"max_abs_err": max(max_abs_err, *(t["max_abs_err"] for t in tail)), "cases": n + len(tail)}


def b3_tail_mask(dev) -> list:
    """B3 non-causal at whisper's shapes (Sk = 1500 ends in a 28-key tile),
    built so that a key past Sk shows: q ≈ +1 and k ≈ -1 give every score
    near -8, with v ≈ 1; k and v are views of buffers of Sk + 64 rows whose
    extra rows hold keys of score near +8 and values of 100. Reading past Sk
    pulls the output toward 100; a zero-filled tail left unmasked (score 0,
    value 0) pulls it toward 0. Both leaks, made in the plain version, are
    checked to land far outside the bar."""
    from repro_torch.kernels import flash_attention as fa

    out = []
    for name, (b, hq, hkv, sq, sk, d) in (("encoder", (4, 16, 16, 1500, 1500, 64)),
                                          ("cross", (4, 16, 16, 64, 1500, 64))):
        g = torch.Generator(device=dev).manual_seed(sq + sk)
        q = 1 + 0.3 * torch.randn((b, hq, sq, d), generator=g, device=dev)
        kb = -1 + 0.3 * torch.randn((b, hkv, sk + 64, d), generator=g, device=dev)
        vb = 1 + 0.5 * torch.randn((b, hkv, sk + 64, d), generator=g, device=dev)
        kb[:, :, sk:], vb[:, :, sk:] = 1.0, 100.0
        tile = -(-sk // 64) * 64
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dtype), kb.to(dtype), vb.to(dtype)
            k, v = kd[:, :, :sk], vd[:, :, :sk]
            got = fa.flash_attention(qd, k, v, causal=False)
            want = fa.flash_attention_ref(qd, k, v, causal=False)
            torch.cuda.synchronize()
            label = f"tail mask {name} {dtype}"
            err, ratio = b3_close(got, want, label)
            leaks = {
                "read_past_sk": fa.flash_attention_ref(qd, kd[:, :, :tile], vd[:, :, :tile], causal=False),
                "zero_fill": fa.flash_attention_ref(
                    qd, torch.cat([k, torch.zeros_like(kd[:, :, sk:tile])], 2),
                    torch.cat([v, torch.zeros_like(vd[:, :, sk:tile])], 2), causal=False),
            }
            leak_ratio = {n: b3_row_ratio(lk, want) for n, lk in leaks.items()}
            check(min(leak_ratio.values()) > 10 * B3_BF16_ROW, f"{label}: a leak would pass: {leak_ratio}")
            out.append({"name": name, "dtype": str(dtype), "shape": [b, hq, hkv, sq, sk, d], "max_abs_err": err,
                        "row_ratio": ratio, "leak_row_ratio": leak_ratio, "mean_out": float(want.float().mean()),
                        "tma_copy": [fa._tma_rows(t) is not t for t in (k, v)] if dtype == torch.bfloat16 else None})
            del got, want, leaks
    return out


def lm_requests(cfg, request_cls) -> list:
    """8 prompts of 1024 tokens and 4 of 2048, ids from numpy's rng seed 0."""
    rng = np.random.default_rng(0)
    reqs = []
    for count, length in LM_BUCKETS:
        for _ in range(count):
            prompt = rng.integers(0, cfg.vocab_size, length).tolist()
            reqs.append(request_cls(len(reqs), prompt, max_new_tokens=LM_NEW_TOKENS))
    return reqs


def serve(engine, requests) -> dict:
    for r in requests:
        engine.submit(r)
    out = engine.run()
    torch.cuda.synchronize()
    return out


def lm_serving(dev, smi, cfg) -> dict:
    """ServeEngine at full width, bf16, attn_impl="pallas": the LM main path."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving.llm_demo import Request, ServeEngine

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = lm_requests(cfg, Request)
    warm = serve(ServeEngine(cfg, params, max_batch=8), requests)  # cuBLAS and the kernel warm up
    engine = ServeEngine(cfg, params, max_batch=8)
    requests = lm_requests(cfg, Request)
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)  # weights and what earlier phases hold
    ps.launches = 0  # every count to 0 just before the LM serving path
    dk.launches = 0
    fa.launches = 0
    t1 = time.perf_counter()
    results = serve(engine, requests)
    run_s = time.perf_counter() - t1
    counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    want = len(LM_BUCKETS) * cfg.num_layers
    check(counts == {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": want},
          f"LM serving launched {counts}; want {want} flash_attention launches (one per layer and bucket)")
    check(sorted(results) == list(range(len(requests))), "LM serving lost a request")
    for rid, toks in results.items():
        check(len(toks) == LM_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {rid}: {len(toks)} tokens, ids {min(toks)}..{max(toks)}")
    check(results == warm, "greedy tokens differ between two runs of the engine")

    # The prefill's last logits against the same weights with attn_impl="ref".
    # Both compute attention in float32 and round its output to bfloat16;
    # their sums differ in order by float32 ulps, so an output near a bf16
    # rounding boundary moves by one bf16 ulp, and that passes through 18 bf16
    # layers. Bound: 2**-4 of the largest |logit| (8 bf16 ulps of it).
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    logits_check = {}
    by_len = {}
    for r in requests:
        by_len.setdefault(len(r.prompt), []).append(r.prompt)
    for length, prompts in by_len.items():
        toks = torch.tensor(prompts, device=dev)
        got = prefill(cfg, params, toks, length + LM_NEW_TOKENS + 1)[0].float()
        want_l = prefill(ref_cfg, params, toks, length + LM_NEW_TOKENS + 1)[0].float()
        check(bool(torch.isfinite(got).all()), f"prefill logits not finite at {length}")
        top = float(want_l.abs().max())
        err = float((got - want_l).abs().max())
        agree = float((got.argmax(-1) == want_l.argmax(-1)).float().mean())
        check(err <= 2**-4 * top, f"prefill logits (pallas vs ref) differ by {err} at max |logit| {top}")
        logits_check[length] = {"max_abs_diff": err, "max_abs_logit": top, "argmax_agree": agree}

    # Where a bucket's time goes: the first bucket's prefill, then 4 decode
    # steps, each in its own torch.profiler window (device events by name).
    count, length = LM_BUCKETS[0]
    toks = torch.tensor(by_len[length][:count], device=dev)

    def traced(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        by_name: dict[str, float] = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
        busy_ms = sum(by_name.values()) / 1e3
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
        return out, {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_busy_share": busy_ms / wall_ms, "top_device_us": top}

    (logits, cache), prefill_trace = traced(lambda: prefill(cfg, params, toks, length + 5))

    def four_steps():
        lg, c = logits, cache
        for step in range(4):
            nxt = lg[:, 0, : cfg.vocab_size].argmax(-1)[:, None]
            lg, c = decode_step(cfg, params, c, nxt, length + step)
        return lg

    _, decode_trace = traced(four_steps)
    breakdown = {f"prefill_{count}x{length}": prefill_trace,
                 f"decode_4_steps_{count}x{length}": decode_trace}
    del logits, cache
    # B3 per launch at each bucket's shapes, as attn_apply passes them: q, k
    # and v made (B, S, H, D) and transposed to (B, H, S, D).
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_bucket = {}
    for count, length in LM_BUCKETS:
        g = torch.Generator(device=dev).manual_seed(length)
        q, k, v = (
            torch.randn((count, length, h, d), generator=g, device=dev, dtype=torch.bfloat16).transpose(1, 2)
            for h in (hq, hkv, hkv)
        )
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=10)
        plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True), reps=3)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=10)
        qf, kf, vf = q.float(), k.float(), v.float()  # the float32 body, same strides
        f32_ms = cuda_ms(lambda: fa.flash_attention(qf, kf, vf, causal=True), reps=5)
        nbytes, ops = b3_work(q, k)
        bound, bound_by, f32_floor = b3_bound_ms(nbytes, ops, q.dtype)
        per_bucket[f"{count}x{length}"] = {
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "share_of_bound": bound / ms, "tflops": ops / ms / 1e9, "library_tflops": ops / lib / 1e9,
            "f32_ms": f32_ms, "f32_cuda_core_floor_ms": f32_floor, "min_bytes": nbytes, "ops": ops,
        }
        del q, k, v, qf, kf, vf
    emit("b3_timing", arch=cfg.name, shapes={"Hq": hq, "Hkv": hkv, "D": d, "causal": True},
         per_bucket=per_bucket, nvidia_smi=smi)
    stats = engine.stats
    n_tokens = sum(len(t) for t in results.values())
    emit(
        "lm_serving", arch=cfg.name, dtype=cfg.dtype, attn_impl=cfg.attn_impl,
        params=cfg.num_params(), layers=cfg.num_layers, requests=len(requests),
        buckets=[[s["batch"], s["prompt_len"]] for s in stats], launches=counts,
        prefill_ms={f"{s['batch']}x{s['prompt_len']}": 1e3 * (s["first_token_s"] - s["started_s"])
                    for s in stats},
        ttft_ms={f"{s['batch']}x{s['prompt_len']}": 1e3 * s["first_token_s"] for s in stats},
        decode_ms_per_token={f"{s['batch']}x{s['prompt_len']}": 1e3 * s["decode_s"] / s["decode_steps"]
                             for s in stats},
        tokens_per_s=n_tokens / run_s, run_s=run_s, generated_tokens=n_tokens,
        prefill_logits_vs_ref=logits_check, trace=breakdown,
        init_s=init_s, peak_device_bytes=peak, peak_above_start_bytes=peak - start_bytes,
        weight_bytes=sum(t.numel() * t.element_size() for t in params.parameters()),
        nvidia_smi=smi,
    )
    # Per launch over the main path: half its launches at each bucket shape.
    mean = {key: float(np.mean([b[key] for b in per_bucket.values()]))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"launches": counts["flash_attention"], **mean,
            "bound_by": per_bucket[f"{LM_BUCKETS[-1][0]}x{LM_BUCKETS[-1][1]}"]["bound_by"]}


def lm_serving_f32(dev, cfg) -> None:
    """The same requests in float32, attn_impl "pallas" then "ref": greedy tokens equal."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.llm_demo import Request, ServeEngine

    # Full float32 products on both paths (no TF32), stated and set.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    results, launches, run_s = {}, {}, {}
    for impl in ("pallas", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        fa.launches = 0
        t0 = time.perf_counter()
        results[impl] = serve(ServeEngine(c, params, max_batch=8), lm_requests(c, Request))
        run_s[impl] = time.perf_counter() - t0
        launches[impl] = fa.launches
    want = len(LM_BUCKETS) * cfg.num_layers
    check(launches == {"pallas": want, "ref": 0}, f"float32 serving launches {launches}")
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    prompts = {r.request_id: r.prompt for r in lm_requests(cfg, Request)}
    parted = []
    for rid, got in results["pallas"].items():
        want_t = results["ref"][rid]
        if got == want_t:
            continue
        step = next(i for i, (a, b) in enumerate(zip(got, want_t)) if a != b)
        toks = torch.tensor([prompts[rid] + want_t[:step]], device=dev)
        logits = prefill(ref_cfg, params, toks, toks.shape[1] + 1)[0][0, 0, : cfg.vocab_size].float()
        top2 = torch.topk(logits, 2).values
        gap = float(top2[0] - top2[1])
        parted.append({"request": rid, "step": step, "top2_gap": gap, "top_logit": float(top2[0])})
        check(gap < 1e-4 * abs(float(top2[0])),
              f"float32 request {rid} parts at step {step} with a top-2 gap of {gap}")
    emit(
        "lm_serving_f32", arch=cfg.name, dtype=cfg.dtype, allow_tf32=False, launches=launches,
        requests=len(prompts), tokens_equal=not parted, parted=parted, run_s=run_s,
        peak_device_bytes=torch.cuda.max_memory_allocated(dev),
        peak_above_start_bytes=torch.cuda.max_memory_allocated(dev) - start_bytes,
    )


# -- the MoE, Mamba and RG-LRU families on the serving path (ROADMAP A13.1) --
# (architecture, layers served in bf16: None is the full depth, layers in
# the float32 check). Widths are never cut.
LM_FAMILIES = (
    ("deepseek-moe-16b", None, 2),  # 28 layers, 16.4 B parameters; f32: the dense layer and one MoE layer
    ("qwen2-moe-a2.7b", 2, 2),
    ("falcon-mamba-7b", 4, 4),
    ("recurrentgemma-9b", 3, 3),  # one (recurrent, recurrent, local) pattern
)
F32_PROMPT, F32_DECODE = 200, 8  # 1 × 200 tokens: the MoE's dropless path, past a Mamba chunk


def cut(cfg, layers):
    import dataclasses

    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def family_serving(dev, smi, cfg) -> dict:
    """ServeEngine over one family at full width in bf16, attn_impl="pallas"."""
    import dataclasses

    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.models import init_params, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.llm_demo import Request, ServeEngine

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    _sync(dev)
    init_s = time.perf_counter() - t0
    warm = serve(ServeEngine(cfg, params, max_batch=8), lm_requests(cfg, Request))
    engine = ServeEngine(cfg, params, max_batch=8)
    requests = lm_requests(cfg, Request)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    ps.launches = 0  # every count to 0 just before the family's serving path
    dk.launches = 0
    fa.launches = 0
    t1 = time.perf_counter()
    results = serve(engine, requests)
    run_s = time.perf_counter() - t1
    counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attn_layers = sum(k in ("global", "local") for k in cfg.layer_kinds())
    want = len(LM_BUCKETS) * attn_layers
    check(counts == {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": want},
          f"{cfg.name}: launched {counts}; want {want} flash_attention launches (attention layers x buckets)")
    check(sorted(results) == list(range(len(requests))), f"{cfg.name}: serving lost a request")
    for rid, toks in results.items():
        check(len(toks) == LM_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks),
              f"{cfg.name} request {rid}: {len(toks)} tokens, ids {min(toks)}..{max(toks)}")
    check(results == warm, f"{cfg.name}: greedy tokens differ between two runs of the engine")
    # Each bucket's prefill logits against the same weights under attn_impl="ref"
    # (as gemma-2b's). This untimed prefill of the served batches also records
    # the capacity path's dropped share, which serving does not ask for.
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    logits_check = {}
    by_len = {}
    for r in requests:
        by_len.setdefault(len(r.prompt), []).append(r.prompt)
    dropped = []  # per MoE layer call on the capacity path
    apply = moe_mod.moe_apply

    def recording(moe, x, c, *, return_aux=True):
        y, aux = apply(moe, x, c, return_aux=True)
        if x.shape[0] * x.shape[1] > moe_mod.DENSE_PATH_MAX_TOKENS:
            dropped.append(aux["dropped_fraction"])
        return y, (aux if return_aux else {})

    for length, prompts in by_len.items():
        toks = torch.tensor(prompts, device=dev)
        moe_mod.moe_apply = recording
        try:
            got = prefill(cfg, params, toks, length + LM_NEW_TOKENS + 1)[0].float()
        finally:
            moe_mod.moe_apply = apply
        want_l = prefill(ref_cfg, params, toks, length + LM_NEW_TOKENS + 1)[0].float()
        check(bool(torch.isfinite(got).all()), f"{cfg.name}: prefill logits not finite at {length}")
        top = float(want_l.abs().max())
        err = float((got - want_l).abs().max())
        agree = float((got.argmax(-1) == want_l.argmax(-1)).float().mean())
        check(err <= 2**-4 * top, f"{cfg.name}: prefill logits (pallas vs ref) differ by {err} at max |logit| {top}")
        logits_check[length] = {"max_abs_diff": err, "max_abs_logit": top, "argmax_agree": agree}
    stats = engine.stats
    n_tokens = sum(len(t) for t in results.values())
    out = {
        "arch": cfg.name, "layers": cfg.num_layers, "params": cfg.num_params(), "launches": counts,
        "b3_launches_expected": want,
        "buckets": [[s["batch"], s["prompt_len"]] for s in stats],
        "prefill_ms": {f"{s['batch']}x{s['prompt_len']}": 1e3 * (s["first_token_s"] - s["started_s"]) for s in stats},
        "decode_ms_per_token": {f"{s['batch']}x{s['prompt_len']}": 1e3 * s["decode_s"] / s["decode_steps"]
                                for s in stats},
        "tokens_per_s": n_tokens / run_s, "run_s": run_s, "init_s": init_s,
        "peak_device_bytes": peak, "peak_above_start_bytes": peak - start_bytes,
        "weight_bytes": sum(t.numel() * t.element_size() for t in params.parameters()),
        "prefill_logits_vs_ref": logits_check,
    }
    if dropped:
        out["dropped_fraction"] = {"mean": float(torch.stack(dropped).mean()),
                                   "max": float(torch.stack(dropped).max()), "moe_calls": len(dropped)}
    if attn_layers == 0:
        out["note"] = "attention-free: no B3 launch"
    del params
    return out


def family_f32(dev, cfg) -> dict:
    """float32, no TF32: prefill then decode gives forward's logits, and greedy
    tokens agree under attn_impl "pallas" and "ref"."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.serving.llm_demo import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, F32_PROMPT))).to(dev)
    want, _ = forward(cfg, params, toks)
    cut_at = F32_PROMPT - F32_DECODE
    got, cache = prefill(cfg, params, toks[:, :cut_at], F32_PROMPT + 1)
    steps = [got]
    for p in range(cut_at, F32_PROMPT - 1):
        lg, cache = decode_step(cfg, params, cache, toks[:, p:p + 1], p)
        steps.append(lg)
    got = torch.cat(steps, 1).float()
    want = want[:, cut_at - 1:F32_PROMPT - 1].float()
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= 1e-3 * top, f"{cfg.name} f32: prefill + decode off forward by {err} at max |logit| {top}")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, F32_PROMPT).tolist() for _ in range(2)]
    results, launches = {}, {}
    for impl in ("pallas", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        fa.launches = 0
        reqs = [Request(i, p, max_new_tokens=F32_DECODE) for i, p in enumerate(prompts)]
        results[impl] = serve(ServeEngine(c, params, max_batch=8), reqs)
        launches[impl] = fa.launches
    attn_layers = sum(k in ("global", "local") for k in cfg.layer_kinds())
    check(launches == {"pallas": attn_layers, "ref": 0}, f"{cfg.name} f32 serving launches {launches}")
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    parted = []
    for rid, got_t in results["pallas"].items():
        want_t = results["ref"][rid]
        if got_t == want_t:
            continue
        step = next(i for i, (a, b) in enumerate(zip(got_t, want_t)) if a != b)
        t = torch.tensor([prompts[rid] + want_t[:step]], device=dev)
        lg = prefill(ref_cfg, params, t, t.shape[1] + 1)[0][0, 0, : cfg.vocab_size].float()
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        parted.append({"request": rid, "step": step, "top2_gap": gap, "top_logit": float(top2[0])})
        check(gap < 1e-4 * abs(float(top2[0])), f"{cfg.name} f32 request {rid} parts at step {step}, top-2 gap {gap}")
    del params
    return {"layers": cfg.num_layers, "decode_vs_forward_max_abs": err, "max_abs_logit": top,
            "tokens_equal": not parted, "parted": parted, "launches": launches}


def b3_shape_timing(dev, cfg) -> dict:
    """B3 per launch at a family's bucket shapes (as attn_apply passes them)
    beside its plain version, SDPA and its bound."""
    from repro_torch.kernels import flash_attention as fa

    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.window_size if "local" in cfg.pattern else None
    per_bucket = {}
    for count, length in LM_BUCKETS:
        g = torch.Generator(device=dev).manual_seed(length)
        q, k, v = (
            torch.randn((count, length, h, d), generator=g, device=dev, dtype=torch.bfloat16).transpose(1, 2)
            for h in (hq, hkv, hkv)
        )
        kw = {"causal": True, "window": window}
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=10)
        plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), reps=3)
        # SDPA has no window; these prompts are no longer than the window, so
        # causal attention is the same function.
        check(window is None or length <= window, "a window SDPA would not apply")
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=10)
        nbytes, ops = b3_work(q, k, window=window)
        bound, bound_by, _ = b3_bound_ms(nbytes, ops, q.dtype)
        per_bucket[f"{count}x{length}"] = {
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "share_of_bound": bound / ms, "tflops": ops / ms / 1e9, "min_bytes": nbytes, "ops": ops,
        }
        del q, k, v
    return {"Hq": hq, "Hkv": hkv, "D": d, "window": window, "per_bucket": per_bucket}


def lm_families(dev, smi) -> tuple[int, dict]:
    """deepseek-moe-16b at full width and depth, the other three families at
    full width and cut depth, in bf16; then each at a cut depth in float32."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    served, f32, timing = {}, {}, {}
    launches = 0
    for arch, layers, f32_layers in LM_FAMILIES:
        cfg = dataclasses.replace(cut(get_config(arch), layers), attn_impl="pallas")
        t1 = time.perf_counter()
        served[arch] = family_serving(dev, smi, cfg)
        launches += served[arch]["launches"]["flash_attention"]
        if any(k in ("global", "local") for k in cfg.pattern):
            timing[arch] = b3_shape_timing(dev, cfg)
        _empty_cache(dev)
        f32[arch] = family_f32(dev, dataclasses.replace(cut(get_config(arch), f32_layers), dtype="float32",
                                                        attn_impl="pallas"))
        _empty_cache(dev)
        served[arch]["phase_s"] = time.perf_counter() - t1
    emit("lm_families", served=served, float32=f32, b3_timing=timing, b3_launches=launches,
         phase_s=time.perf_counter() - t0, nvidia_smi=smi)
    return launches, timing


# -- whisper's encoder-decoder and internvl2's patch prefix (ROADMAP A13 item 2) --
# (architecture, decoder layers in bf16: None is the full depth, layers in
# the float32 check, prompts, prompt length). Widths are never cut.
LM_ENCDEC = (
    ("whisper-medium", None, 2, 4, 64),  # 24 + 24 layers; 1500 stub frames a prompt
    ("internvl2-26b", None, 2, 4, 256),  # 48 layers, 19.9 B parameters; 256 patches before each prompt
)
ENCDEC_NEW_TOKENS = 32


def _stub_inputs(cfg, dev, n, s, seed=1) -> tuple:
    """Token ids (numpy seed 0) and the stub inputs of a config (frames or
    patch embeddings, standard normal in bf16 from a seeded generator)."""
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (n, s))).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    extra = {}
    if cfg.is_enc_dec:
        extra["frames"] = torch.randn((n, cfg.encdec.encoder_frames, cfg.d_model), generator=g,
                                      device=dev, dtype=torch.bfloat16)
    if cfg.vision is not None:
        extra["patch_embeds"] = torch.randn((n, cfg.vision.num_patches, cfg.d_model), generator=g,
                                            device=dev, dtype=torch.bfloat16)
    return toks, extra


def _prefix_len(cfg) -> int:
    return cfg.vision.num_patches if cfg.vision is not None else 0


def b3_encdec_launches(cfg) -> int:
    """B3 launches of one prefill: every attention layer, and for an
    encoder-decoder every encoder layer and every cross-attention."""
    n = sum(k in ("global", "local") for k in cfg.layer_kinds())
    return n + 2 * cfg.encdec.num_encoder_layers if cfg.is_enc_dec else n


def encdec_serving(dev, cfg, n, s) -> dict:
    """prefill of n prompts (with their frames or patches) then 32 greedy
    decode steps, bf16, attn_impl="pallas"; prefill logits against "ref"."""
    import dataclasses

    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.models import Model

    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _sync(dev)
    init_s = time.perf_counter() - t0
    toks, extra = _stub_inputs(cfg, dev, n, s)
    max_len = _prefix_len(cfg) + s + ENCDEC_NEW_TOKENS

    def run():
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, toks, max_len, **extra)
        _sync(dev)
        prefill_ms = 1e3 * (time.perf_counter() - t1)
        after_prefill = fa.launches
        out = [logits[:, 0, : cfg.vocab_size].argmax(-1)]
        t1 = time.perf_counter()
        for i in range(ENCDEC_NEW_TOKENS - 1):
            logits, cache = model.decode(params, cache, out[-1][:, None], _prefix_len(cfg) + s + i)
            out.append(logits[:, 0, : cfg.vocab_size].argmax(-1))
        ids = torch.stack(out, 1).cpu()
        decode_ms = 1e3 * (time.perf_counter() - t1) / (ENCDEC_NEW_TOKENS - 1)
        return ids, prefill_ms, decode_ms, after_prefill, cache

    warm_ids, *_ = run()  # cuBLAS and the kernel warm up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    ps.launches = 0  # every count to 0 just before the served prompts
    dk.launches = 0
    fa.launches = 0
    ids, prefill_ms, decode_ms, after_prefill, cache = run()
    counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    want = b3_encdec_launches(cfg)
    check(counts == {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": want} and after_prefill == want,
          f"{cfg.name}: launched {counts} ({after_prefill} in prefill); want {want} flash_attention in prefill "
          "and none in decode")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"{cfg.name}: ids out of range")
    check(torch.equal(ids, warm_ids), f"{cfg.name}: greedy tokens differ between two runs")
    if cfg.is_enc_dec:
        ck = cache[0]["cross_kv"]["k"]
        check(tuple(ck.shape) == (n, cfg.encdec.encoder_frames, cfg.num_kv_heads, cfg.head_dim)
              and bool(torch.isfinite(ck).all()), f"{cfg.name}: cross cache {tuple(ck.shape)}")
    del cache
    # The prefill's last logits against the same weights under attn_impl="ref"
    # (the bound of gemma-2b's: 2**-4 of the largest |logit|).
    got = model.prefill(params, toks, max_len, **extra)[0].float()
    want_l = Model(dataclasses.replace(cfg, attn_impl="ref"), device=dev).prefill(
        params, toks, max_len, **extra)[0].float()
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: prefill logits not finite")
    top = float(want_l.abs().max())
    err = float((got - want_l).abs().max())
    agree = float((got.argmax(-1) == want_l.argmax(-1)).float().mean())
    check(err <= 2**-4 * top, f"{cfg.name}: prefill logits (pallas vs ref) differ by {err} at max |logit| {top}")
    out = {
        "arch": cfg.name, "layers": cfg.num_layers, "params": cfg.num_params(), "prompts": n,
        "prompt_len": s, "prefix": _prefix_len(cfg), "launches": counts, "b3_launches_expected": want,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "tokens_per_s": n * ENCDEC_NEW_TOKENS / (prefill_ms + decode_ms * (ENCDEC_NEW_TOKENS - 1)) * 1e3,
        "init_s": init_s, "peak_device_bytes": peak, "peak_above_start_bytes": peak - start_bytes,
        "weight_bytes": sum(t.numel() * t.element_size() for t in params.parameters()),
        "prefill_logits_vs_ref": {"max_abs_diff": err, "max_abs_logit": top, "argmax_agree": agree},
    }
    if cfg.is_enc_dec:
        out["encoder_layers"] = cfg.encdec.num_encoder_layers
        out["frames"] = cfg.encdec.encoder_frames
    del params, got, want_l
    return out


def encdec_f32(dev, cfg, s=200, steps=8) -> dict:
    """float32, no TF32, cut depth: prefill then decode gives forward's
    logits, and greedy tokens agree under attn_impl "pallas" and "ref"."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks, extra = _stub_inputs(cfg, dev, 1, s)
    extra = {k: v.float() for k, v in extra.items()}
    pre = _prefix_len(cfg)
    want, _ = model.apply(params, toks, **extra)
    cut_at = s - steps
    got, cache = model.prefill(params, toks[:, :cut_at], pre + s + 1, **extra)
    out = [got]
    for p in range(cut_at, s - 1):
        lg, cache = model.decode(params, cache, toks[:, p:p + 1], pre + p)
        out.append(lg)
    got = torch.cat(out, 1).float()
    want = want[:, pre + cut_at - 1:pre + s - 1].float()
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= 1e-3 * top, f"{cfg.name} f32: prefill + decode off forward by {err} at max |logit| {top}")
    seqs, launches = {}, {}
    for impl in ("pallas", "ref"):
        m = Model(dataclasses.replace(cfg, attn_impl=impl), device=dev)
        fa.launches = 0
        lg, c = m.prefill(params, toks, pre + s + steps, **extra)
        ids = [lg[:, 0, : cfg.vocab_size].argmax(-1)]
        for i in range(steps - 1):
            lg, c = m.decode(params, c, ids[-1][:, None], pre + s + i)
            ids.append(lg[:, 0, : cfg.vocab_size].argmax(-1))
        seqs[impl] = torch.stack(ids, 1)[0].tolist()
        launches[impl] = fa.launches
    check(launches == {"pallas": b3_encdec_launches(cfg), "ref": 0}, f"{cfg.name} f32 launches {launches}")
    parted = []
    if seqs["pallas"] != seqs["ref"]:
        step = next(i for i, (a, b) in enumerate(zip(seqs["pallas"], seqs["ref"])) if a != b)
        t = torch.cat([toks, torch.tensor([seqs["ref"][:step]], device=dev, dtype=toks.dtype)], 1)
        ref_model = Model(dataclasses.replace(cfg, attn_impl="ref"), device=dev)
        lg = ref_model.prefill(params, t, pre + t.shape[1] + 1, **extra)[0][0, 0, : cfg.vocab_size].float()
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        parted.append({"step": step, "top2_gap": gap, "top_logit": float(top2[0])})
        check(gap < 1e-4 * abs(float(top2[0])), f"{cfg.name} f32 parts at step {step}, top-2 gap {gap}")
    del params, cache
    return {"layers": cfg.num_layers, "decode_vs_forward_max_abs": err, "max_abs_logit": top,
            "tokens_equal": not parted, "parted": parted, "launches": launches}


def b3_encdec_timing(dev, cfg, n, s) -> dict:
    """B3 per launch at the shapes of one prefill, as attn_apply passes them,
    beside its plain version (max abs error), SDPA and its bound: whisper's
    encoder (non-causal, 1500 × 1500) and cross-attention (non-causal,
    ``s`` × 1500, k and v projected by einsum from an encoder output),
    internvl2's causal ``256 + s`` with GQA 48/8. Reports whether the
    wrapper copied any operand for TMA (``_tma_rows``)."""
    from repro_torch.kernels import flash_attention as fa

    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(7)

    def rows(length, heads):
        return torch.randn((n, length, heads, d), generator=g, device=dev, dtype=torch.bfloat16).transpose(1, 2)

    shapes = {}
    if cfg.is_enc_dec:
        t = cfg.encdec.encoder_frames
        shapes["encoder"] = (rows(t, hq), rows(t, hkv), rows(t, hkv), False)
        enc = torch.randn((n, t, cfg.d_model), generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.randn((cfg.d_model, hkv, d), generator=g, device=dev, dtype=torch.bfloat16) * cfg.d_model**-0.5
        k = torch.einsum("btd,dhk->bthk", enc, w).transpose(1, 2)  # as the cross step makes them
        v = torch.einsum("btd,dhk->bthk", enc, w.flip(0)).transpose(1, 2)
        shapes["cross"] = (rows(s, hq), k, v, False)
    else:
        length = _prefix_len(cfg) + s
        shapes["prefix_causal"] = (rows(length, hq), rows(length, hkv), rows(length, hkv), True)
    out = {}
    for name, (q, k, v, causal) in shapes.items():
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        err, ratio = b3_close(got, want, f"{cfg.name} {name}")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps=10)
        plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal), reps=3)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps=10)
        nbytes, ops = b3_work(q, k, causal=causal)
        bound, bound_by, _ = b3_bound_ms(nbytes, ops, q.dtype)
        out[name] = {
            "q": list(q.shape), "k": list(k.shape), "causal": causal, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
            "tflops": ops / ms / 1e9, "max_abs_err": err, "row_ratio": ratio,
            "tolerance": {"jax_tests": 3e-2, "row": B3_BF16_ROW},
            "tma_copy": [fa._tma_rows(t) is not t for t in (q, k, v)], "min_bytes": nbytes, "ops": ops,
        }
        del got, want
    return {"Hq": hq, "Hkv": hkv, "D": d, "shapes": out}


def lm_encdec(dev, smi) -> tuple[int, dict]:
    """whisper-medium at full width and depth and internvl2-26b at full width
    (and depth), bf16, through prefill and decode; each in float32 at a cut
    depth; B3 at their new shapes."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    served, f32, timing = {}, {}, {}
    launches = 0
    for arch, layers, f32_layers, n, s in LM_ENCDEC:
        t1 = time.perf_counter()
        cfg = dataclasses.replace(cut(get_config(arch), layers), attn_impl="pallas")
        served[arch] = encdec_serving(dev, cfg, n, s)
        launches += served[arch]["launches"]["flash_attention"]
        _empty_cache(dev)
        timing[arch] = b3_encdec_timing(dev, cfg, n, s)
        _empty_cache(dev)
        f32_cfg = dataclasses.replace(cut(get_config(arch), f32_layers), dtype="float32", attn_impl="pallas")
        if f32_cfg.is_enc_dec:
            f32_cfg = dataclasses.replace(f32_cfg, encdec=dataclasses.replace(f32_cfg.encdec,
                                                                              num_encoder_layers=f32_layers))
        f32[arch] = encdec_f32(dev, f32_cfg)
        _empty_cache(dev)
        served[arch]["phase_s"] = time.perf_counter() - t1
    emit("lm_encdec", served=served, float32=f32, b3_timing=timing, b3_launches=launches,
         phase_s=time.perf_counter() - t0, nvidia_smi=smi)
    return launches, timing


# -- training with float32 master weights (ROADMAP A13 item 3) ---------------
TRAIN_ARCH = "gemma-2b"  # full width and depth: 2.51 B parameters
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
LOOP_LAYERS, LOOP_SEQ, LOOP_BATCH = 1, 512, 8  # the train() loop: full width, depth cut 18 -> 1


def _no_kernel_counts(what: str, before: dict) -> None:
    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps

    counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(counts == before, f"{what} launched a kernel: {counts} against {before}")


def _zero_counts() -> dict:
    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps

    ps.launches = dk.launches = fa.launches = 0
    return {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": 0}


def train_steps(dev, cfg) -> dict:
    """make_train_step with AdamW over float32 masters, bf16 compute, for
    TRAIN_STEPS steps of SyntheticLM batches: finite, falling loss."""
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.train.state import decay_mask

    opt = AdamW(learning_rate=3e-4, weight_decay=0.01, decay_mask=decay_mask(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    _sync(dev)
    init_s = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated(dev)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    zero = _zero_counts()  # every count to 0 just before the training path
    losses, grad_norms, step_s = [], [], []
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
        _sync(dev)
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t1)
        grad_norms.append(float(m["grad_norm"]))
    _no_kernel_counts("training (B3 has no backward; attention runs as attn_impl='ref')", zero)
    check(all(np.isfinite(losses + grad_norms)), f"training: loss {losses}, grad norms {grad_norms}")
    check(losses[-1] < losses[0], f"training: the loss did not fall: {losses}")
    check(int(state["step"]) == TRAIN_STEPS, f"training: state step {int(state['step'])}")
    warm = sorted(step_s[1:])
    med = warm[len(warm) // 2]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": cfg.num_params(), "batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses, "grad_norms": grad_norms,
           "step_s": step_s, "median_step_s": med, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "init_s": init_s, "state_bytes": state_bytes, "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
           "compute_dtype": cfg.dtype, "master_dtype": cfg.param_dtype, "attn_impl": cfg.attn_impl}
    del state, step
    return out


def train_loop(dev, cfg) -> dict:
    """The train() loop at full width and cut depth, deterministic: an
    uninterrupted run of 16 steps; a run of 12 with a SimulatedFailure at step
    10 (recovered from the checkpoint at 8); that directory resumed to 16.
    Losses, final weights and moments bitwise the uninterrupted run's.
    Checkpoints go to the system's temporary directory, not the checkout."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.reliability.faults import FailureInjector
    from repro_torch.train.loop import TrainLoopConfig, train

    root = tempfile.mkdtemp(prefix="train-loop-")
    where = {"filesystem": mount_of(root), "free_bytes": shutil.disk_usage(root).free}

    def loop(name, total, every):
        return TrainLoopConfig(total_steps=total, checkpoint_every=every, checkpoint_dir=os.path.join(root, name),
                               keep=1, seq_len=LOOP_SEQ, global_batch=LOOP_BATCH, log_every=0)

    runs = {}
    zero = _zero_counts()
    try:
        # 4 checkpoints in all (each ~7.6 GB): the reference run saves only at
        # its end, the failing run at 8 and 12, the resumed run at 16.
        for name, total, every, kw in (
                ("uninterrupted", 16, 16, {}),
                ("failure", 12, 8, {"failure_injector": FailureInjector((10,))}),
                ("resumed", 16, 8, {})):
            t0 = time.perf_counter()
            runs[name] = train(cfg, loop("u" if name == "uninterrupted" else "f", total, every), device=dev, **kw)
            _sync(dev)
            runs[name]["run_s"] = time.perf_counter() - t0
        ckpt = CheckpointManager(os.path.join(root, "f"))
        steps = ckpt.all_steps()
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                         os.walk(os.path.join(root, "f", f"step_{steps[-1]:010d}")) for f in fs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _no_kernel_counts("the train() loop", zero)
    u, f, r = runs["uninterrupted"], runs["failure"], runs["resumed"]
    check(u["final_step"] == 16 and u["recoveries"] == 0, f"uninterrupted run: {u['final_step']}, {u['recoveries']}")
    check(f["recoveries"] == 1 and f["final_step"] == 12, f"failure run: {f['final_step']}, {f['recoveries']}")
    check(f["losses"] == u["losses"][:10] + u["losses"][8:12],
          f"the recovered run's losses {f['losses']} are not the uninterrupted run's {u['losses']}")
    check(r["losses"] == u["losses"][12:16],
          f"the resumed run's losses {r['losses']} are not the uninterrupted run's {u['losses']}")
    pu = dict(u["state"]["params"].named_parameters())
    pr = dict(r["state"]["params"].named_parameters())
    check(all(torch.equal(pu[n], pr[n]) for n in pu), "resumed weights are not the uninterrupted run's bits")
    check(all(torch.equal(u["state"]["opt_state"][k][n], r["state"]["opt_state"][k][n])
              for k in ("mu", "nu") for n in pu), "resumed moments are not the uninterrupted run's bits")
    check(u["last_loss"] < u["first_loss"], f"loop: the loss did not fall: {u['losses']}")
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": cfg.num_params(), "batch": LOOP_BATCH,
           "seq_len": LOOP_SEQ, "checkpoints": 4, "checkpoint_bytes": ckpt_bytes, "checkpoint_dir": where,
           "deterministic": True, "bitwise_resume": True,
           "runs": {k: {"final_step": v["final_step"], "recoveries": v["recoveries"], "losses": v["losses"],
                        "run_s": v["run_s"], "stragglers": len(v["stragglers"])} for k, v in runs.items()}}
    del runs, u, f, r, pu, pr
    return out


def train_loop_process(cfg, device: str) -> dict:
    """:func:`train_loop` in a process of its own, made deterministic there
    alone: cuBLAS with a fixed workspace (``CUBLAS_WORKSPACE_CONFIG``, set
    before this process first calls cuBLAS) and PyTorch's deterministic
    kernels (the embedding's and the gather's backward), so a replayed step
    gives the same bits. The smoke's other phases keep the defaults."""
    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        return pool.submit(_deterministic_train_loop, cfg, device).result()


def _deterministic_train_loop(cfg, device: str) -> dict:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    return train_loop(torch.device(device), cfg)


def train_encdec_step(dev) -> dict:
    """One whisper-medium step at full width and depth with frames: the
    encoder's and the cross-attention's gradients finite and non-zero."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW
    from repro_torch.train import make_loss_fn, make_train_state, make_train_step
    from repro_torch.train.state import decay_mask

    cfg = get_config("whisper-medium")
    opt = AdamW(learning_rate=3e-4, weight_decay=0.01, decay_mask=decay_mask(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    state = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    toks, extra = _stub_inputs(cfg, dev, 2, 129)
    batch = {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int(), **extra}
    zero = _zero_counts()
    loss, _ = make_loss_fn(cfg)(state["params"], batch)
    loss.backward()
    named = dict(state["params"].named_parameters())
    norms = {n: float(p.grad.float().norm()) for n, p in named.items()}
    check(all(np.isfinite(list(norms.values()))), "whisper: a gradient is not finite")
    groups = {"encoder": [n for n in norms if n.startswith("encoder.")],
              "cross": [n for n in norms if ".cross." in n or ".lnx." in n]}
    for g, names in groups.items():
        check(names and all(norms[n] > 0 for n in names),
              f"whisper: {g} gradients zero: {[n for n in names if norms[n] == 0][:5]}")
    for p in named.values():
        p.grad = None
    _sync(dev)
    t0 = time.perf_counter()
    state, m = make_train_step(cfg, opt)(state, batch)
    loss_step = float(m["loss"])
    step_s = time.perf_counter() - t0
    _no_kernel_counts("the whisper step", zero)
    check(np.isfinite(loss_step), f"whisper step loss {loss_step}")
    out = {"arch": cfg.name, "layers": cfg.num_layers, "encoder_layers": cfg.encdec.num_encoder_layers,
           "params": cfg.num_params(), "batch": 2, "seq_len": 128, "frames": cfg.encdec.encoder_frames,
           "loss": float(loss.detach()), "step_loss": loss_step, "step_s": step_s,
           "grad_norm_encoder": float(np.sqrt(sum(norms[n] ** 2 for n in groups["encoder"]))),
           "grad_norm_cross": float(np.sqrt(sum(norms[n] ** 2 for n in groups["cross"]))),
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    del state, loss
    return out


def b3_autograd_raises(dev) -> dict:
    """B3 has no backward: under autograd the kernel entry raises, on the card,
    before any launch, and a loss under attn_impl="pallas" too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import attention
    from repro_torch.train import make_loss_fn, make_train_state
    from repro_torch.optim import AdamW

    q = torch.randn((1, 4, 64, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    k = v = torch.randn((1, 4, 64, 64), device=dev, dtype=torch.bfloat16)
    before = fa.launches
    msgs = []
    try:
        attention(q, k, v, use_kernel=True)
    except RuntimeError as e:
        msgs.append(str(e))
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=1, attn_impl="pallas")
    st = make_train_state(cfg, AdamW(), 0, device=dev)
    toks = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    try:
        make_loss_fn(cfg)(st["params"], {"tokens": toks, "labels": toks})
    except RuntimeError as e:
        msgs.append(str(e))
    check(len(msgs) == 2 and all("no backward" in m for m in msgs), f"B3 under autograd: {msgs}")
    check(fa.launches == before, "B3 launched under autograd")
    with torch.no_grad():
        attention(q, k, v, use_kernel=True)
    check(fa.launches == before + 1, "B3 did not launch under no_grad")
    del st
    return {"raised": msgs, "launches_under_autograd": 0}


def training(dev, smi) -> dict:
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    steps = train_steps(dev, cfg)
    emit("training_steps", **steps, nvidia_smi=smi)  # at once: the loop below may fail
    _empty_cache(dev)
    t1 = time.perf_counter()
    loop = train_loop_process(dataclasses.replace(cfg, num_layers=LOOP_LAYERS), str(dev))
    loop["phase_s"] = time.perf_counter() - t1
    _empty_cache(dev)
    whisper = train_encdec_step(dev)
    _empty_cache(dev)
    raises = b3_autograd_raises(dev)
    _empty_cache(dev)
    emit("training", loop=loop, whisper_step=whisper, b3_autograd=raises,
         phase_s=time.perf_counter() - t0, nvidia_smi=smi)
    return steps


# -- the FSDP training profile on a mesh (ROADMAP A13 item 4, first half) -----
FSDP_ARCH, FSDP_LAYERS = "deepseek-moe-16b", 2  # full width; depth 28 -> 2: dense layer 0 and one MoE layer
FSDP_BATCH, FSDP_SEQ, FSDP_STEPS, FSDP_LR = 8, 1024, 4, 3e-4
FSDP_AXES = ("data", "model")
FSDP_MESHES = ((2, 2), (1, 1))  # one spawn of 4 ranks: (2, 2), then rank 0 alone
FSDP_TERMS_RTOL = 1e-5  # a rank's CE and MoE terms against the unsharded loss on its rows
FSDP_PARAM_ATOL = 5e-5  # the (2, 2) step's parameters against the replay: the tests' float32 bar
FSDP_NORM_RTOL = 2.0**-8  # grad_norm: each summed gradient entry is rounded once to bf16
# The forward's logits: B3 (bf16) and "ref" attention differ by bf16 rounding,
# which moves a token's top-6 of 64 experts where two router probabilities
# nearly tie, or its capacity slot; such a token's logits move by a whole
# expert's output. The 2**-4 bar holds at every token whose assignment (the
# experts that kept it) is the same in both forwards, and at most this share
# of the tokens may change their assignment.
FSDP_MOVED_SHARE = 0.05


def _fsdp_closed_forms(cfg, mesh, rules) -> dict:
    """From the specs: a rank's resident bytes (parameters and both moments,
    float32, and the two int32 counters) and one step's gathered and summed
    bytes. Every parameter is gathered once in the forward (bf16 where the
    step casts it, float32 otherwise) and a layer's again when backward
    recomputes it; every cotangent, of the same dtype, is summed once."""
    from repro_torch.convert import lm_tree_ndims
    from repro_torch.models import Transformer
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.rules import NamedSharding, param_specs

    whole = Transformer(cfg, device="meta", master_weights=True)
    specs, ndims = param_specs(whole, mesh, rules), lm_tree_ndims(cfg, whole)
    resident = gathered = reduced = 0
    for n, p in whole.named_parameters():
        sh = NamedSharding(mesh, specs[n])
        resident += 3 * 4 * int(np.prod(sh.shard_shape(p.shape)))
        if fsdp.num_ranks(mesh) > 1:
            reads = 1 + n.startswith("layers.") + (n == "embed" and cfg.tie_embeddings)
            nbytes = p.numel() * (2 if ndims[n] >= 2 else 4)
            gathered += nbytes * reads
            reduced += nbytes * (1 + (n == "embed" and cfg.tie_embeddings))
    return {"resident_bytes": resident + 8, "gathered_bytes_per_step": gathered,
            "reduced_bytes_per_step": reduced}


def _state_bytes(state) -> int:
    tensors = list(state["params"].parameters()) + [state["step"], state["opt_state"]["count"]]
    tensors += list(state["opt_state"]["mu"].values()) + list(state["opt_state"]["nu"].values())
    return sum(t.numel() * t.element_size() for t in tensors)


def fsdp_rank(rank: int, cfg, batch_size: int, seq: int, device: str, tmp: str) -> dict:
    """One gloo rank (spawned) of the FSDP profile, every rank on card 0 (or
    on the CPU, to rehearse at a small size), with deterministic kernels
    (cuBLAS with a fixed workspace, PyTorch's deterministic algorithms: the
    (1, 1) comparison is bitwise, the replay's per-rank terms too). The four
    ranks run the (2, 2) mesh; then each leaves the group for a group of its
    own (a ``FileStore`` under ``tmp``), and rank 0 runs the (1, 1) mesh in
    it: one spawn, one start-up (about 10 s of ``import torch`` a process on
    the card machine)."""
    import torch.distributed as dist

    entered = time.time()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    out = {(2, 2): fsdp_mesh(rank, (2, 2), cfg, batch_size, seq, device)}
    dist.destroy_process_group()
    if device != "cpu":
        torch.cuda.empty_cache()
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"alone{rank}"), 1), rank=0,
                            world_size=1)
    if rank == 0:
        out[(1, 1)] = fsdp_mesh(0, (1, 1), cfg, batch_size, seq, device)
    out[(2, 2)]["wall"]["entered"] = entered
    return out


def fsdp_mesh(rank: int, shape, cfg, batch_size: int, seq: int, device: str) -> dict:
    """This rank's part of the FSDP profile on a ``shape`` mesh over ("data",
    "model") for ``cfg``: FSDP_STEPS steps of ``make_train_step`` under
    TRAIN_FSDP_RULES on SyntheticLM batches, then one forward with
    attn_impl="pallas" against "ref"; on (1, 1) the unsharded step on the
    same batches, bitwise; on (2, 2) rank 0 replays step 1 in one process
    and each rank holds its shard to it."""
    wall = {"entered": time.time()}
    import dataclasses

    import torch.distributed as dist

    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import AdamW
    from repro_torch.optim.clipping import clip_scale, global_norm
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.rules import TRAIN_FSDP_RULES, NamedSharding, activate_mesh, spec_for, tree_shardings
    from repro_torch.train import make_loss_fn, make_train_state, make_train_step
    from repro_torch.train import step as tstep
    from repro_torch.train.state import decay_mask

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    mesh = make_mesh(shape, FSDP_AXES, device=device)
    world = fsdp.num_ranks(mesh)
    opt = AdamW(learning_rate=FSDP_LR, weight_decay=0.01, decay_mask=decay_mask(cfg))
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq, batch_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()} for i in range(FSDP_STEPS)]
    rows = NamedSharding(mesh, spec_for(("batch", None), (batch_size, seq), mesh, TRAIN_FSDP_RULES))
    forms = _fsdp_closed_forms(cfg, mesh, TRAIN_FSDP_RULES)
    wall["ready"] = time.time()

    # A rank's own terms of step 1, read where the step computes them: its CE
    # sums before the sum over ranks, and the MoE layer's local aux.
    seen: dict = {}
    ce_sums, aux_fn = tstep._ce_sums, moe_mod._aux

    def ce_recording(*args):
        out = ce_sums(*args)
        seen.setdefault("ce", tuple(v.detach().clone() for v in out))
        return out

    def aux_recording(*args):
        out = aux_fn(*args)
        seen.setdefault("aux", {k: v.detach().clone() for k, v in out.items()})
        return out

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": rank, "coordinate": list(mesh.get_coordinate()), **forms}
    with activate_mesh(mesh, TRAIN_FSDP_RULES):
        t0 = time.perf_counter()
        state = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
        _sync(dev)
        out["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()  # the phase's clock on this rank, from here
        out["state_bytes"] = _state_bytes(state)
        step = make_train_step(cfg, opt)
        # Each step's time in the parameter collectives (every all_to_all and
        # its host copies; the device synchronised around each, as the host
        # copy into page-locked memory already waits for it).
        a2a, in_a2a = fsdp._all_to_all, [0.0]

        def a2a_timed(send, group):
            _sync(dev)
            t = time.perf_counter()
            got = a2a(send, group)
            _sync(dev)
            in_a2a[0] += time.perf_counter() - t
            return got

        ps.launches = dk.launches = fa.launches = 0  # every count to 0 just before the FSDP path
        metrics, step_ms, a2a_ms, traffic = [], [], [], []
        for i, batch in enumerate(batches):
            tstep._ce_sums, moe_mod._aux = (ce_recording, aux_recording) if i == 0 else (ce_sums, aux_fn)
            fsdp._all_to_all = a2a_timed
            g0, r0 = fsdp.gathered_bytes, fsdp.reduced_bytes
            in_a2a[0] = 0.0
            _sync(dev)
            dist.barrier()
            t1 = time.perf_counter()
            try:
                state, m = step(state, batch)
                _sync(dev)
            finally:
                tstep._ce_sums, moe_mod._aux, fsdp._all_to_all = ce_sums, aux_fn, a2a
            step_ms.append(1e3 * (time.perf_counter() - t1))
            a2a_ms.append(1e3 * in_a2a[0])
            traffic.append((fsdp.gathered_bytes - g0, fsdp.reduced_bytes - r0))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                after_one = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
        out["t_steps"] = time.perf_counter() - t0
        out["train_launches"] = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
        out.update(metrics=metrics, step_ms=step_ms, collective_ms=a2a_ms, traffic=traffic)

        # -- one forward through B3: this rank's rows, against "ref" ------------
        cfg_p = dataclasses.replace(cfg, attn_impl="pallas")
        toks = rows.shard(batches[0]["tokens"])
        # Each token's MoE assignment in each forward: the experts that kept it
        # (-1 for a dropped (token, k) pair), sorted.
        routes, route_fn = [], moe_mod._route

        def route_recording(*args):
            got = route_fn(*args)
            ids = got[2]
            order, keep, _, _ = moe_mod._placement(ids, cfg)
            kept = torch.empty_like(keep)
            kept[order] = keep
            routes.append(torch.sort(torch.where(kept.reshape(ids.shape), ids, -1), dim=-1).values)
            return got

        moe_mod._route = route_recording
        try:
            with torch.no_grad():
                view = tstep._cast_params_for_compute(state["params"], cfg_p)
                fa.launches = 0
                logits_p, _ = forward(cfg_p, view, toks)
                _sync(dev)
                out["forward_launches"] = fa.launches
                logits_r, _ = forward(cfg, view, toks)
        finally:
            moe_mod._route = route_fn
        diff = (logits_p.float() - logits_r.float()).abs().amax(dim=-1).flatten()  # per token
        scale = float(logits_r.float().abs().max())
        moved = (routes[0] != routes[1]).any(dim=-1)  # tokens whose assignment differs
        out.update(forward_max_abs=float(diff.max()), forward_max_logit=scale,
                   forward_finite=bool(torch.isfinite(logits_p).all()),
                   forward_tokens=int(diff.numel()),
                   forward_tokens_over_bar=int((diff > 2.0**-4 * scale).sum()),
                   forward_max_abs_same_assignment=float(diff[~moved].max()) if bool((~moved).any()) else 0.0,
                   forward_tokens_moved=int(moved.sum()),
                   forward_argmax_agree=float((logits_p.argmax(-1) == logits_r.argmax(-1)).float().mean()))
        out["t_forward"] = time.perf_counter() - t0
        del view, logits_p, logits_r, routes
    fsdp_state = state

    # -- the bars --------------------------------------------------------------
    step_fn = make_train_step(cfg, opt)
    if world == 1:
        # The unsharded step on the same batches: loss, grad_norm, parameters
        # and moments bit for bit.
        ref = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
        same = []
        for i, batch in enumerate(batches):
            ref, m = step_fn(ref, batch)
            same.append(all(float(m[k]) == metrics[i][k] for k in ("loss", "grad_norm")))
        pa, pb = dict(fsdp_state["params"].named_parameters()), dict(ref["params"].named_parameters())
        out["bitwise"] = {
            "loss_and_grad_norm": all(same),
            "params": all(torch.equal(pa[n], pb[n]) for n in pa),
            "moments": all(torch.equal(fsdp_state["opt_state"][k][n], ref["opt_state"][k][n])
                           for k in ("mu", "nu") for n in pa),
        }
        del ref
        out["t_end"] = time.perf_counter() - t0
        out["wall"] = {**wall, "done": time.time()}
        return out

    # One-process replay of step 1 on rank 0: the unsharded loss on each
    # rank's rows, the four gradients averaged, clipped, AdamW. Rank 0 sends
    # each updated parameter to every rank, which holds its shard to it.
    from repro_torch.models import Transformer

    shardings = tree_shardings(fsdp_state["params"], mesh, TRAIN_FSDP_RULES)
    whole = {n: tuple(p.shape) for n, p in Transformer(cfg, device="meta", master_weights=True).named_parameters()}
    terms = torch.zeros((world, 4), dtype=torch.float64, device=dev)  # ce, lbl, dropped, loss per rank's rows
    replay_norm = torch.zeros((), device=dev)
    named = {}
    if rank == 0:
        rs = make_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
        loss_fn = make_loss_fn(cfg)
        named = dict(rs["params"].named_parameters())
        for r in range(world):
            coord = tuple(int(c) for c in np.unravel_index(r, shape))  # make_mesh is rank-major
            loss, m = loss_fn(rs["params"], {k: rows.shard(v, coordinate=coord) for k, v in batches[0].items()})
            loss.backward()  # the four gradients add up in .grad
            terms[r] = torch.tensor([float(m[k].detach()) for k in ("ce_loss", "load_balance_loss",
                                                                     "dropped_fraction", "loss")],
                                    dtype=torch.float64)
        with torch.no_grad():
            grads = {n: p.grad / world for n, p in named.items()}
            replay_norm = global_norm(grads)
            s = clip_scale(replay_norm, 1.0)
            for g in grads.values():
                g.mul_(s)
            opt.update(grads, rs["opt_state"], rs["params"])
        del grads, rs
    dist.broadcast(terms, 0)
    dist.broadcast(replay_norm, 0)
    worst = 0.0
    for n, mine in after_one.items():  # through page-locked host memory: gloo's CPU path is the faster
        full = torch.empty(whole[n], pin_memory=cuda)
        if rank == 0:
            full.copy_(named[n].detach())
        dist.broadcast(full, 0)
        worst = max(worst, float((shardings[n].shard(full.to(dev)) - mine).abs().max()))
        del full
    del named, after_one
    tot, zl, cnt = seen["ce"]
    cnt = torch.clamp(cnt, min=1.0)
    mine = [float(tot / cnt + 1e-4 * zl / cnt), float(seen["aux"]["load_balance_loss"]),
            float(seen["aux"]["dropped_fraction"])]
    out["terms"] = {"rank": mine, "unsharded": terms[rank, :3].tolist(), "bitwise": mine == terms[rank, :3].tolist()}
    out["replay"] = {"max_abs_param": worst, "grad_norm": float(replay_norm), "loss_mean": float(terms[:, 3].mean())}
    dist.barrier()
    out["t_end"] = time.perf_counter() - t0
    out["wall"] = {**wall, "done": time.time()}
    return out


def fsdp_training(smi, device: str = "cuda", cfg=None, batch: int = FSDP_BATCH, seq: int = FSDP_SEQ
                  ) -> tuple[int, dict]:
    """The FSDP training profile: deepseek-moe-16b at full width, 2 layers
    (or ``cfg``), on gloo ranks sharing the card, meshes (1, 1) and (2, 2)."""
    import dataclasses

    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as tdist

    cfg = cfg or dataclasses.replace(get_config(FSDP_ARCH), num_layers=FSDP_LAYERS)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fsdp-")
    try:
        w1 = time.time()
        per_rank = tdist.spawn_gloo(fsdp_rank, 4, cfg, batch, seq, device, tmp)
        w2 = time.time()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = {shape: [r[shape] for r in per_rank if shape in r] for shape in FSDP_MESHES}
    two = runs[(2, 2)]
    spawn = {"total_s": w2 - w1, "to_entered_s": max(r["wall"]["entered"] for r in two) - w1,
             "to_ready_s": max(r["wall"]["ready"] for r in two) - w1}
    summary = {}
    for shape, rows in runs.items():
        losses = [m["loss"] for m in rows[0]["metrics"]]
        summary["x".join(map(str, shape))] = {
            "ranks": len(rows), "losses": losses, "grad_norms": [m["grad_norm"] for m in rows[0]["metrics"]],
            "metrics_step1": rows[0]["metrics"][0],
            "step_ms": [r["step_ms"] for r in rows],
            "collective_ms": [r["collective_ms"] for r in rows],
            "median_step_ms": max(float(np.median(r["step_ms"][1:])) for r in rows),
            "gathered_bytes_per_step": rows[0]["traffic"][0][0], "reduced_bytes_per_step": rows[0]["traffic"][0][1],
            "closed_form": {k: rows[0][k] for k in ("gathered_bytes_per_step", "reduced_bytes_per_step",
                                                    "resident_bytes")},
            "resident_bytes": [r["state_bytes"] for r in rows],
            "peak_device_bytes": [r["peak_device_bytes"] for r in rows],
            "init_s": [r["init_s"] for r in rows],
            "rank_s": {k: [r[k] for r in rows] for k in ("t_steps", "t_forward", "t_end")},
            "b3_launches": sum(r["forward_launches"] for r in rows),
            "forward": {k: [r["forward_" + k] for r in rows]
                        for k in ("max_abs", "max_logit", "tokens", "tokens_over_bar", "max_abs_same_assignment",
                                  "tokens_moved", "argmax_agree")},
        }
    one, four = runs[(1, 1)][0], runs[(2, 2)]
    summary["1x1"]["bitwise_unsharded"] = one["bitwise"]
    summary["2x2"]["terms"] = [r["terms"] for r in four]
    summary["2x2"]["replay"] = [r["replay"] for r in four]
    launches = sum(v["b3_launches"] for v in summary.values())
    emit("fsdp", arch=cfg.name, layers=cfg.num_layers, params=cfg.num_params(), batch=batch, seq_len=seq,
         steps=FSDP_STEPS, dtype=cfg.dtype, meshes=summary, b3_launches=launches, spawn=spawn,
         phase_s=time.perf_counter() - t0,
         note="one card shared by the ranks, collectives through gloo: not a multi-GPU measurement",
         nvidia_smi=smi)  # before the checks, which may fail
    for shape, rows in runs.items():
        label = "x".join(map(str, shape))
        for r in rows:
            check(all(v == 0 for v in r["train_launches"].values()),
                  f"fsdp {label}: the train steps launched a kernel: {r['train_launches']}")
            want = cfg.num_layers if device == "cuda" else 0  # the CPU runs B3's plain version
            check(r["forward_launches"] == want,
                  f"fsdp {label} rank {r['rank']}: B3 launched {r['forward_launches']} times for {cfg.num_layers} layers")
            check(r["forward_finite"] and r["forward_max_abs_same_assignment"] <= 2.0**-4 * r["forward_max_logit"],
                  f"fsdp {label} rank {r['rank']}: pallas logits {r['forward_max_abs_same_assignment']} off ref "
                  f"at max {r['forward_max_logit']} where the MoE assignment is the same")
            check(r["forward_tokens_moved"] <= FSDP_MOVED_SHARE * r["forward_tokens"],
                  f"fsdp {label} rank {r['rank']}: {r['forward_tokens_moved']} of {r['forward_tokens']} tokens "
                  "changed their MoE assignment between pallas and ref")
            check(r["metrics"] == rows[0]["metrics"], f"fsdp {label}: the ranks report other metrics")
            check(all(t == (r["gathered_bytes_per_step"], r["reduced_bytes_per_step"]) for t in r["traffic"]),
                  f"fsdp {label}: traffic {r['traffic']} against the closed form "
                  f"{(r['gathered_bytes_per_step'], r['reduced_bytes_per_step'])}")
            check(r["state_bytes"] == r["resident_bytes"],
                  f"fsdp {label}: {r['state_bytes']} resident bytes, closed form {r['resident_bytes']}")
        losses = summary[label]["losses"]
        check(all(np.isfinite([m[k] for m in rows[0]["metrics"] for k in m])), f"fsdp {label}: {losses}")
        check(losses[-1] < losses[0], f"fsdp {label}: the loss did not fall: {losses}")
    check(all(one["bitwise"].values()), f"fsdp 1x1: not the unsharded step's bits: {one['bitwise']}")
    for r in four:
        check(abs(4 * r["state_bytes"] / one["state_bytes"] - 1) < 0.01,
              f"fsdp 2x2: rank {r['rank']} holds {r['state_bytes']} B against (1, 1)'s {one['state_bytes']}")
        for got, want, what in zip(r["terms"]["rank"], r["terms"]["unsharded"], ("ce", "load_balance", "dropped")):
            check(abs(got - want) <= FSDP_TERMS_RTOL * abs(want) + 1e-12,
                  f"fsdp 2x2 rank {r['rank']}: {what} {got} against the unsharded loss's {want}")
        check(r["replay"]["max_abs_param"] <= FSDP_PARAM_ATOL,
              f"fsdp 2x2 rank {r['rank']}: parameters {r['replay']['max_abs_param']} off the replay")
        rel = abs(r["metrics"][0]["grad_norm"] / r["replay"]["grad_norm"] - 1)
        check(rel <= FSDP_NORM_RTOL, f"fsdp 2x2: grad_norm {r['metrics'][0]['grad_norm']} against the "
              f"replay's {r['replay']['grad_norm']}")
        check(abs(r["metrics"][0]["loss"] / r["replay"]["loss_mean"] - 1) <= FSDP_TERMS_RTOL,
              f"fsdp 2x2: loss {r['metrics'][0]['loss']} against the replay's mean {r['replay']['loss_mean']}")
    return launches, {k: {"launches": v["b3_launches"], "median_step_ms": v["median_step_ms"]}
                      for k, v in summary.items()}


def ms_of(fn):
    """(result, ms) of one call on the card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def packed_scan_path(core, ps, dk, fa, g, sess, budget, pr, bfs_plans, bfs, smi) -> None:
    """execution="packed" at scale 22: no B1 launch, B1's bits and meters."""
    scan = core.get_session(g, device=sess.device, memory_budget=budget, residency="device",
                            execution="packed")
    plan3 = core.ExecutionPlan(pr, strategy="spu", max_iters=3, tol=0.0)
    check(scan.compile(plan3).execution == "packed", "execution='packed' did not resolve to itself")
    scan.run(core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0))  # stages the tiles
    torch.cuda.synchronize()
    ps.launches = 0  # every count to 0 just before the plain-scan path
    dk.launches = 0
    fa.launches = 0
    pr3, pr3_ms = ms_of(lambda: scan.run(plan3))
    scan_bfs, bfs_ms = ms_of(lambda: scan.run_batch(bfs_plans))
    counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(counts == {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": 0},
          f"the plain-scan path launched a kernel: {counts}")
    kern3 = sess.run(plan3)
    check(np.array_equal(pr3.attrs.view(np.int32), kern3.attrs.view(np.int32)),
          "packed PageRank != packed_kernel bitwise over 3 sweeps")
    check(pr3.meters.model_dict() == kern3.meters.model_dict(), "packed PageRank meters differ")
    check(scan_bfs.fused and scan_bfs.iterations == bfs.iterations, "packed BFS batch sweeps differ")
    for a, b in zip(scan_bfs, bfs):
        check(np.array_equal(a.attrs, b.attrs), "packed BFS batch != packed_kernel batch")
    check(scan_bfs.meters.model_dict() == bfs.meters.model_dict(), "packed BFS meters differ")
    emit(
        "packed_scan_path", launches=counts, pr_sweeps=pr3.meters.iterations,
        pr_ms_per_sweep=1e3 * pr3.meters.wall_seconds / pr3.meters.iterations, pr_run_ms=pr3_ms,
        kernel_pr_ms_per_sweep=1e3 * kern3.meters.wall_seconds / kern3.meters.iterations,
        bfs_sweeps=scan_bfs.iterations, bfs_ms_per_sweep=1e3 * scan_bfs.meters.wall_seconds / scan_bfs.iterations,
        bfs_run_ms=bfs_ms, bitwise_vs_packed_kernel=True, nvidia_smi=smi,
    )


def drivers(core, ps, dk, fa, dev, g, ref, bfs, roots, smi) -> int:
    """The §IV drivers on the scale-22 graph: B1 once per sweep, the main path's bits."""
    from repro_torch.core import algorithms as alg

    calls = {
        "pagerank": lambda: alg.pagerank(g, iters=10),
        "bfs": lambda: alg.bfs(g, int(roots[3])),
        "multi_bfs": lambda: alg.multi_bfs(g, roots),
        "sssp": lambda: alg.sssp(g, int(roots[3])),
        "multi_sssp": lambda: alg.multi_sssp(g, roots),
    }
    alg.pagerank(g, iters=1)  # stages the tiles of the cached session, warms
    sess = core.get_session(g)
    staged = sess._staged
    tiles_before = dict(staged._packed_tiles)
    ps.launches = 0  # every count to 0 just before the drivers
    dk.launches = 0
    fa.launches = 0
    out, job_ms, launches = {}, {}, {}
    for name, call in calls.items():
        before = ps.launches
        out[name], job_ms[name] = ms_of(call)
        launches[name] = ps.launches - before
    total = ps.launches  # just after
    check(dk.launches == 0 and fa.launches == 0, "the drivers launched another kernel")
    for name, res in out.items():
        check(launches[name] == res.iterations,
              f"{name}: {launches[name]} B1 launches for {res.iterations} sweeps")
    check(core.get_session(g) is sess and core.get_session(g, device=dev) is sess,
          "a second driver call got another session")
    check(sess._staged is staged and staged._packed_tiles.keys() == tiles_before.keys()
          and all(staged._packed_tiles[k] is v for k, v in tiles_before.items()),
          "a second driver call staged the graph again")
    check(np.array_equal(out["pagerank"].attrs.view(np.int32), ref.view(np.int32)),
          "pagerank(g) != the main path's PageRank bitwise")
    check(np.array_equal(out["bfs"].attrs, bfs[3].attrs), "bfs(g, r) != the batch's member")
    mb = out["multi_bfs"]
    check(mb.fused and mb.iterations == bfs.iterations, "multi_bfs did not fuse or took other sweeps")
    for a, b in zip(mb, bfs):
        check(np.array_equal(a.attrs, b.attrs), "multi_bfs != the main path's BFS batch")
    for name, res, depths in (("sssp", [out["sssp"]], [bfs[3]]), ("multi_sssp", out["multi_sssp"], bfs)):
        for d, b in zip(res, depths):
            want = np.where(b.attrs < core.INF_DEPTH, b.attrs.astype(np.float32), np.float32(np.inf))
            check(np.array_equal(d.attrs.view(np.int32), want.view(np.int32)),
                  f"{name} on the unweighted graph != the BFS depths")
    emit(
        "drivers", launches={**launches, "total": total}, sweeps={k: r.iterations for k, r in out.items()},
        ms_per_sweep={k: 1e3 * r.meters.wall_seconds / r.iterations for k, r in out.items()},
        job_ms=job_ms, multi_bfs_fused=mb.fused, same_session=True, nvidia_smi=smi,
    )
    return total


def count_distinct(a: np.ndarray) -> int:
    """Distinct values by sorting (np.unique hashes from NumPy 2.3 on, far slower)."""
    a = np.sort(a)
    return int(a.size > 0) + int(np.count_nonzero(a[1:] != a[:-1]))


def wcc_scc(core, ps, dk, fa, el, P, smi) -> int:
    """wcc(el) and scc(el) against scipy's weak and strong components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from repro_torch.core import algorithms as alg

    runs = []

    class Recorded(core.GraphSession):
        """Times each run, with the tile staging (lazy, once per session) apart."""

        def run(self, plan):
            before, t = ps.launches, time.perf_counter()
            self._staged.packed_tiles(self.packing, self.device)
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t
            res = super().run(plan)
            runs.append({"program": plan.program.name, "sweeps": res.iterations,
                         "run_s": time.perf_counter() - t, "stage_s": stage_s,
                         "sweep_s": res.meters.wall_seconds, "launches": ps.launches - before})
            return res

    alg.GraphSession = Recorded
    try:
        ps.launches = 0  # every count to 0 just before wcc and scc
        dk.launches = 0
        fa.launches = 0
        t0 = time.perf_counter()
        w = alg.wcc(el, P=P)
        t_wcc = time.perf_counter() - t0
        labels = alg.scc(el, P=P)
        t_scc = time.perf_counter() - t0 - t_wcc
        counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    finally:
        alg.GraphSession = core.GraphSession
    sweeps = sum(r["sweeps"] for r in runs)
    check(counts == {"packed_sweep": sweeps, "dsss_spmv": 0, "flash_attention": 0},
          f"wcc/scc launched {counts} over {sweeps} sweeps")
    t1 = time.perf_counter()
    A = coo_matrix((np.ones(el.m, np.float32), (el.src, el.dst)), shape=(el.n, el.n)).tocsr()
    n_weak, weak = connected_components(A, directed=True, connection="weak")
    n_strong, strong = connected_components(A, directed=True, connection="strong")
    t_scipy = time.perf_counter() - t1
    _, first = np.unique(weak, return_index=True)  # the least vertex id of each component
    check(w.converged and np.array_equal(w.attrs, first[weak].astype(w.attrs.dtype)),
          "WCC labels != the least id of each weak component")
    pairs = count_distinct(labels.astype(np.int64) * n_strong + strong)
    n_labels = count_distinct(labels)
    check(pairs == n_labels == n_strong, f"SCC partition differs: {n_labels} labels, {n_strong} SCCs, {pairs} pairs")
    run_s = {k: sum(r["run_s"] for r in runs if (r["program"] == "wcc") == (k == "wcc")) for k in ("wcc", "scc")}
    emit(
        "wcc_scc", n=el.n, m=el.m, P=P, launches=counts, sweeps=sweeps,
        wcc={"sweeps": w.iterations, "components": int(n_weak), "seconds": t_wcc,
             "session_run_s": run_s["wcc"], "host_s": t_wcc - run_s["wcc"],
             "stage_s": runs[0]["stage_s"], "ms_per_sweep": 1e3 * w.meters.wall_seconds / w.iterations},
        scc={"rounds": sum(r["program"] == "scc_fwd" for r in runs), "components": int(n_strong),
             "sweeps": sum(r["sweeps"] for r in runs if r["program"] != "wcc"), "seconds": t_scc,
             "session_run_s": run_s["scc"], "host_s": t_scc - run_s["scc"],
             "stage_s": sum(r["stage_s"] for r in runs if r["program"] != "wcc"),
             "sweep_s": sum(r["sweep_s"] for r in runs if r["program"] != "wcc")},
        runs=runs[:12], scipy_s=t_scipy, nvidia_smi=smi,
    )
    return counts["packed_sweep"]


def baselines(core, ps, dk, fa, g, pb, pr, spu_per_block, spu_packed, smi) -> None:
    """TurboGraph-like PageRank at scale 22: SPU's bits and the n·P·Ba re-reads."""
    from repro_torch.core.baselines import TurboGraphLikeEngine

    eng = TurboGraphLikeEngine(g, pr, session=pb)  # the per-block path's staged blocks
    check(eng.execution == "per_block" and eng.resident == frozenset(), "TurboGraph-like did not run per-block")
    ps.launches = 0  # every count to 0 just before the baseline
    dk.launches = 0
    fa.launches = 0
    res, run_ms = ms_of(lambda: eng.run(10, tol=0.0))
    counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(counts == {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": 0},
          f"the TurboGraph-like schedule launched a kernel: {counts}")
    check(res.meters.iterations == 10, f"TurboGraph-like ran {res.meters.iterations} sweeps")
    for label, other in (("per-block SPU", spu_per_block), ("packed SPU", spu_packed)):
        check(np.array_equal(res.attrs.view(np.int32), other.view(np.int32)),
              f"TurboGraph-like PageRank != {label} bitwise")
    per = res.meters.per_iteration()
    nonempty = len(pb.block_keys)
    want_read = (g.P + nonempty) * g.interval_size * pr.attr_bytes
    want_write = g.P * g.interval_size * pr.attr_bytes
    check(per.bytes_read_intervals == want_read and per.bytes_written_intervals == want_write,
          f"TurboGraph-like interval bytes {per.bytes_read_intervals}/{per.bytes_written_intervals}, "
          f"want {want_read}/{want_write}")
    emit(
        "baselines", strategy="turbograph-like", launches=counts, sweeps=res.meters.iterations,
        ms_per_sweep=1e3 * res.meters.wall_seconds / res.meters.iterations, run_ms=run_ms,
        bytes_read_intervals_per_sweep=per.bytes_read_intervals,
        bytes_written_intervals_per_sweep=per.bytes_written_intervals,
        bytes_read_edges_per_sweep=per.bytes_read_edges, nonempty_blocks=nonempty,
        bitwise_vs_spu=True, nvidia_smi=smi,
    )


def h2d_yardstick(dev) -> dict:
    """GB/s of a 1 GiB host→device copy from page-locked and from pageable memory."""
    n = 1 << 30
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    out = {}
    for kind in ("pinned", "pageable"):
        src = torch.ones(n, dtype=torch.uint8, pin_memory=kind == "pinned")
        ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=3)
        out[f"{kind}_ms"] = ms
        out[f"{kind}_gbps"] = n / ms / 1e6
        del src
    del dst
    torch.cuda.empty_cache()
    return out


def kernel_stream_bytes(core, hs, splan, tile_active=None) -> float:
    """The closed form of one host sweep's B1 payload, counted from the layout."""
    staged = hs._staged
    packed = staged.packed_host(hs.packing)
    rows_per_tile = np.bincount(staged.packed_run_index(hs.packing)["chunks"][:, 5],
                                minlength=packed.num_tiles)
    c = dict(ranges=0, runs=0, chunk_rows=0, touched=0, perm_edges=0)
    tiles = 0
    for lo in range(splan.pin_tiles, splan.num_tiles, splan.chunk_tiles):
        hi = min(lo + splan.chunk_tiles, splan.num_tiles)
        if tile_active is not None and not tile_active[lo:hi].any():
            continue
        tiles += hi - lo
        c["ranges"] += 1
        c["runs"] += int(packed.u[lo:hi].sum())
        c["chunk_rows"] += int(rows_per_tile[lo:hi].sum())
        c["touched"] += count_distinct(np.concatenate([packed.run_dst[t, : packed.u[t]] for t in range(lo, hi)]))
        if hs.graph.src_sorted:
            c["perm_edges"] += int(packed.e_valid[lo:hi].sum())
    return core.iomodel.packed_kernel_h2d_bytes(
        tiles, splan.tile_edges, weighted=hs.has_weights, **c
    )


def host_path(core, ps, dk, fa, dev, g, sess, pb, pr, budget, runs, ref, bfs, bfs_plans, roots,
              tile_bytes, smi) -> tuple[int, dict]:
    """Host residency at scale 22: B1 over streamed tile ranges, the plain scan and
    the per-block path streamed, against the device-residency runs' bits."""
    import dataclasses

    from repro_torch.core import algorithms as alg
    from repro_torch.core import session as session_mod

    yard = h2d_yardstick(dev)
    emit("h2d_yardstick", bytes=1 << 30, **yard, nvidia_smi=smi)
    Be = sess.Be
    budgets = {"A": budget, "B": 2 * g.n_pad * pr.attr_bytes + g.m * Be // 2}
    t0 = time.perf_counter()
    host = {k: core.GraphSession(g, device=None, residency="host", memory_budget=b, staged=sess._staged)
            for k, b in budgets.items()}
    devres_b = core.GraphSession(g, device=None, residency="device", memory_budget=budgets["B"],
                                 staged=sess._staged)
    for hs in host.values():  # stages each stream (pinned host payloads), warms
        for strategy in ("spu", "dpu", "mpu"):
            hs.run(core.ExecutionPlan(pr, strategy=strategy, max_iters=1, tol=0.0))
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    plans = {s: core.ExecutionPlan(pr, strategy=s, max_iters=10, tol=0.0) for s in ("spu", "dpu", "mpu")}
    warm = {s: core.ExecutionPlan(pr, strategy=s, max_iters=1, tol=0.0) for s in plans}
    want_b = {s: devres_b.run(p) for s, p in plans.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)

    ps.launches = 0  # every count to 0 just before the host path
    ps.pre_gathers = 0
    dk.launches = 0
    fa.launches = 0
    out, peak_above = {}, {}
    for name, hs in host.items():
        want_runs = runs if name == "A" else want_b
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for strategy, plan in plans.items():
            splan = hs.packed_stream_plan(strategy, pr.attr_bytes)
            chunks = -(-(splan.num_tiles - splan.pin_tiles) // splan.chunk_tiles)
            slabs = chunks + (splan.pin_tiles > 0)
            before = ps.launches
            hs.run(warm[strategy])  # a strategy change moves the pins: pin before timing
            res, run_ms = ms_of(lambda: hs.run(plan))
            launched = ps.launches - before
            it = res.meters.iterations
            check(it == 10, f"host {name} {strategy}: {it} sweeps")
            check(np.array_equal(res.attrs.view(np.int32), ref.view(np.int32)),
                  f"host {name} {strategy} PageRank != device residency bitwise")
            check(res.meters.model_dict() == want_runs[strategy].meters.model_dict(),
                  f"host {name} {strategy} model meters != device residency's")
            per_sweep = kernel_stream_bytes(core, hs, splan)
            check(res.meters.bytes_h2d == it * per_sweep,
                  f"host {name} {strategy}: bytes_h2d {res.meters.bytes_h2d} != {it} x {per_sweep}")
            check(launched == (it + 1) * slabs,
                  f"host {name} {strategy}: {launched} launches for {it + 1} x {slabs} slabs")
            ms = 1e3 * res.meters.wall_seconds / it
            out[f"{name}_{strategy}"] = {
                "pin_tiles": splan.pin_tiles, "chunk_tiles": splan.chunk_tiles, "chunks": chunks,
                "launches_per_sweep": launched / (it + 1), "ms_per_sweep": ms, "run_ms": run_ms,
                "bytes_h2d_per_sweep": per_sweep, "achieved_gbps": per_sweep / ms / 1e6,
                "pinned_bound_ms": per_sweep / yard["pinned_gbps"] / 1e6,
                "peak_device_graph_bytes": res.meters.peak_device_graph_bytes,
            }
        torch.cuda.synchronize()
        peak_above[name] = torch.cuda.max_memory_allocated(dev) - base
    pr_launches = ps.launches
    check(peak_above["A"] < tile_bytes / 4 and peak_above["B"] < tile_bytes,
          f"host runs took {peak_above} B of device memory above the baseline; the layout's tiles {tile_bytes}")

    hs = host["A"]
    # The 8-root BFS batch (selective) and one root alone, against the device runs.
    before = ps.launches
    hb = hs.run_batch(bfs_plans)
    check(hb.fused and hb.iterations == bfs.iterations, "host BFS batch did not fuse or took other sweeps")
    for a, b in zip(hb, bfs):
        check(np.array_equal(a.attrs, b.attrs), "host BFS batch != device batch")
    check(hb.meters.model_dict() == bfs.meters.model_dict(), "host BFS batch meters differ")
    strategy = hs.compile(bfs_plans[0]).choice.strategy
    splan = hs.packed_stream_plan(strategy, bfs_plans[0].program.attr_bytes)
    want = sum(kernel_stream_bytes(core, hs, splan, None if r.all() else hs._packed_tile_activity(r))
               for r in hb.activity_log)
    check(hb.meters.bytes_h2d == want, f"host BFS batch bytes_h2d {hb.meters.bytes_h2d} != {want}")
    full = kernel_stream_bytes(core, hs, splan)
    one = hs.run(bfs_plans[3])
    check(np.array_equal(one.attrs, bfs[3].attrs), "host BFS != the device batch's member")
    want_one = sum(kernel_stream_bytes(core, hs, splan, None if r.all() else hs._packed_tile_activity(r))
                   for r in one.activity_log)
    check(one.meters.bytes_h2d == want_one and one.meters.bytes_h2d < one.iterations * full,
          f"selective BFS bytes_h2d {one.meters.bytes_h2d}, closed form {want_one}, full {one.iterations * full}")
    off = [dataclasses.replace(p, activity="off", max_iters=2) for p in bfs_plans]
    k8, k1 = hs.run_batch(off), hs.run(off[0])
    check(k8.meters.per_iteration().bytes_h2d == k1.meters.per_iteration().bytes_h2d == full,
          "a K = 8 batch does not stream the edges once a sweep")
    bfs_launches = ps.launches - before
    # execution="packed": the JAX package's leaves, the plain tile sweep.
    scan = core.GraphSession(g, device=None, residency="host", memory_budget=budget, execution="packed",
                             staged=sess._staged)
    plan2 = core.ExecutionPlan(pr, strategy="spu", max_iters=2, tol=0.0)
    before = ps.launches
    sc = scan.run(plan2)
    check(ps.launches == before, "host execution='packed' launched B1")
    dev2 = sess.run(plan2)
    check(np.array_equal(sc.attrs.view(np.int32), dev2.attrs.view(np.int32)), "host packed != device bitwise")
    splan = scan.packed_stream_plan("spu", pr.attr_bytes)
    check(sc.meters.bytes_h2d == 2 * core.iomodel.packed_h2d_bytes(splan.num_tiles - splan.pin_tiles,
                                                                   splan.tile_edges),
          "host packed bytes_h2d != packed_h2d_bytes")
    # The per-block path streamed, against device per-block.
    hpb = core.GraphSession(g, device=None, residency="host", memory_budget=budget, execution="per_block",
                            staged=pb._staged)
    nbytes = {k: session_mod._host_block_nbytes(b) for k, b in pb.host_blocks.items()}
    pb_out = {}
    for strategy in ("spu", "dpu", "mpu"):
        p3 = core.ExecutionPlan(pr, strategy=strategy, max_iters=3, tol=0.0)
        hpb.run(warm[strategy])  # stages the page-locked blocks, pins the resident set
        got, want = hpb.run(p3), pb.run(p3)
        check(np.array_equal(got.attrs.view(np.int32), want.attrs.view(np.int32)),
              f"host per_block {strategy} != device per_block bitwise")
        check(got.meters.model_dict() == want.meters.model_dict(), f"host per_block {strategy} meters differ")
        resident = hpb.compile(p3).resident
        check(got.meters.bytes_h2d == 3 * core.iomodel.streamed_block_bytes(nbytes, resident),
              f"host per_block {strategy} bytes_h2d != streamed_block_bytes")
        pb_out[strategy] = {"ms_per_sweep": 1e3 * got.meters.wall_seconds / 3,
                            "bytes_h2d_per_sweep": got.meters.bytes_h2d / 3}
    # The drivers with a budget: auto residency is host.
    alg.pagerank(g, iters=1, memory_budget=budget)  # stages the cached session's stream
    before = ps.launches
    drv = alg.pagerank(g, iters=10, memory_budget=budget)
    check(core.get_session(g, memory_budget=budget).resolved_residency() == "host", "the driver ran at device residency")
    check(np.array_equal(drv.attrs.view(np.int32), ref.view(np.int32)), "pagerank(g, memory_budget=) != the main path")
    check(drv.meters.bytes_h2d > 0, "pagerank(g, memory_budget=) streamed nothing")
    drv_launches = ps.launches - before
    total = ps.launches  # just after
    counts = {"packed_sweep": total, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(dk.launches == 0 and fa.launches == 0, f"the host path launched another kernel: {counts}")
    busy = device_busy(lambda: host["A"].run(core.ExecutionPlan(pr, strategy="spu", max_iters=2, tol=0.0)))
    emit(
        "host_path", launches=counts, pre_gathers=ps.pre_gathers, budgets=budgets, staging_s=stage_s,
        pagerank=out, pagerank_launches=pr_launches, peak_device_bytes_above_baseline=peak_above,
        layout_device_tile_bytes=tile_bytes, device_busy_spu_a=busy,
        bfs_k8={"sweeps": hb.iterations, "bytes_h2d": hb.meters.bytes_h2d,
                "ms_per_sweep": 1e3 * hb.meters.wall_seconds / hb.iterations},
        bfs_selective={"sweeps": one.iterations, "bytes_h2d": one.meters.bytes_h2d,
                       "full_stream_bytes": one.iterations * full},
        bfs_launches=bfs_launches, packed_ms_per_sweep=1e3 * sc.meters.wall_seconds / 2,
        packed_bytes_h2d_per_sweep=sc.meters.bytes_h2d / 2, per_block=pb_out,
        driver={"ms_per_sweep": 1e3 * drv.meters.wall_seconds / drv.iterations, "launches": drv_launches,
                "bytes_h2d_per_sweep": drv.meters.bytes_h2d / drv.iterations},
        pinned_gbps=yard["pinned_gbps"], nvidia_smi=smi,
    )
    a_spu = out["A_spu"]
    return total, {"launches_per_sweep": a_spu["launches_per_sweep"], "ms_per_sweep": a_spu["ms_per_sweep"],
                   "bound_ms": a_spu["pinned_bound_ms"], "bound_by": "bytes"}


DISK_SWEEPS = 3  # a disk run: the cold first sweep, then warm ones


def host_memory() -> dict:
    """This process's resident host memory (bytes) as /proc reports it: the
    total (which counts the pages of a mapped file the process touched) and,
    where the kernel gives them, the anonymous and file-backed parts."""
    out = {}
    for name, keys in (("/proc/self/status", ("VmRSS", "RssAnon", "RssFile", "RssShmem")),
                       ("/proc/self/smaps_rollup", ("Anonymous", "Shared_Clean", "Private_Clean"))):
        try:
            with open(name) as f:
                for line in f:
                    key, _, value = line.partition(":")
                    if key in keys:
                        out[key] = int(value.split()[0]) * 1024
        except OSError:
            pass
    return out


def evict_page_cache(path: str) -> None:
    """Write the file's dirty pages back, then drop its pages from the page cache."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def mount_of(path: str) -> str:
    """The filesystem type and mount point that hold ``path`` (/proc/mounts)."""
    best = ("", "?")
    real = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt, fstype = parts[1], parts[2]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return f"{best[1]} at {best[0]}"


def disk_split(disk, Ba) -> dict:
    """Where a disk sweep's host time goes: one pass over a stream plan's
    chunks on the host alone — read the leaves from the file's mmap views,
    build B1's range operands, lay them into a page-locked buffer."""
    from repro_torch.core import streaming
    from repro_torch.core.session import _packed_leaves
    from repro_torch.kernels.packed_sweep import range_from_leaves, write_range

    stream = disk._disk_stream(disk.packed_stream_plan("dpu", Ba), "kernel")
    buf = streaming.host_buffer(stream.max_nbytes, disk.device.type == "cuda").numpy()
    t = {"read_s": 0.0, "build_s": 0.0, "write_s": 0.0}
    for lo, hi in stream.bounds:
        t0 = time.perf_counter()
        leaves = {k: np.array(v) for k, v in _packed_leaves(stream.packed, lo, hi).items() if v is not None}
        t1 = time.perf_counter()
        unit, arrays = range_from_leaves(leaves, lo, interval_size=disk.graph.interval_size,
                                         permuted=stream.permuted)
        t2 = time.perf_counter()
        write_range(buf, unit, arrays)
        t3 = time.perf_counter()
        t["read_s"] += t1 - t0
        t["build_s"] += t2 - t1
        t["write_s"] += t3 - t2
    return {**t, "chunks": len(stream.bounds)}


def disk_path(core, ps, dk, fa, dev, g, sess, pb, pr, budget, ref, bfs, bfs_plans, tmp, smi) -> tuple[int, dict]:
    """Disk residency at scale 22: the main path's graph written to a .dsss file
    in ``tmp`` (the caller removes it) and streamed disk → host → device
    through B1's range launches."""
    import dataclasses
    import filecmp
    import gc

    from repro_torch.core import iomodel
    from repro_torch.core import session as session_mod
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.preprocess import degree_and_densify
    from repro_torch.obs import REGISTRY, TRACER, TraceSpec
    from repro_torch.runtime import trace_analysis
    from repro_torch.storage import build_dsss_file, write_dsss

    path = os.path.join(tmp, "g22.dsss")
    t0 = time.perf_counter()
    write_dsss(g, path)
    write_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    core.GraphSession.open(path, verify=True, memory_budget=budget)
    verify_s = time.perf_counter() - t0
    gc.collect()
    evict_page_cache(path)
    emit("disk_file", bytes=file_bytes, write_s=write_s, open_verify_s=verify_s,
         filesystem=mount_of(path))

    Ba = pr.attr_bytes
    spu0 = sess.packed_stream_plan("spu", Ba)  # budget A: nothing pinned
    leaf_tile = spu0.tile_edges * iomodel.PACKED_SLOT_BYTES + 4
    half = (spu0.num_tiles - spu0.pin_tiles) // 2 * leaf_tile
    configs = {"host0": 0, "half": half}
    plan3 = {s: core.ExecutionPlan(pr, strategy=s, max_iters=DISK_SWEEPS, tol=0.0)
             for s in ("spu", "dpu", "mpu")}
    want = {s: sess.run(p) for s, p in plan3.items()}  # device residency, same budget
    torch.cuda.synchronize()
    base_dev = torch.cuda.memory_allocated(dev)

    ps.launches = 0  # every count to 0 just before the disk path
    ps.pre_gathers = 0
    dk.launches = 0
    fa.launches = 0
    out, disk = {}, None
    for name, host_budget in configs.items():
        del disk
        gc.collect()
        evict_page_cache(path)
        mem0 = host_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        disk = core.GraphSession.open(path, verify=False, memory_budget=budget,
                                      host_memory_budget=host_budget)
        for strategy, plan in plan3.items():
            splan = disk.packed_stream_plan(strategy, Ba)
            chunks = -(-(splan.num_tiles - splan.pin_tiles) // splan.chunk_tiles)
            mark = TRACER.mark()
            before = ps.launches
            res = disk.run(dataclasses.replace(plan, trace=TraceSpec()))
            torch.cuda.synchronize()
            launched = ps.launches - before
            sweeps_s = [s.dur for s in TRACER.spans(since=mark) if s.name == "sweep"]
            it = res.meters.iterations
            label = f"disk {name} {strategy}"
            check(it == DISK_SWEEPS and len(sweeps_s) == it, f"{label}: {it} sweeps")
            check(np.array_equal(res.attrs.view(np.int32), want[strategy].attrs.view(np.int32)),
                  f"{label}: PageRank != device residency bitwise")
            check(res.meters.model_dict() == want[strategy].meters.model_dict(),
                  f"{label}: model meters != device residency's")
            read = iomodel.packed_disk_bytes(splan.num_tiles - splan.pin_tiles - splan.host_tiles,
                                             splan.tile_edges, weighted=disk.has_weights)
            check(res.meters.bytes_disk_read == it * read,
                  f"{label}: bytes_disk_read {res.meters.bytes_disk_read} != {it} x {read}")
            h2d = kernel_stream_bytes(core, sess, splan)  # host residency's closed form
            check(res.meters.bytes_h2d == it * h2d,
                  f"{label}: bytes_h2d {res.meters.bytes_h2d} != {it} x {h2d}")
            check(launched == it * (chunks + (splan.pin_tiles > 0)),
                  f"{label}: {launched} launches for {it} x {chunks} chunks")
            out[f"{name}_{strategy}"] = {
                "host_tiles": splan.host_tiles, "chunks": chunks,
                "launches_per_sweep": launched / it,
                "cold_first_sweep_ms": 1e3 * sweeps_s[0],
                "warm_ms_per_sweep": 1e3 * float(np.mean(sweeps_s[1:])),
                "sweeps_ms": [1e3 * s for s in sweeps_s],
                "bytes_disk_read_per_sweep": read, "bytes_h2d_per_sweep": h2d,
                "warm_disk_gbps": read / float(np.mean(sweeps_s[1:])) / 1e9,
            }
        torch.cuda.synchronize()
        mem1 = host_memory()
        out[name] = {
            "host_memory_budget": host_budget, "staged_host_bytes": disk.staged_host_bytes(),
            "staging_slot_bytes": disk._disk_slots().nbytes,
            "host_bytes_above_baseline": {k: mem1[k] - mem0.get(k, 0) for k in mem1},
            "peak_device_bytes_above_baseline": torch.cuda.max_memory_allocated(dev) - base_dev,
        }
    pr_launches = ps.launches

    # Registry deltas equal the meters, and the busy share, over a warm run.
    kinds = ("h2d", "disk_read", "read_edges", "read_intervals", "read_hubs", "written_hubs",
             "written_intervals")
    snap = {k: REGISTRY.value("repro_engine_bytes_total", kind=k) for k in kinds}
    busy_res = []
    busy = device_busy(lambda: busy_res.append(disk.run(plan3["dpu"])))
    for k in kinds:
        delta = REGISTRY.value("repro_engine_bytes_total", kind=k) - snap[k]
        check(delta == getattr(busy_res[0].meters, "bytes_" + k), f"registry {k} delta != meters")
    split = disk_split(disk, Ba)

    # BFS K = 8 (selective) at budget A, nothing cached.
    del disk
    gc.collect()
    evict_page_cache(path)
    disk = core.GraphSession.open(path, verify=False, memory_budget=budget, host_memory_budget=0)
    before = ps.launches
    trace_path = os.path.join(tmp, "bfs.json")
    bb = disk.run_batch([dataclasses.replace(p, trace=TraceSpec(path=trace_path)) for p in bfs_plans])
    torch.cuda.synchronize()
    bfs_launches = ps.launches - before
    check(bb.fused and bb.iterations == bfs.iterations, "disk BFS batch did not fuse or took other sweeps")
    for a, b in zip(bb, bfs):
        check(np.array_equal(a.attrs, b.attrs), "disk BFS batch != device batch")
    check(bb.meters.model_dict() == bfs.meters.model_dict(), "disk BFS batch model meters differ")
    strategy = disk.compile(bfs_plans[0]).choice.strategy
    splan = disk.packed_stream_plan(strategy, bfs_plans[0].program.attr_bytes)
    h2d = read = 0.0
    for row in bb.activity_log:
        active = None if row.all() else disk._packed_tile_activity(row)
        h2d += kernel_stream_bytes(core, sess, splan, active)
        tiles = (splan.num_tiles - splan.pin_tiles if active is None else
                 iomodel.selective_streamed_tiles(active, splan.pin_tiles, splan.chunk_tiles))
        read += iomodel.packed_disk_bytes(tiles, splan.tile_edges)
    check(bb.meters.bytes_h2d == h2d and bb.meters.bytes_disk_read == read,
          f"disk BFS bytes {bb.meters.bytes_h2d}/{bb.meters.bytes_disk_read} != {h2d}/{read}")
    events = trace_analysis.load_events(trace_path)
    (summary,) = trace_analysis.run_summaries(events)
    check(summary["residency"] == "disk" and summary["sweeps"] == bb.iterations
          and summary["bytes_h2d"] == bb.meters.bytes_h2d
          and summary["bytes_disk_read"] == bb.meters.bytes_disk_read,
          f"the traced disk run's sweep spans do not sum to the meters: {summary}")
    bfs_sweeps_ms = [1e3 * e["dur"] for e in events if e["name"] == "sweep"]

    # One per-block SPU sweep at budget A, nothing cached.
    pbd = core.GraphSession.open(path, verify=False, memory_budget=budget, host_memory_budget=0,
                                 execution="per_block")
    p1 = core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0)
    before = ps.launches
    got, want1 = pbd.run(p1), pb.run(p1)
    check(ps.launches == before, "the per-block disk sweep launched B1")
    check(np.array_equal(got.attrs.view(np.int32), want1.attrs.view(np.int32)),
          "disk per_block SPU != device per_block bitwise")
    check(got.meters.model_dict() == want1.meters.model_dict(), "disk per_block meters differ")
    compiled = pbd.compile(p1)
    nbytes = {k: session_mod._host_block_nbytes(b) for k, b in pbd.host_blocks.items()}
    read_pb = iomodel.disk_read_bytes(nbytes, compiled.resident, compiled.host_cached)
    check(got.meters.bytes_disk_read == read_pb and got.meters.bytes_h2d == read_pb,
          f"disk per_block bytes {got.meters.bytes_disk_read} != disk_read_bytes {read_pb}")
    total = ps.launches  # just after the disk path
    counts = {"packed_sweep": total, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(dk.launches == 0 and fa.launches == 0, f"the disk path launched another kernel: {counts}")
    del disk, pbd
    gc.collect()

    # The external builder at scale 18 against write_dsss of the same graph.
    src, dst = rmat(18, edge_factor=16, seed=3)
    t0 = time.perf_counter()
    stats = build_dsss_file(
        lambda: ((src[lo:lo + (1 << 20)], dst[lo:lo + (1 << 20)]) for lo in range(0, len(src), 1 << 20)),
        os.path.join(tmp, "ext18.dsss"), 8, chunk_budget=64 << 20, drop_self_loops=True,
    )
    ext_s = time.perf_counter() - t0
    write_dsss(core.build_dsss(degree_and_densify(src, dst, drop_self_loops=True), 8),
               os.path.join(tmp, "mem18.dsss"))
    same = filecmp.cmp(os.path.join(tmp, "ext18.dsss"), os.path.join(tmp, "mem18.dsss"), shallow=False)
    check(same, "the external builder's scale-18 file != write_dsss of the same graph")

    # Observability's cost on the device-residency main path (SPU, 10
    # sweeps), registry on and off in turns, 10 pairs, alternating which
    # side runs first.
    obs_ms = {"on": [], "off": []}
    p10 = core.ExecutionPlan(pr, strategy="spu", max_iters=10, tol=0.0)
    for k in range(10):
        for state in (("on", "off") if k % 2 == 0 else ("off", "on")):
            REGISTRY.set_enabled(state == "on")
            try:
                r10 = sess.run(p10)
            finally:
                REGISTRY.set_enabled(True)
            obs_ms[state].append(1e3 * r10.meters.wall_seconds / r10.meters.iterations)
    obs_median = {k: float(np.median(v)) for k, v in obs_ms.items()}
    emit(
        "disk_path", launches=counts, pre_gathers=ps.pre_gathers, budget=budget,
        configs=configs, pagerank=out, pagerank_launches=pr_launches,
        device_busy_dpu_host0_warm=busy,
        bfs_k8={"sweeps": bb.iterations, "launches": bfs_launches, "sweeps_ms": bfs_sweeps_ms,
                "bytes_h2d": bb.meters.bytes_h2d, "bytes_disk_read": bb.meters.bytes_disk_read},
        per_block_spu={"ms": 1e3 * got.meters.wall_seconds, "bytes_disk_read": read_pb},
        external_build_18={"n": stats.n, "m": stats.m, "seconds": ext_s, "bytes_equal": same,
                           "peak_edge_bytes": stats.peak_edge_bytes, "chunks": stats.num_chunks},
        host_split_warm_dpu=split, obs_spu_ms_per_sweep=obs_ms, obs_spu_median_ms=obs_median,
        nvidia_smi=smi,
    )
    host0 = out["host0_spu"]
    return total, {"launches_per_sweep": host0["launches_per_sweep"],
                   "warm_ms_per_sweep": host0["warm_ms_per_sweep"],
                   "cold_first_sweep_ms": host0["cold_first_sweep_ms"]}


def meters_but_wall(m) -> dict:
    """A Meters as a dict, without the wall clock (the resume contract's fields)."""
    import dataclasses

    d = dataclasses.asdict(m)
    d.pop("wall_seconds")
    return d


def expect_crash(run, crash_cls, what: str):
    """Run ``run``; it must end in an injected crash."""
    try:
        run()
    except crash_cls:
        return
    raise SystemExit(f"chip_smoke: check failed: {what}: no injected crash")


def reliability(core, ps, dk, fa, dev, g, sess, pr, budget, runs, bfs, bfs_plans, path, tmp,
                smi) -> tuple[int, dict]:
    """Crash → snapshot → resume at scale 22 through B1 at device, host and disk
    residency, the fused BFS batch, a transient H2D plan and a healing read."""
    import dataclasses

    from repro_torch.obs import TRACER, TraceSpec
    from repro_torch.reliability import CheckpointSpec, FaultPlan, InjectedCrash, list_snapshots
    from repro_torch.storage import ReadPolicy

    snaps = os.path.join(tmp, "snaps")
    p1 = core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0)
    host = core.GraphSession(g, device=None, residency="host", memory_budget=budget, staged=sess._staged)
    host.run(p1)  # the budget-A stream is staged already (host_path): pins, warms
    disk = core.GraphSession.open(path, verify=False, memory_budget=budget, host_memory_budget=0)
    splan = host.packed_stream_plan("spu", pr.attr_bytes)
    slabs = -(-(splan.num_tiles - splan.pin_tiles) // splan.chunk_tiles) + (splan.pin_tiles > 0)
    torch.cuda.synchronize()

    ps.launches = 0  # every count to 0 just before the reliability path
    dk.launches = 0
    fa.launches = 0
    out = {}
    # Device residency: SPU PageRank, 10 sweeps, a snapshot every 2 (keep 2),
    # a crash at sweep 7, then the resume from sweep 6.
    ck = CheckpointSpec(os.path.join(snaps, "device"), every=2, keep=2)
    plan = core.ExecutionPlan(pr, strategy="spu", max_iters=10, tol=0.0, checkpoint=ck)
    sess.inject_faults(FaultPlan.crash_at_sweep(7))
    mark = TRACER.mark()
    before = ps.launches
    expect_crash(lambda: sess.run(dataclasses.replace(plan, trace=TraceSpec())), InjectedCrash, "device")
    torch.cuda.synchronize()
    crashed = ps.launches - before
    save_ms = [1e3 * sp.dur for sp in TRACER.spans(since=mark) if sp.name == "checkpoint"]
    kept = [os.path.basename(x) for x in list_snapshots(ck.directory)]
    check(kept == ["sweep_00000004.npz", "sweep_00000006.npz"], f"device snapshots {kept}")
    latest = os.path.join(ck.directory, kept[-1])
    snap_bytes = os.path.getsize(latest)
    restore_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        session_attrs = sess._restore_sweep_snapshot(latest, plan, 1, core.Meters())[0]
        torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
    del session_attrs
    before = ps.launches
    res = sess.run(plan, resume_from=ck.directory)
    torch.cuda.synchronize()
    resumed = ps.launches - before
    sess.inject_faults(None)
    want = runs["spu"]
    check(crashed == 7 and resumed == 4, f"device crash/resume launched {crashed} + {resumed} B1, want 7 + 4")
    check(np.array_equal(res.attrs.view(np.int32), want.attrs.view(np.int32)),
          "device resume != uninterrupted PageRank bitwise")
    check(meters_but_wall(res.meters) == meters_but_wall(want.meters), "device resume meters differ")
    out["device"] = {"launches_crashed": crashed, "launches_resumed": resumed, "snapshot_bytes": snap_bytes,
                     "save_ms": save_ms, "restore_ms": restore_ms, "snapshots_kept": kept}

    # Host (budget A) and disk (host_memory_budget 0): 6 sweeps, crash at 5.
    p6 = core.ExecutionPlan(pr, strategy="spu", max_iters=6, tol=0.0)
    for name, rs in (("host", host), ("disk", disk)):
        ck6 = CheckpointSpec(os.path.join(snaps, name), every=2, keep=2)
        t0 = time.perf_counter()
        before = ps.launches
        want6 = rs.run(p6)
        torch.cuda.synchronize()
        clean = ps.launches - before
        clean_s = time.perf_counter() - t0
        rs.inject_faults(FaultPlan.crash_at_sweep(5))
        before = ps.launches
        expect_crash(lambda: rs.run(dataclasses.replace(p6, checkpoint=ck6)), InjectedCrash, name)
        crashed = ps.launches - before
        before = ps.launches
        got = rs.run(dataclasses.replace(p6, checkpoint=ck6), resume_from=True)
        torch.cuda.synchronize()
        resumed = ps.launches - before
        rs.inject_faults(None)
        check(clean == 6 * slabs and crashed == 5 * slabs and resumed == 2 * slabs,
              f"{name}: B1 launches {clean}/{crashed}/{resumed} for {slabs} slabs a sweep")
        check(np.array_equal(got.attrs.view(np.int32), want6.attrs.view(np.int32)),
              f"{name} resume != uninterrupted bitwise")
        check(meters_but_wall(got.meters) == meters_but_wall(want6.meters), f"{name} resume meters differ")
        check(got.meters.bytes_h2d > 0 and (name == "host" or got.meters.bytes_disk_read > 0),
              f"{name}: nothing streamed")
        out[name] = {"launches": [clean, crashed, resumed], "ms_per_sweep_clean": 1e3 * clean_s / 6,
                     "bytes_h2d": got.meters.bytes_h2d, "bytes_disk_read": got.meters.bytes_disk_read}

    # The fused BFS batch (K = 8) at device residency: crash at 3, resume.
    ckb = CheckpointSpec(os.path.join(snaps, "bfs"), every=2, keep=2)
    bplans = [dataclasses.replace(p, checkpoint=ckb) for p in bfs_plans]
    sess.inject_faults(FaultPlan.crash_at_sweep(3))
    expect_crash(lambda: sess.run_batch(bplans), InjectedCrash, "bfs batch")
    before = ps.launches
    bb = sess.run_batch(bplans, resume_from=ckb.directory)
    torch.cuda.synchronize()
    bfs_resumed = ps.launches - before
    sess.inject_faults(None)
    check(bb.fused and bb.iterations == bfs.iterations and bfs_resumed == bfs.iterations - 2,
          f"BFS resume: fused {bb.fused}, {bb.iterations} sweeps, {bfs_resumed} launches")
    for a, b in zip(bb, bfs):
        check(np.array_equal(a.attrs, b.attrs), "resumed BFS batch != the main path's batch")
    check(meters_but_wall(bb.meters) == meters_but_wall(bfs.meters), "resumed BFS batch meters differ")
    out["bfs_k8"] = {"sweeps": bb.iterations, "launches_resumed": bfs_resumed,
                     "snapshot_bytes": os.path.getsize(list_snapshots(ckb.directory)[-1])}

    # Host residency under a transient H2D plan: heals to the clean bits and bytes.
    p3 = core.ExecutionPlan(pr, strategy="spu", max_iters=3, tol=0.0)
    clean3 = host.run(p3)
    host.inject_faults(FaultPlan.h2d_transient(rate=0.03, times=None, seed=21))
    before = ps.launches
    faulty = host.run(p3)
    torch.cuda.synchronize()
    fired = host.fault_injector.fired("h2d")
    host.inject_faults(None)
    check(ps.launches - before == 3 * slabs, "the transient plan changed B1's launches")
    check(fired > 0, "the transient H2D plan never fired")
    check(np.array_equal(faulty.attrs.view(np.int32), clean3.attrs.view(np.int32)),
          "transient H2D plan: PageRank != clean bitwise")
    check(meters_but_wall(faulty.meters) == meters_but_wall(clean3.meters)
          and faulty.meters.bytes_h2d == clean3.meters.bytes_h2d, "transient H2D plan: meters differ")
    out["h2d_transient"] = {
        "rate": 0.03, "fired": fired, "chunks_per_sweep": slabs,
        "ms_per_sweep_clean": 1e3 * clean3.meters.wall_seconds / 3,
        "ms_per_sweep_with_plan": 1e3 * faulty.meters.wall_seconds / 3,
        "bytes_h2d": faulty.meters.bytes_h2d,
    }

    # A disk session under a ReadPolicy, a torn p_dst read that clears.
    t0 = time.perf_counter()
    heal = core.GraphSession.open(
        path, verify=False, memory_budget=budget, host_memory_budget=0,
        read_policy=ReadPolicy(max_retries=3, backoff_s=0.0),
        fault_plan=FaultPlan.storage_corrupt("p_dst", times=2),
    )
    healed = heal.run(p1)
    heal_s = time.perf_counter() - t0
    want1 = sess.run(p1)
    check(heal.store.healed_reads > 0 and not heal.store.quarantined,
          f"healing read: healed {heal.store.healed_reads}, quarantined {sorted(heal.store.quarantined)}")
    check(np.array_equal(healed.attrs.view(np.int32), want1.attrs.view(np.int32)), "healed disk sweep != device")
    out["healing_read"] = {"healed_reads": heal.store.healed_reads, "open_and_one_sweep_s": heal_s}
    total = ps.launches  # just after the reliability path
    counts = {"packed_sweep": total, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(dk.launches == 0 and fa.launches == 0, f"the reliability path launched another kernel: {counts}")
    del host, disk, heal
    emit("reliability", launches=counts, slabs_per_streamed_sweep=slabs, **out, nvidia_smi=smi)
    return total, {"device_launches": [out["device"]["launches_crashed"], out["device"]["launches_resumed"]],
                   "snapshot_bytes": snap_bytes, "save_ms": float(np.median(save_ms)),
                   "restore_ms": float(np.median(restore_ms))}


def graph_serving(core, ps, dk, fa, g, sess, pr, budget, bfs, bfs_plans, path, smi) -> tuple[int, dict]:
    """The micro-batching GraphServer over a SessionPool at scale 22: served
    results bitwise equal to solo runs, meter shares, a deadline cut at a sweep
    boundary, the drivers' server=, and the .dsss file served from disk."""
    import asyncio
    import dataclasses

    from repro_torch.core import algorithms as alg
    from repro_torch.core.vertex_programs import BFS
    from repro_torch.obs import TRACER, TraceSpec
    from repro_torch.serving import DeadlineExceeded, GraphServer, QueryRequest, SessionPool

    pool = SessionPool()
    # The main path's staged graph: the pool's session stages nothing anew.
    pool.register("g22", g, residency="device", memory_budget=budget, staged=sess._staged)
    solo = pool.session("g22")
    rng = np.random.default_rng(1)
    roots = rng.choice(np.flatnonzero(g.out_degree[: g.n] > 0), size=32, replace=False)
    bplans = [core.ExecutionPlan(BFS(), max_iters=g.n + 1, program_kwargs={"root": int(r)}) for r in roots]
    prplan = core.ExecutionPlan(pr, strategy="spu", max_iters=10, tol=0.0)
    solo.run(core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0))  # warm
    torch.cuda.synchronize()

    ps.launches = 0  # every count to 0 just before the serving path
    dk.launches = 0
    fa.launches = 0
    server = GraphServer(pool, max_batch=8, max_wait_ms=2.0)
    reqs = [QueryRequest("g22", p) for p in bplans] + [QueryRequest("g22", prplan) for _ in range(8)]
    t0 = time.perf_counter()
    before = ps.launches
    served = server.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = ps.launches - before
    st = server.stats()
    batches = {}
    for q in served:
        batches.setdefault(id(q.result.meters), []).append(q)
    sweeps = sum(qs[0].result.meters.iterations for qs in batches.values())
    check(st.completed == 40 and st.fused_batches == st.batches == 5 and st.mean_occupancy == 8.0,
          f"serving: {st.completed} done in {st.batches} batches ({st.fused_batches} fused)")
    check(serve_launches == sweeps, f"serving: {serve_launches} B1 launches over {sweeps} fused sweeps")
    for qs in batches.values():  # the shares recombine to each batch's meters
        merged = core.Meters()
        for q in qs:
            merged.merge(q.meters)
        whole = qs[0].result.meters
        check(meters_but_wall(merged) == meters_but_wall(whole)
              and abs(merged.wall_seconds - whole.wall_seconds) <= 1e-9 * max(whole.wall_seconds, 1.0),
              "split_meters shares do not recombine to the batch's meters")
    solo_res = [solo.run(p) for p in bplans]
    pr_solo = solo.run(prplan)
    for q, want in zip(served, solo_res + [pr_solo] * 8):
        check(np.array_equal(q.result.attrs.view(np.int32), want.attrs.view(np.int32))
              and q.result.iterations == want.iterations, "a served result != its solo run bitwise")

    # A deadline that expires mid-run, at a sweep boundary: 8 personalized
    # PageRank queries of 200 sweeps (a loop of about a second, so the cut
    # lands well inside it whatever the host's jitter). The second of two
    # traced solo runs of the batch (warm, as the served one is) gives the
    # set-up before the sweep loop and the loop; the deadline is the
    # set-up, the batching window and half the loop.
    ppr = [core.ExecutionPlan(pr, strategy="spu", max_iters=200, tol=0.0,
                              program_kwargs={"personalize": int(r)}) for r in roots[:8]]
    for _ in range(2):
        mark = TRACER.mark()
        t1 = time.perf_counter()
        solo.run_batch([dataclasses.replace(p, trace=TraceSpec()) for p in ppr])
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t1
    (run_span,) = [sp for sp in TRACER.spans(since=mark) if sp.name == "run"]
    setup_s, loop_s = run_span.ts - t1, run_span.dur
    deadline = setup_s + 2e-3 + loop_s / 2

    async def with_deadline():
        async with GraphServer(pool, max_batch=8, max_wait_ms=2.0) as srv:
            futs = [await srv.submit(QueryRequest("g22", p, deadline_s=deadline if i == 0 else None))
                    for i, p in enumerate(ppr)]
            got = await asyncio.gather(*futs, return_exceptions=True)
            return got, srv.stats()

    before = ps.launches
    got, dst = asyncio.run(with_deadline())
    torch.cuda.synchronize()
    deadline_launches = ps.launches - before
    check(isinstance(got[0], DeadlineExceeded) and dst.timeouts == 1 and dst.failed == 0,
          f"deadline: {type(got[0]).__name__}, timeouts {dst.timeouts}")
    # Cut mid-run: the cancelled attempt's sweeps came before the 7 survivors' run.
    rerun = got[1].result.meters.iterations
    check(deadline_launches > rerun, f"deadline: {deadline_launches} launches, no partial run before "
          f"the survivors' {rerun} sweeps (shed in the queue, not cut at a sweep boundary)")
    for q, p in zip(got[1:], ppr[1:]):
        check(not isinstance(q, Exception) and q.fused and q.batch_size == 7
              and np.array_equal(q.result.attrs.view(np.int32), solo.run(p).attrs.view(np.int32)),
              "a batch-mate of the cancelled request != its solo run")

    # The drivers' server=: multi_bfs through a server equals the direct batch.
    direct = alg.multi_bfs(g, roots[:8], P=g.P, memory_budget=budget, residency="device")
    via = alg.multi_bfs(g, roots[:8], P=g.P, memory_budget=budget, residency="device",
                        server=GraphServer(max_batch=8, max_wait_ms=2.0))
    check(via.fused and all(np.array_equal(a.attrs, b.attrs) for a, b in zip(direct, via)),
          "multi_bfs(server=) != multi_bfs")

    # The .dsss file registered again, at disk residency (budget A, nothing
    # cached): the main path's 8 roots in one fused batch.
    pool.register("g22_disk", path, memory_budget=budget, host_memory_budget=0, verify=False)
    before = ps.launches
    t1 = time.perf_counter()
    disk_served = GraphServer(pool, max_batch=8, max_wait_ms=2.0).serve(
        [QueryRequest("g22_disk", p) for p in bfs_plans])
    torch.cuda.synchronize()
    disk_s = time.perf_counter() - t1
    disk_launches = ps.launches - before
    check(pool.session("g22_disk").resolved_residency() == "disk", "the file did not open at disk residency")
    check(all(q.fused and q.batch_size == 8 for q in disk_served), "disk requests did not fuse into one batch")
    for q, want in zip(disk_served, bfs):
        check(np.array_equal(q.result.attrs, want.attrs), "disk-served BFS != device batch")
    total = ps.launches  # just after the serving path
    counts = {"packed_sweep": total, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(dk.launches == 0 and fa.launches == 0, f"the serving path launched another kernel: {counts}")
    out = {
        "requests": 40, "batches": st.batches, "mean_occupancy": st.mean_occupancy, "qps": st.qps,
        "serve_s": serve_s, "p50_total_s": st.p50_total_s, "p99_total_s": st.p99_total_s,
        "mean_queue_s": st.mean_queue_s, "mean_run_s": st.mean_run_s, "max_total_s": st.max_total_s,
        "fused_sweeps": sweeps, "launches_served": serve_launches,
        "launches_per_fused_sweep": serve_launches / sweeps,
        "deadline_s": deadline, "solo_batch_s": batch_s, "solo_setup_s": setup_s, "solo_loop_s": loop_s,
        "deadline_launches": deadline_launches,
        "deadline_cut_after_sweeps": deadline_launches - rerun,
        "disk": {"sweeps": disk_served[0].result.meters.iterations, "launches": disk_launches,
                 "seconds": disk_s, "bytes_disk_read": disk_served[0].result.meters.bytes_disk_read},
    }
    emit("graph_serving", launches=counts, **out, nvidia_smi=smi)
    return total, {"launches_per_fused_sweep": out["launches_per_fused_sweep"], "qps": st.qps,
                   "mean_occupancy": st.mean_occupancy, "p50_total_s": st.p50_total_s,
                   "p99_total_s": st.p99_total_s}


# -- the 2-D partitioned PageRank over gloo ranks on one card (ROADMAP A12) --
DIST_ITERS = 12
# (label, shape, axes, source axes); the last axis is the destination axis.
DIST_MESHES = {
    1: (("1x1", (1, 1), ("data", "model"), ("data",)),),
    4: (("2x2", (2, 2), ("data", "model"), ("data",)),
        ("2x2_again", (2, 2), ("data", "model"), ("data",)),
        ("2x1x2", (2, 1, 2), ("pod", "data", "model"), ("pod", "data"))),
}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _empty_cache(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def distributed_rank(rank: int, jobs, n: int, n_pads, block_dir: str, device: str) -> dict:
    """One gloo rank (spawned): each mesh of ``jobs`` through
    ``distributed_pagerank`` on this rank's block file (``n_pads`` maps a
    grid ``(R, C)`` to its ``n_pad``), with one step made first (its
    placement names the block file), then that step timed per iteration,
    and again with the device synchronised around ToHub and each collective
    to split it; the step's groups are destroyed at the end. Every rank of
    this machine uses card 0."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.launch.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {}
    for label, shape, axes, src_axes in jobs:
        mesh = make_mesh(shape, axes, device=device)
        R, C = tdist._grid(mesh, src_axes, axes[-1])
        step, place = tdist.make_pagerank_step(mesh, n, n_pads[R, C], src_axes=src_axes, dst_axis=axes[-1])
        blk = tdist.RankBlock.load(os.path.join(block_dir, f"{R}x{C}_{place.row}_{place.col}.npz"))
        first, made = {}, {}
        kernel = dk.subshard_update

        def recording(*args, **kw):
            hub = kernel(*args, **kw)
            if not first:
                first.update(args=(args[0].clone(), *args[1:]), kw=kw, hub=hub.clone())
            return hub

        def keeping(fn):  # the run's B2 operands, reused for timing
            def call(*args, **kw):
                made["ops"] = fn(*args, **kw)
                return made["ops"]
            return call

        saved = tdist.tohub_operands
        dk.subshard_update = recording
        tdist.tohub_operands = keeping(saved)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            ps.launches = 0  # every count to 0 just before the distributed path
            dk.launches = 0
            fa.launches = 0
            t0 = time.perf_counter()
            ranks, iters = tdist.distributed_pagerank(blk, mesh, iters=DIST_ITERS, src_axes=src_axes,
                                                      dst_axis=axes[-1], tol=0.0, step=step)
            _sync(dev)
            run_s = time.perf_counter() - t0
            counts = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
        finally:
            dk.subshard_update = kernel
            tdist.tohub_operands = saved
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        want = dk.subshard_update_ref(*first["args"], **first["kw"])
        hub_bitwise = torch.equal(first["hub"].view(torch.int32), want.view(torch.int32))
        del first, want
        ops = made["ops"]

        # ms per iteration through the same step (staging outside the clock)
        x0 = torch.zeros(blk.n_pad, device=dev)
        x0[: blk.n] = 1.0 / blk.n
        x0 = x0[place.row_slice].contiguous()
        dang = torch.from_numpy(blk.dangling).to(dev)

        def loop():
            x = x0
            for _ in range(DIST_ITERS):
                x, _ = step(x, dang, ops)
            _sync(dev)

        loop()  # warm
        dist.barrier()
        t0 = time.perf_counter()
        loop()
        ms_iter = 1e3 * (time.perf_counter() - t0) / DIST_ITERS
        split = {"tohub": 0.0, "all_reduce": 0.0, "all_gather": 0.0}

        def timed(name, fn):
            def call(*args, **kw):
                _sync(dev)
                t = time.perf_counter()
                res = fn(*args, **kw)
                _sync(dev)
                split[name] += 1e3 * (time.perf_counter() - t) / DIST_ITERS
                return res
            return call

        saved = tdist.tohub, dist.all_reduce, dist.all_gather
        tdist.tohub, dist.all_reduce, dist.all_gather = (
            timed("tohub", saved[0]), timed("all_reduce", saved[1]), timed("all_gather", saved[2]))
        try:
            dist.barrier()
            t0 = time.perf_counter()
            loop()
            ms_split_run = 1e3 * (time.perf_counter() - t0) / DIST_ITERS
        finally:
            tdist.tohub, dist.all_reduce, dist.all_gather = saved
        out[label] = {
            "rank": rank, "block": [place.row, place.col], "edges": int(len(blk.src_local)),
            "e_max": blk.e_max, "hub_slots": ops.num_slots, "iterations": iters, "launches": counts,
            "first_hub_bitwise": hub_bitwise, "run_s": run_s, "ms_per_iteration": ms_iter,
            "split_ms_per_iteration": split, "split_run_ms_per_iteration": ms_split_run,
            "peak_device_bytes": peak, "sha256": hashlib.sha256(ranks.tobytes()).hexdigest(),
            "ranks": ranks if rank == 0 else None,
        }
        step.close()
        del step, ops, made, blk, mesh
        dist.barrier()
    return out


def distributed(el, fused12, p12, smi, build_root, device="cuda") -> tuple[int, dict]:
    """The 2-D partitioned PageRank at scale 22 on gloo ranks sharing one card."""
    import shutil
    import tempfile

    from repro_torch.core import distributed as tdist

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="distributed-", dir=build_root)
    blocks_info, n_pads = {}, {}
    try:
        for R, C in ((1, 1), (2, 2)):
            t1 = time.perf_counter()
            blocks = tdist.build_device_blocks(el, R, C)
            build_s = time.perf_counter() - t1
            n_pads[R, C] = blocks.n_pad
            for r in range(R):
                for c in range(C):
                    blocks.rank_block(r, c, el.out_degree).save(os.path.join(tmp, f"{R}x{C}_{r}_{c}.npz"))
            blocks_info[f"{R}x{C}"] = {"edges": blocks.edge_counts().tolist(), "e_max": int(blocks.weight.shape[-1]),
                                       "n_pad": blocks.n_pad, "build_s": build_s,
                                       "build_and_write_s": time.perf_counter() - t1}
            del blocks
        host_s = time.perf_counter() - t0
        results = {}
        for world, jobs in DIST_MESHES.items():
            t1 = time.perf_counter()
            per_rank = tdist.spawn_gloo(distributed_rank, world, jobs, el.n, n_pads, tmp, device)
            spawn_s = time.perf_counter() - t1
            for label, *_ in jobs:
                results[label] = {"ranks_out": [r[label] for r in per_rank], "group_s": spawn_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = 0
    summary = {}
    for label, res in results.items():
        rows = res["ranks_out"]
        world = len(rows)
        ranks = rows[0]["ranks"]
        check(all(r["sha256"] == rows[0]["sha256"] for r in rows), f"{label}: the ranks returned other vectors")
        check(all(r["iterations"] == DIST_ITERS for r in rows), f"{label}: iterations {[r['iterations'] for r in rows]}")
        check(all(r["first_hub_bitwise"] for r in rows), f"{label}: a rank's first hub != subshard_update_ref")
        counts = [r["launches"] for r in rows]
        check(all(c["packed_sweep"] == 0 and c["flash_attention"] == 0 for c in counts),
              f"{label}: another kernel launched: {counts}")
        n_b2 = sum(c["dsss_spmv"] for c in counts)
        check(n_b2 == world * DIST_ITERS, f"{label}: {n_b2} B2 launches for {world} ranks x {DIST_ITERS} iterations")
        launches += n_b2
        # Bars scaled to the values: a rank here is about 1/n (2.4e-7), so the
        # reference selftest's 1e-6 max abs would pass a fault that moves every
        # entry by a typical rank. The fused engine and the mesh sum in other
        # orders, so an entry differs by float32 rounding that grows with the
        # number of terms it gathers: far below 1e-3 of the entry.
        diff = np.abs(ranks.astype(np.float64) - fused12)
        err = float(diff.max())
        check(err < 1e-7, f"{label}: max abs {err} from the fused 12-sweep PageRank")
        rel = float((diff / fused12).max())  # every rank is at least (1 - d) / n > 0
        check(rel < 1e-3, f"{label}: max relative difference {rel} from the fused 12-sweep PageRank")
        total = float(ranks.astype(np.float64).sum())
        check(abs(total - 1.0) < 2e-6, f"{label}: ranks sum to {total}")
        l1 = float(np.abs(ranks.astype(np.float64) - p12).sum())
        check(l1 < 2e-6, f"{label}: L1 {l1} from the float64 power iteration")
        split = {k: [r["split_ms_per_iteration"][k] for r in rows] for k in ("tohub", "all_reduce", "all_gather")}
        summary[label] = {
            "ranks": world, "ms_per_iteration": [r["ms_per_iteration"] for r in rows],
            "split_ms_per_iteration": split,
            "split_run_ms_per_iteration": [r["split_run_ms_per_iteration"] for r in rows],
            "blocks": [r["block"] for r in rows], "block_edges": [r["edges"] for r in rows],
            "e_max": rows[0]["e_max"], "hub_slots": [r["hub_slots"] for r in rows],
            "peak_device_bytes": [r["peak_device_bytes"] for r in rows],
            "b2_launches": n_b2, "max_abs_vs_fused": err, "max_rel_vs_fused": rel,
            "max_rank": float(fused12.max()), "sum": total, "l1_vs_float64": l1,
            "run_s": [r["run_s"] for r in rows], "spawn_group_s": res["group_s"],
        }
    check(results["2x2"]["ranks_out"][0]["sha256"] == results["2x2_again"]["ranks_out"][0]["sha256"],
          "two (2, 2) runs gave other bits")
    emit("distributed", meshes=summary, blocks=blocks_info, host_blocks_s=host_s,
         iterations=DIST_ITERS, b2_launches=launches, phase_s=time.perf_counter() - t0,
         note="one card shared by the ranks, collectives through gloo: not a multi-GPU measurement",
         nvidia_smi=smi)
    return launches, {k: {"ms_per_iteration": max(v["ms_per_iteration"]),
                          "split_ms_per_iteration": {s: max(t) for s, t in v["split_ms_per_iteration"].items()}}
                      for k, v in summary.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    import dataclasses

    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.convert import aux_from_numpy
    from repro_torch.core import session as session_mod
    from repro_torch.core import vertex_programs as vp
    from repro_torch.core.identities import reduce_identity
    from repro_torch.graph.generators import rmat, zipf
    from repro_torch.graph.preprocess import degree_and_densify
    from repro_torch.kernels import _build
    from repro_torch.kernels import dsss_spmv as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import packed_sweep as ps
    from repro_torch.launch import b1_cases

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
    b3_build = b3_build_report(_build)
    emit("b3_build", **b3_build)
    check(b3_build["sass"]["HGMMA"] + b3_build["sass"]["HMMA"] > 0,
          "the flash_attention library holds no tensor-core instruction")

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
    src_sorted_cases = 0
    for gname in ("rmat14", "zipf", "rmat14_src_sorted"):
        src, dst = zipf(1 << 14, 1 << 18, seed=2) if gname == "zipf" else rmat(
            14, edge_factor=16, seed=1
        )
        src_sorted = gname.endswith("src_sorted")
        for weighted in (False, True):
            w = rng.random(src.shape[0]).astype(np.float32) + 0.01 if weighted else None
            el = degree_and_densify(src, dst, w, drop_self_loops=True)
            for P in (4, 16):
                g = core.build_dsss(el, P, src_sorted=src_sorted)
                for packing in ("subshard",) if src_sorted else ("adaptive", "subshard"):
                    packed = g.packed_sweep(packing)
                    tiles = ps.prepare_packed_tiles(packed, has_weights=weighted, device=dev)
                    check(("perm" in tiles) == src_sorted, f"{gname} P={P} {packing}: run permutation")
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
                            src_sorted_cases += src_sorted
    # Hand-made layouts that reach every branch of the kernel (b1_cases).
    hand_cases = 0
    by_name = dict(zip(b1_cases.PROGRAMS, programs))
    for cname in b1_cases.CASES:
        for pname in b1_cases.PROGRAMS:
            c = b1_cases.case(cname, pname)
            tiles = ps.prepare_packed_tiles(c["packed"], has_weights=c["weighted"], device=dev)
            idx = None if c["idx"] is None else torch.from_numpy(c["idx"]).to(dev)
            args = (by_name[pname], torch.from_numpy(c["attrs"]).to(dev), torch.from_numpy(c["acc"]).to(dev),
                    aux_from_numpy(c["aux"], dev), tiles, torch.from_numpy(c["row"]).to(dev),
                    c["weighted"], c["stacked"], idx)
            got = ps.packed_sweep_update(*args)
            again = ps.packed_sweep_update(*args)
            want = ps.packed_sweep_update_ref(*args)
            torch.cuda.synchronize()
            label = f"hand-made {cname} {pname}"
            check(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"kernel not deterministic: {label}")
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)), f"kernel != plain: {label}")
            diff = (got.double() - want.double()).abs()
            diff = diff[torch.isfinite(diff)]
            if diff.numel():
                max_abs_err = max(max_abs_err, float(diff.max()))
            hand_cases += 1
    emit(
        "kernel_vs_plain", cases=cases + hand_cases, src_sorted_cases=src_sorted_cases,
        hand_made_cases=hand_cases, launches=ps.launches - before, bitwise=True,
        max_abs_err=max_abs_err, seconds=time.perf_counter() - t0,
    )

    # -- phase 5: the sub-shard ToHub kernel against its plain version -------
    def b2_case(vals, ops, num_slots, gather_op, reduce, label):
        kw = dict(gather_op=gather_op, reduce=reduce)
        parts = dk.dsss_spmv_block_partials(vals, *ops, **kw)
        hub = dk.subshard_update(vals, *ops, num_slots, **kw)
        again = dk.subshard_update(vals, *ops, num_slots, **kw)
        want_parts = dk.dsss_spmv_block_partials_ref(vals, *ops, **kw)
        want = dk.subshard_update_ref(vals, *ops, num_slots, **kw)
        torch.cuda.synchronize()
        check(torch.equal(b2_bits(hub), b2_bits(again)), f"dsss_spmv not deterministic: {label}")
        check(torch.equal(b2_bits(parts), b2_bits(want_parts)), f"dsss_spmv partials != plain: {label}")
        check(torch.equal(b2_bits(hub), b2_bits(want)), f"dsss_spmv hub != plain: {label}")
        diff = (hub.double() - want.double()).abs()
        diff = diff[torch.isfinite(diff)]
        return float(diff.max()) if diff.numel() else 0.0

    semirings = (("mul", "sum"), ("add", "min"), ("add", "max"))
    b2_cases = 0
    b2_max_abs_err = 0.0
    t0 = time.perf_counter()
    before = dk.launches
    for dtype in (torch.float32, torch.bfloat16):
        for gather_op, reduce in semirings:
            shapes = [(64, 100, 32, True), (300, 2000, 150, True), (128, 513, 128, True),
                      (1000, 4096, 999, True), (16, 8, 4, True), (300, 2000, 150, False)]
            for isize, e, nslots, sorted_slots in shapes:
                r = np.random.default_rng(e + isize)
                src_local = r.integers(0, isize, e).astype(np.int32)
                hub_inv = r.integers(0, nslots, e).astype(np.int32)
                if sorted_slots:
                    hub_inv = np.sort(hub_inv)
                w = r.random(e).astype(np.float32) + 0.1
                vals = torch.from_numpy(r.random(isize).astype(np.float32) + 0.5).to(dtype).to(dev)
                ops = kops.prepare_subshard_operands(
                    src_local, hub_inv, w, dtype, gather_op=gather_op, reduce=reduce, device=dev
                )
                label = f"{dtype} {gather_op}/{reduce} {isize}x{e}x{nslots} sorted={sorted_slots}"
                b2_max_abs_err = max(b2_max_abs_err, b2_case(vals, ops, nslots, gather_op, reduce, label))
                b2_cases += 1
    src, dst = rmat(14, edge_factor=16, seed=1)
    w14 = rng.random(src.shape[0]).astype(np.float32) + 0.01
    g14 = core.build_dsss(degree_and_densify(src, dst, w14, drop_self_loops=True), 4)
    sess14 = core.GraphSession(g14, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for gather_op, reduce in semirings:
            for i, j in sorted(sess14.block_keys):
                vals = torch.from_numpy(rng.random(g14.interval_size).astype(np.float32)).to(dtype).to(dev)
                ops = sess14.kernel_operands(i, j, dtype, gather_op=gather_op, reduce=reduce)
                label = f"rmat14 SS[{i},{j}] {dtype} {gather_op}/{reduce}"
                u = sess14.host_blocks[(i, j)]["u"]
                b2_max_abs_err = max(b2_max_abs_err, b2_case(vals, ops, u, gather_op, reduce, label))
                b2_cases += 1
    # The pass entry: the edge cases in one pass per semiring and dtype, and
    # every sub-shard of R-MAT 14 (P = 4) and of its src_sorted build.
    pass_cases = 0
    el14 = degree_and_densify(src, dst, w14, drop_self_loops=True)
    for dtype in (torch.float32, torch.bfloat16):
        for gather_op, reduce in semirings:
            sp, vals = b2_edge_case_pass(kops, dev, dtype, gather_op, reduce)
            b2_max_abs_err = max(b2_max_abs_err, b2_pass_case(dk, vals, sp, f"edge cases {dtype} {gather_op}/{reduce}"))
            pass_cases += 1
            for src_sorted in (False, True):
                gp = core.build_dsss(el14, 4, src_sorted=src_sorted)
                sp_sess = core.GraphSession(gp, device=dev)
                keys14 = sorted(sp_sess.block_keys)
                sp = kops.prepare_subshard_pass(
                    [sp_sess.kernel_operands(i, j, dtype, gather_op=gather_op, reduce=reduce) for i, j in keys14],
                    [i * gp.interval_size for i, _ in keys14], [gp.interval_size] * len(keys14),
                    [sp_sess.host_blocks[key]["u"] for key in keys14], gather_op=gather_op, reduce=reduce,
                )
                check(bool(sp.flags[0].all()) == src_sorted and (src_sorted or not sp.flags[0].any()),
                      f"rmat14 src_sorted={src_sorted}: pass flags {sp.flags[0].tolist()}")
                vals = torch.from_numpy(rng.random(gp.n_pad).astype(np.float32)).to(dtype).to(dev)
                label = f"rmat14 pass src_sorted={src_sorted} {dtype} {gather_op}/{reduce}"
                b2_max_abs_err = max(b2_max_abs_err, b2_pass_case(dk, vals, sp, label))
                pass_cases += 1
    emit(
        "dsss_spmv_vs_plain", cases=b2_cases, pass_cases=pass_cases, launches=dk.launches - before,
        bitwise=True, max_abs_err=b2_max_abs_err, seconds=time.perf_counter() - t0,
    )
    del sess14, g14

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
        long_runs=int(((tiles["run_end"] - tiles["run_start"]) > ps.LONG_RUN).sum()),
        chunks=int(tiles["chunks"].shape[0]),
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
    dk.launches = 0
    fa.launches = 0
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
    check(dk.launches == 0 and fa.launches == 0, "the packed path launched another kernel")
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
    p12 = p  # two more iterations: the distributed phase's 12
    for _ in range(2):
        mass = p12[outdeg == 0].sum()
        p12 = (1 - pr.damping) / n + pr.damping * ((at64 @ (p12 * inv64)[:, None])[:, 0] + mass / n)
    p12 = p12.cpu().numpy()
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

    # -- phases 3d-3e: the plain scan by name, and the drivers ---------------
    packed_scan_path(core, ps, dk, fa, g, sess, budget, pr, bfs_plans, bfs, smi)
    driver_launches = drivers(core, ps, dk, fa, dev, g, ref, bfs, roots, smi)

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

    # -- phase 3c: a src_sorted layout through the default execution ---------
    # R-MAT scale 18, P = 8, built src_sorted (the GraphChi-like layout) and
    # destination-sorted; GraphSession(g) defaults to execution="auto", which
    # is kernel B1 on the card, reaching runs through the edge permutation.
    t1 = time.perf_counter()
    el18 = degree_and_densify(*rmat(18, edge_factor=16, seed=3), drop_self_loops=True)
    s18 = {layout: core.GraphSession(core.build_dsss(el18, 8, src_sorted=layout == "src_sorted"))
           for layout in ("src_sorted", "dst_sorted")}
    plan18 = core.ExecutionPlan(pr, strategy="spu", max_iters=10, tol=0.0)
    check(s18["src_sorted"].resolved_execution("spu", "device") == "packed_kernel", "auto is not the kernel")
    for s_ in s18.values():
        s_.run(core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0))  # stage, warm
    torch.cuda.synchronize()
    tiles18 = s18["src_sorted"]._staged.packed_tiles("subshard", dev)
    ps.launches = 0  # every count to 0 just before the src_sorted path
    dk.launches = 0
    fa.launches = 0
    res18 = s18["src_sorted"].run(plan18)
    torch.cuda.synchronize()
    counts18 = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches, "flash_attention": fa.launches}
    check(counts18 == {"packed_sweep": 10, "dsss_spmv": 0, "flash_attention": 0},
          f"src_sorted path launched {counts18}; want 10 packed_sweep launches")
    dst18 = s18["dst_sorted"].run(plan18)
    session_mod.packed_sweep_update = ps.packed_sweep_update_ref
    try:
        plain18 = s18["src_sorted"].run(plan18)
    finally:
        session_mod.packed_sweep_update = ps.packed_sweep_update
    check(np.array_equal(res18.attrs.view(np.int32), plain18.attrs.view(np.int32)),
          "src_sorted PageRank (kernel) != plain version bitwise over 10 sweeps")
    total18 = float(res18.attrs.astype(np.float64).sum())
    check(abs(total18 - 1.0) < 1e-4, f"src_sorted PageRank sums to {total18}")
    emit(
        "src_sorted_path", n=int(el18.n), m=int(el18.m), P=8, launches=counts18,
        perm_edges=int(tiles18["perm"].shape[0]), runs=int(tiles18["run_start"].shape[0]),
        bitwise_vs_plain=True, pr_sum=total18,
        max_abs_diff_vs_dst_sorted=float(np.max(np.abs(res18.attrs.astype(np.float64) - dst18.attrs))),
        ms_per_sweep={"src_sorted": 1e3 * res18.meters.wall_seconds / 10,
                      "dst_sorted": 1e3 * dst18.meters.wall_seconds / 10},
        seconds=time.perf_counter() - t1,
    )
    del s18, tiles18, el18

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
    L = int(((tiles["run_end"] - tiles["run_start"]) > ps.LONG_RUN).sum())
    min_bytes = 16 * g.n_pad + 4 * g.m + 12 * R + 4 * L + 4 * (g.n_pad + 1) + g.P
    ops = 2 * g.m  # one multiply per edge, one add per edge
    bound_ms = 1e3 * max(min_bytes / H100_BYTES_PER_S, ops / H100_FP32_PER_S)
    emit(
        "timing", kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, min_bytes=min_bytes, ops=ops,
        apply_ms=apply_ms, sweep_ms=mean_ms,
        kernel_share_of_sweep=kernel_ms / mean_ms, share_of_bound=bound_ms / kernel_ms,
        vs_library=kernel_ms / library_ms,
        device_kernels=device_kernels(lambda: ps.packed_sweep_update(*args)), nvidia_smi=smi,
    )
    b1_bound_by = "bytes" if min_bytes / H100_BYTES_PER_S >= ops / H100_FP32_PER_S else "operations"

    # -- phase 4b: B1 alone for the fused BFS batch (K = 8) ------------------
    # The BFS state of the main path's batch after its first sweeps is not
    # kept, so the depths are drawn (numpy seed 0) with half the vertices
    # unreached. Least bytes: attrs, acc in and out (4·K·n_pad each), the
    # sources of the m edges, each run's span and CSR entry, the long-run
    # list, CSR offsets and P flags; one min per edge and query.
    K8 = len(bfs_plans)
    r8 = np.random.default_rng(0)
    depth = r8.integers(0, 12, (K8, g.n_pad)).astype(np.int32)
    depth[r8.random((K8, g.n_pad)) < 0.5] = core.INF_DEPTH
    bfs_attrs = torch.from_numpy(depth).to(dev)
    args8 = (vp.BFS(), bfs_attrs, bfs_attrs.clone(), {}, tiles, row, False, True)
    check(torch.equal(ps.packed_sweep_update(*args8), ps.packed_sweep_update_ref(*args8)),
          "kernel != plain for the K = 8 BFS batch at the main path's shapes")
    k8_ms = cuda_ms(lambda: ps.packed_sweep_update(*args8), reps=20)
    k8_plain_ms = cuda_ms(lambda: ps.packed_sweep_update_ref(*args8), reps=2)
    k8_bytes = 12 * K8 * g.n_pad + 4 * g.m + 12 * R + 4 * L + 4 * (g.n_pad + 1) + g.P
    k8_ops = K8 * g.m
    k8_bound_ms = 1e3 * max(k8_bytes / H100_BYTES_PER_S, k8_ops / H100_FP32_PER_S)
    emit(
        "b1_k8", K=K8, kernel_ms=k8_ms, plain_ms=k8_plain_ms, library_ms=None,
        bound_ms=k8_bound_ms, min_bytes=k8_bytes, ops=k8_ops,
        bound_by="bytes" if k8_bytes / H100_BYTES_PER_S >= k8_ops / H100_FP32_PER_S else "operations",
        share_of_bound=k8_bound_ms / k8_ms,
        device_kernels=device_kernels(lambda: ps.packed_sweep_update(*args8)), nvidia_smi=smi,
    )
    del bfs_attrs, args8

    # -- phase 6: the per-block path at full width -----------------------------
    # Its float sums rest on torch.segment_reduce folding each segment in
    # order on the card when the data is 2-D (e, K); the 1-D form does not
    # (it reduces as a tree). Check the premise against the CPU's left fold.
    r = np.random.default_rng(5)
    seg_len = r.integers(1, 40, 5000)
    seg_len[::500] = 20000
    seg_data = (r.random((int(seg_len.sum()), 1)) * 10.0 ** r.integers(-3, 4, (int(seg_len.sum()), 1))).astype(np.float32)
    seg_cpu = torch.segment_reduce(torch.from_numpy(seg_data), "sum", lengths=torch.from_numpy(seg_len), axis=0, unsafe=True)
    seg_dev = torch.from_numpy(seg_data).to(dev)
    seg_len_dev = torch.from_numpy(seg_len).to(dev)
    seg_2d = torch.segment_reduce(seg_dev, "sum", lengths=seg_len_dev, axis=0, unsafe=True).cpu()
    seg_1d = torch.segment_reduce(seg_dev[:, 0].contiguous(), "sum", lengths=seg_len_dev, axis=0, unsafe=True).cpu()
    one_run = torch.rand(300_000, 1, device=dev)
    one_len = torch.tensor([300_000], device=dev)
    one_run_ms = cuda_ms(lambda: torch.segment_reduce(one_run, "sum", lengths=one_len, axis=0, unsafe=True), reps=5)
    seg_probe = {
        "segments": int(seg_len.shape[0]),
        "mismatch_2d": int((seg_2d.view(torch.int32) != seg_cpu.view(torch.int32)).sum()),
        "mismatch_1d": int((seg_1d.view(torch.int32) != seg_cpu[:, 0].view(torch.int32)).sum()),
        "one_300k_run_ms": one_run_ms,
    }
    check(seg_probe["mismatch_2d"] == 0, f"segment_reduce over (e, K) is not an ordered fold: {seg_probe}")
    emit("segment_reduce_order", **seg_probe)
    del seg_dev, one_run

    t0 = time.perf_counter()
    pb = core.GraphSession(
        g, device=None, residency="device", memory_budget=budget, execution="per_block"
    )
    host_blocks = pb.host_blocks
    t_host_blocks = time.perf_counter() - t0
    pb.run(core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0))  # stages, warms
    pb.fused_arrays()  # the fused path's destination-sorted edges, staged once
    torch.cuda.synchronize()
    t_stage_blocks = time.perf_counter() - t0 - t_host_blocks
    ps.launches = 0  # every count to 0 just before the per-block path
    dk.launches = 0
    fa.launches = 0
    pb_runs = {}
    pb_sweep_ms = {}
    pb_run_ms = {}
    for strategy in ("spu", "dpu", "mpu", "fused"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = pb.run(core.ExecutionPlan(pr, strategy=strategy, max_iters=10, tol=0.0))
        end.record()
        torch.cuda.synchronize()
        check(res.meters.iterations == 10, f"per_block {strategy}: {res.meters.iterations} sweeps")
        pb_runs[strategy] = res
        pb_sweep_ms[strategy] = 1e3 * res.meters.wall_seconds / res.meters.iterations
        pb_run_ms[strategy] = start.elapsed_time(end)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pb_bfs = pb.run_batch(bfs_plans)
    end.record()
    torch.cuda.synchronize()
    pb_bfs_run_ms = start.elapsed_time(end)
    pb_launches = {"packed_sweep": ps.launches, "dsss_spmv": dk.launches,
                   "flash_attention": fa.launches}  # just after
    check(pb_launches == {"packed_sweep": 0, "dsss_spmv": 0, "flash_attention": 0},
          f"the per-block path launched a kernel: {pb_launches}")
    for s in ("spu", "dpu", "mpu"):
        check(np.array_equal(pb_runs[s].attrs.view(np.int32), ref.view(np.int32)),
              f"per_block PageRank {s} != packed_kernel bitwise")
        check(pb_runs[s].meters.model_dict() == runs[s].meters.model_dict(),
              f"per_block {s} model meters != packed_kernel's")
    # Fused folds each destination's edges in one float32 run (the largest
    # hub has ~10^5), SPU per sub-shard first, so the two round apart: rtol
    # 1e-6 holds only on small graphs, as in the tests. The run is
    # deterministic; the limits are set from its readings on the H100 (max
    # rel 1.16e-5, L1 to float64 4.24e-7 against the packed SPU's 2.03e-7).
    fused = pb_runs["fused"].attrs
    fused_rel = float(np.max(np.abs(fused.astype(np.float64) - ref)
                             / np.maximum(np.abs(ref.astype(np.float64)), 1e-30)))
    check(np.allclose(fused, ref, rtol=3e-5, atol=1e-12),
          f"per_block fused PageRank off SPU by rtol {fused_rel}")
    fused_l1 = float((torch.from_numpy(fused.astype(np.float64)).to(dev) - p).abs().sum())
    check(fused_l1 < 1.3e-6, f"fused PageRank L1 distance to float64 power iteration {fused_l1}")
    check(pb_bfs.fused and pb_bfs.converged and pb_bfs.iterations == bfs.iterations,
          "per_block BFS batch did not fuse, converge or match the packed sweeps")
    for a, b in zip(pb_bfs, bfs):
        check(np.array_equal(a.attrs, b.attrs), "per_block BFS batch != packed_kernel batch")
    check(pb_bfs.meters.model_dict() == bfs.meters.model_dict(), "per_block BFS meters differ")
    emit(
        "per_block_path", launches=pb_launches, pr_ms_per_sweep=pb_sweep_ms,
        pr_run_ms=pb_run_ms, pr_mteps={s: r.meters.mteps() for s, r in pb_runs.items()},
        fused_max_rel_vs_spu=fused_rel, fused_l1_vs_float64=fused_l1, spu_l1_vs_float64=l1,
        bfs_sweeps=pb_bfs.iterations,
        bfs_ms_per_sweep=1e3 * pb_bfs.meters.wall_seconds / pb_bfs.iterations,
        bfs_run_ms=pb_bfs_run_ms, host_blocks_s=t_host_blocks,
        stage_and_warm_s=t_stage_blocks, peak_device_bytes=torch.cuda.max_memory_allocated(dev),
    )
    # The fused engine's 12 sweeps: the distributed phase's bar.
    fused12 = pb.run(core.ExecutionPlan(pr, strategy="fused", max_iters=12, tol=0.0)).attrs.astype(np.float64)
    baselines(core, ps, dk, fa, g, pb, pr, pb_runs["spu"].attrs, ref, smi)
    tile_bytes = sum(t.numel() * t.element_size() for t in tiles.values() if torch.is_tensor(t))
    host_launches, host_b1 = host_path(core, ps, dk, fa, dev, g, sess, pb, pr, budget, runs, ref, bfs,
                                       bfs_plans, roots, tile_bytes, smi)
    # The disk, reliability and serving paths share one .dsss file of the
    # scale-22 graph, written under the checkout's build/ and removed after.
    import shutil
    import tempfile

    build_root = Path(__file__).resolve().parent / "build"
    build_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="disk_path-", dir=build_root)
    try:
        disk_launches, disk_b1 = disk_path(core, ps, dk, fa, dev, g, sess, pb, pr, budget, ref, bfs,
                                           bfs_plans, tmp, smi)
        g22_path = os.path.join(tmp, "g22.dsss")
        rel_launches, rel_b1 = reliability(core, ps, dk, fa, dev, g, sess, pr, budget, runs, bfs, bfs_plans,
                                           g22_path, tmp, smi)
        gs_launches, gs_b1 = graph_serving(core, ps, dk, fa, g, sess, pr, budget, bfs, bfs_plans, g22_path,
                                           smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- phase 7: one PageRank sweep from the sub-shard kernel -----------------
    # Twice: through the pass entry (one launch per phase for all sub-shards)
    # and through subshard_update (one call per sub-shard).
    isz = g.interval_size
    keys = sorted(pb.block_keys)
    staged = {}  # operands, hub destinations, and the source interval of each call
    for i, j in keys:
        blk = host_blocks[(i, j)]
        staged[(i, j)] = (
            pb.kernel_operands(i, j, torch.float32, gather_op="mul", reduce="sum"),
            torch.from_numpy(blk["hub_dst"][: blk["u"]].astype(np.int64)).to(dev),
            blk["u"],
        )
    t1 = time.perf_counter()
    b2_staged = kops.prepare_subshard_pass(
        [staged[key][0] for key in keys], [i * isz for i, _ in keys], [isz] * len(keys),
        [staged[key][2] for key in keys], gather_op="mul", reduce="sum",
    )
    torch.cuda.synchronize()
    b2_stage_s = time.perf_counter() - t1
    check(not b2_staged.flags.any(), "a scale-22 sub-shard's slots or bases decrease")
    x0 = pr.init_attrs(g).to(dev)
    inv = aux["inv_out_degree"]
    contrib = x0 * inv
    dangling = float((x0 * aux["dangling"]).sum())
    torch.cuda.synchronize()

    def hubs_by_calls():
        """The ToHub update of every sub-shard, one subshard_update call each."""
        return [
            kops.subshard_update(contrib[i * isz:(i + 1) * isz], *staged[(i, j)][0], staged[(i, j)][2],
                                 gather_op="mul", reduce="sum")
            for i, j in keys
        ]

    def hubs_by_pass():
        """The same hub vectors from one call of the pass entry."""
        hubs, off = dk.subshard_update_pass(contrib, b2_staged)
        return [hubs[off[k]:off[k + 1]] for k in range(len(keys))]

    def sweep_from(hubs):
        accs = [torch.zeros(isz, device=dev) for _ in range(g.P)]
        for (i, j), hub in zip(keys, hubs):
            hub_dst = staged[(i, j)][1]
            accs[j][hub_dst] = accs[j][hub_dst] + hub
        return (1 - pr.damping) / n + pr.damping * (torch.cat(accs) + dangling / n)

    ps.launches = 0  # every count to 0 just before the pass entry's sweep
    dk.launches = 0
    fa.launches = 0
    pass_hubs = hubs_by_pass()
    torch.cuda.synchronize()
    pass_launches = dk.launches  # just after
    check(pass_launches == 1 and ps.launches == 0 and fa.launches == 0,
          f"pass entry: {pass_launches} dsss_spmv launches, {ps.launches} packed_sweep, {fa.launches} flash")
    ps.launches = 0  # every count to 0 just before the per-call sweep
    dk.launches = 0
    fa.launches = 0
    call_hubs = hubs_by_calls()
    torch.cuda.synchronize()
    sub_launches = dk.launches  # just after
    check(sub_launches == len(keys), f"sub-shard path: {sub_launches} launches for {len(keys)} calls")
    check(ps.launches == 0 and fa.launches == 0, "the sub-shard path launched another kernel")
    for k, (a, b) in enumerate(zip(pass_hubs, call_hubs)):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"pass entry != subshard_update on scale-22 sub-shard {keys[k]}")
    swept_pass, swept_calls = sweep_from(pass_hubs), sweep_from(call_hubs)
    check(torch.equal(swept_pass.view(torch.int32), swept_calls.view(torch.int32)),
          "sub-shard sweep: pass entry != subshard_update calls")
    one = sess.run(core.ExecutionPlan(pr, strategy="spu", max_iters=1, tol=0.0)).attrs
    swept_np = swept_pass[:n].cpu().numpy()
    sub_err = float(np.max(np.abs(swept_np.astype(np.float64) - one)))
    check(np.allclose(swept_np, one, rtol=1e-5, atol=1e-12),
          f"sub-shard kernel sweep off the session's by {sub_err}")
    emit(
        "subshard_kernel_path", pass_launches=pass_launches, call_launches=sub_launches,
        subshards=len(keys), blocks=int(b2_staged.block_base.shape[0]),
        padded_edges=int(b2_staged.src_idx.shape[0]), pass_staging_s=b2_stage_s,
        pass_equals_calls_bitwise=True, max_abs_err_vs_session=sub_err,
        sum=float(swept_np.astype(np.float64).sum()),
    )
    del pass_hubs, call_hubs, swept_pass, swept_calls

    # -- phase 8: dsss_spmv timing over a full pass ------------------------------
    def one_pass():
        return dk.subshard_update_pass(contrib, b2_staged)

    b2_ms = cuda_ms(one_pass, reps=20)
    b2_calls_ms = cuda_ms(hubs_by_calls, reps=10)
    b2_wall_ms = host_ms(one_pass, reps=20)
    b2_calls_wall_ms = host_ms(hubs_by_calls, reps=10)
    plain = []
    b2_plain_ms = cuda_ms(lambda: plain.append(dk.subshard_update_pass_ref(contrib, b2_staged)[0]), reps=1, warm=0)
    # Both forms against the plain version at the main path's shapes: every
    # sub-shard, bitwise, twice (hub runs here span up to ~40 blocks).
    plain_hubs = plain[0]
    for _ in range(2):
        for form, hubs in (("pass entry", torch.cat(hubs_by_pass())), ("subshard_update", torch.cat(hubs_by_calls()))):
            check(torch.equal(hubs.view(torch.int32), plain_hubs.view(torch.int32)),
                  f"dsss_spmv ({form}) != plain version on the scale-22 pass")
    del plain, plain_hubs
    b2_device = device_kernels(one_pass)
    b2_calls_device = device_kernels(hubs_by_calls, reps=3)
    # Least bytes of the pass: the operands once (src_idx, hub_inv, weights:
    # 4·E_pad each; block_base 4·blocks; the sub-shard tables), src_vals once
    # (4·n_pad) and the hub vectors out (4·S). Operations: a multiply and an
    # add per edge slot.
    e_pad_total = int(b2_staged.src_idx.shape[0])
    nb_total = int(b2_staged.block_base.shape[0])
    S = int(b2_staged.out_offsets[-1])
    tables = sum(t.numel() * 4 for t in b2_staged.tables.values())
    b2_bytes = 12 * e_pad_total + 4 * nb_total + tables + 4 * g.n_pad + 4 * S
    b2_ops = 2 * e_pad_total
    b2_bound_ms = 1e3 * max(b2_bytes / H100_BYTES_PER_S, b2_ops / H100_FP32_PER_S)
    b2_bound_by = "bytes" if b2_bytes / H100_BYTES_PER_S >= b2_ops / H100_FP32_PER_S else "operations"
    slots = torch.from_numpy(g.global_hub_slots()).to(dev)
    hcrow = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    hcrow[1:] = torch.cumsum(torch.bincount(slots, minlength=S), 0)
    hcol = torch.from_numpy(g.src.astype(np.int64)).to(dev)
    hub_mat = torch.sparse_csr_tensor(
        hcrow, hcol, torch.ones(g.m, dtype=torch.float32, device=dev), (S, g.n_pad)
    )
    cvec = contrib[:, None]
    b2_library_ms = cuda_ms(lambda: torch.sparse.mm(hub_mat, cvec), reps=20)
    emit(
        "dsss_spmv_timing", kernel_ms=b2_ms, kernel_wall_ms=b2_wall_ms,
        calls_ms=b2_calls_ms, calls_wall_ms=b2_calls_wall_ms, plain_ms=b2_plain_ms,
        library_ms=b2_library_ms, bound_ms=b2_bound_ms, bound_by=b2_bound_by, min_bytes=b2_bytes,
        ops=b2_ops, calls=len(keys),
        blocks=nb_total, device_kernels=b2_device, calls_device_kernels=b2_calls_device,
        share_of_bound=b2_bound_ms / b2_ms, vs_library=b2_ms / b2_library_ms,
        hub_slots=S, nvidia_smi=smi,
    )
    del hub_mat, slots, hcol, hcrow

    # -- phase 8b: wcc and scc on the scale-22 edge list ----------------------
    del pb, sess, tiles, staged, b2_staged, host_blocks, attrs, acc, aux, contrib
    core.clear_session_cache()
    torch.cuda.empty_cache()
    ws_launches = wcc_scc(core, ps, dk, fa, el, g.P, smi)
    # -- phase 12: the 2-D partitioned PageRank on gloo ranks (ROADMAP A12) ---
    torch.cuda.empty_cache()
    dist_launches, dist_b2 = distributed(el, fused12, p12, smi, build_root)

    # -- phases 9-11: the LM serving path and kernel B3 -----------------------
    del g, el
    torch.cuda.empty_cache()
    b3_check = flash_attention_vs_plain(dev)
    lm_cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas")
    b3 = lm_serving(dev, smi, lm_cfg)
    torch.cuda.empty_cache()
    lm_serving_f32(dev, dataclasses.replace(lm_cfg, dtype="float32"))
    # -- phase 13: the MoE, Mamba and RG-LRU families (ROADMAP A13 item 1) ----
    torch.cuda.empty_cache()
    fam_launches, fam_b3 = lm_families(dev, smi)
    # -- phase 14: whisper and internvl2 (ROADMAP A13 item 2) -----------------
    torch.cuda.empty_cache()
    encdec_launches, encdec_b3 = lm_encdec(dev, smi)
    # -- phase 15: training with float32 master weights (A13 item 3) ---------
    torch.cuda.empty_cache()
    training(dev, smi)
    # -- phase 16: the FSDP training profile on a mesh (A13 item 4) ----------
    torch.cuda.empty_cache()
    fsdp_launches, fsdp_b3 = fsdp_training(smi)

    print(json.dumps({"kernels": [{
        "name": "packed_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/packed_sweep.cu",
        "replaces": "src/repro/kernels/packed_sweep.py:86",
        "launches": (main_launches + driver_launches + ws_launches + host_launches + disk_launches
                     + rel_launches + gs_launches),
        "launches_by_path": {"main_path": main_launches, "packed_scan_path": 0,
                             "drivers": driver_launches, "wcc_scc": ws_launches,
                             "host_path": host_launches, "disk_path": disk_launches,
                             "reliability": rel_launches, "graph_serving": gs_launches},
        "host_path": host_b1,
        "disk_path": disk_b1,
        "reliability": rel_b1,
        "graph_serving": gs_b1,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": b1_bound_by,
        "library_ms": library_ms,
    }, {
        "name": "dsss_spmv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dsss_spmv.cu",
        "replaces": "src/repro/kernels/dsss_spmv.py:70",
        "launches": pass_launches + dist_launches,
        "launches_by_path": {"subshard_kernel_path": pass_launches, "distributed": dist_launches},
        "distributed": dist_b2,
        "max_abs_err": b2_max_abs_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_bound_by,
        "library_ms": b2_library_ms,
        "calls_ms": b2_calls_ms,
        "calls_launches": sub_launches,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": b3["launches"] + fam_launches + encdec_launches + fsdp_launches,
        "launches_by_path": {"lm_serving": b3["launches"], "lm_families": fam_launches,
                             "lm_encdec": encdec_launches, "fsdp": fsdp_launches},
        "lm_families": fam_b3,
        "lm_encdec": encdec_b3,
        "fsdp": fsdp_b3,
        "max_abs_err": b3_check["max_abs_err"],
        "ms": b3["ms"],
        "plain_ms": b3["plain_ms"],
        "bound_ms": b3["bound_ms"],
        "bound_by": b3["bound_by"],
        "library_ms": b3["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
