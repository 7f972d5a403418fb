// The sub-shard ToHub update of NXgraph (paper Alg. 6 line 4), hand-written
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dsss_spmv.py::_kernel, the Pallas TPU kernel
// that dsss_spmv_block_partials launches on a grid of 512-edge blocks, and
// the slot fold of src/repro/kernels/ops.py::_subshard_update_jit.
//
// What it computes. The edge stream of one sub-shard (or one packed tile) is
// cut into blocks of E_BLK = 512 edges. For edge e of block b:
//
//   contrib[e] = src_vals[src_idx[e]] (*|+) w[e]        rounded to the dtype
//   slot       = hub_inv[e] - block_base[b]               in [0, W) or dropped
//
// phase 1  partials[b, s] = fold, in edge order, of the contribs of block b's
//          edges with slot s, starting from padding_identity (0, +inf, -inf).
// phase 2  out[s] = fold, in ascending b, of partials[b, s - block_base[b]]
//          over the blocks whose window [base_b, base_b + W) covers s,
//          starting from segment_fill_value. Slots >= num_slots are dropped.
//
// The plain PyTorch version (dsss_spmv.py::subshard_update_ref) folds in the
// same orders, so the two agree bit for bit. A source index outside the
// interval gives a NaN contrib (jnp.take's fill gives NaN in the TPU kernel
// too, whose one-hot product then spreads it over the block's window; a fold
// here poisons only its own slot under a sum and drops it under min/max).
//
// One launch serves a whole pass: the edge arrays of many sub-shards are
// concatenated, and per sub-shard a table holds its first block, the offset
// and size of its source interval in src_vals, its num_slots, the offset of
// its hub vector in out, and two flags: its slots decrease somewhere in its
// stream, and its block_base decreases somewhere. A single sub-shard is a
// pass of one: `stage_one` writes its table and `classify` its flags.
//
// Why not the TPU design: the TPU sums a block's window as a one-hot
// (1, 512) x (512, 512) matmul on the MXU and min/max as a masked compare,
// O(E_BLK * W) work per block, and re-associates the sum. Here a block is
// one warp, 16 edges a lane, so many blocks are in flight on an SM; on a
// destination-sorted stream each hub slot's edges are one run, and the lane
// that holds a run's first edge folds the run in edge order from shared
// memory. Run ends come from a warp suffix-min of the lanes' first run
// starts, so a fold is a counted loop whose loads pipeline.
//
// The (num_blocks, W) partials never reach device memory on that path. A
// block that holds none of a slot's edges contributes the identity to it,
// and folding the identity changes no bits (x + 0.0 is x for every x the
// fold can hold, since it starts from +0.0 and never makes -0.0; a compare
// keeps acc against +-inf; NaN stays NaN). So a slot whose edges lie in one
// block is written from phase 1 as fill (+) partial, slots no edge reaches
// get fill, and only a slot whose run crosses into the next block leaves its
// two end partials in head/tail: phase 2 walks those few runs across their
// blocks in ascending order. Because the stream is sorted, a run can be
// shared only through a block's first or last edge.
//
// A sub-shard whose slots decrease somewhere (a src_sorted layout) takes the
// general path, slowly: phase 1 writes the block's full window of partials
// (each lane owns 32-strided window entries and scans the block's edges in
// order through warp shuffles), and phase 2 folds one slot a thread over the
// covering blocks of its sub-shard, found by binary search, or by a scan of
// every block where block_base decreases. No atomics anywhere, so a repeated
// launch gives the same bits.
//
// Types: float32 and bfloat16 values, weights and results. A bf16 sum
// accumulates in float32 inside a block and rounds once per partial, as the
// TPU kernel's preferred_element_type=f32 matmul does; the slot fold then
// rounds each step to bf16, as the reference's segment_sum does.
//
// What bounds it on the H100: bytes. Per edge 12 bytes of operands
// (src_idx, hub_inv, w), loaded 16 bytes a load, and a 4-byte random gather
// from src_vals, which is one source interval and mostly stays in L2; per
// hub slot one write.
//
// Exactness: --fmad=false, and every float operation is __fmul_rn/__fadd_rn.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kEBlk = 512;                   // edges per block = window width W
constexpr int kLanes = 32;
constexpr int kPerLane = kEBlk / kLanes;     // 16 edges a lane
constexpr int kPad = kEBlk + kEBlk / kPerLane;  // one pad word per 16: no bank conflicts
constexpr int kWarps = 8;                    // edge blocks per thread block (phase 1)
constexpr int kThreads = 256;                // phase 2 and classify
constexpr unsigned kFull = 0xffffffffu;

enum Gather { kMul, kAdd };
enum Reduce { kSum, kMin, kMax };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// padding_identity and segment_fill_value agree for float types.
template <int R>
__device__ __forceinline__ float ident() {
  return R == kSum ? 0.0f : (R == kMin ? INFINITY : -INFINITY);
}

template <int R>
__device__ __forceinline__ float combine(float acc, float x) {
  if (R == kSum) return __fadd_rn(acc, x);
  if (R == kMin) return x < acc ? x : acc;
  return x > acc ? x : acc;
}

// One step of the slot fold: combine, then round to T.
template <typename T, int R>
__device__ __forceinline__ float fold_step(float v, T p) {
  return to_f(from_f<T>(combine<R>(v, to_f(p))));
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

__device__ __forceinline__ bool in_window(int hub, int base) {
  const long long d = static_cast<long long>(hub) - base;
  return d >= 0 && d < kEBlk;
}

struct Args {
  int num_ss, num_blocks;
  int partials_only;       // phase 1 writes every block's window of partials
  const int* first_block;  // (num_ss + 1,)
  const int* meta;         // (num_ss, 4): src_off, isize, num_slots, out_off
  const int* flags;        // (2, num_ss): slots decrease; block_base decreases
  const int* gen_ss;       // (num_gen,) the sub-shards that may take the general path
  const int* gen_start;    // (num_gen + 1,) their slot offsets among phase 2's items
  int num_gen, gen_slots;
  const void* src_vals;
  const int* src_idx;
  const int* hub_inv;
  const void* w;
  const int* block_base;
  void* partials;  // (num_blocks, W): general path and partials_only
  void* head;      // (num_blocks,): partial of a block's first run, when shared
  void* tail;      // (num_blocks,): partial of a block's last run, when shared
  void* out;
};

struct SubShard {
  int first, end, src_off, isize, num_slots, out_off;
};

__device__ __forceinline__ SubShard sub_shard(const Args& a, int k) {
  SubShard s;
  s.first = a.first_block[k];
  s.end = a.first_block[k + 1];
  s.src_off = a.meta[4 * k];
  s.isize = a.meta[4 * k + 1];
  s.num_slots = a.meta[4 * k + 2];
  s.out_off = a.meta[4 * k + 3];
  return s;
}

// Last index in [0, n) whose value is <= x (v ascending, v[0] <= x).
__device__ __forceinline__ int last_at_most(const int* v, int n, int x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (v[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int sub_shard_of_block(const Args& a, int b) {
  return last_at_most(a.first_block, a.num_ss, b);
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&v)[kPerLane]);

template <>
__device__ __forceinline__ void load16<int>(const int* p, int (&v)[kPerLane]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int i = 0; i < kPerLane / 4; ++i) {
    const int4 x = q[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void load_weights(const float* p, float (&v)[kPerLane]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kPerLane / 4; ++i) {
    const float4 x = q[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void load_weights(const __nv_bfloat16* p, float (&v)[kPerLane]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kPerLane / 8; ++i) {
    const uint4 x = q[i];
    const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
}

// General path, phase 1: block b's whole window of partials. Lane l owns the
// window entries l, l + 32, ...; all lanes walk the block's edges in order
// (values through shuffles), and the owner of an edge's entry folds it.
template <typename T, int R>
__device__ void window_partials(const Args& a, int b, int base, int lane,
                                const int (&hub)[kPerLane], const float (&val)[kPerLane]) {
  float acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = ident<R>();
  for (int from = 0; from < kLanes; ++from) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int h = __shfl_sync(kFull, hub[j], from);
      const float x = __shfl_sync(kFull, val[j], from);
      const long long t = static_cast<long long>(h) - base;
      if (t >= 0 && t < kEBlk && (t & (kLanes - 1)) == lane) {
        acc[t >> 5] = combine<R>(acc[t >> 5], x);
      }
    }
  }
  T* part = static_cast<T*>(a.partials) + static_cast<size_t>(b) * kEBlk;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) part[lane + kLanes * j] = from_f<T>(acc[j]);
}

// Phase 1: one warp per 512-edge block, kWarps blocks per thread block.
template <typename T, int G, int R>
__global__ void __launch_bounds__(kWarps * kLanes) block_partials(Args a) {
  __shared__ float s_val[kWarps][kPad];
  __shared__ int s_hub[kWarps][kPad];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.num_blocks) return;  // the whole warp
  const int k = sub_shard_of_block(a, b);
  const SubShard ss = sub_shard(a, k);
  const int base = a.block_base[b];
  const size_t e0 = static_cast<size_t>(b) * kEBlk + lane * kPerLane;

  float val[kPerLane];
  {
    int src[kPerLane];
    float w[kPerLane];
    load16<int>(a.src_idx + e0, src);
    load_weights(static_cast<const T*>(a.w) + e0, w);
    const T* sv = static_cast<const T*>(a.src_vals) + ss.src_off;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = src[j];
      const float v = (s >= 0 && s < ss.isize) ? to_f(sv[s]) : __int_as_float(0x7fc00000);
      const float c = G == kMul ? __fmul_rn(v, w[j]) : __fadd_rn(v, w[j]);
      val[j] = to_f(from_f<T>(c));  // the contrib, rounded to T
    }
  }
  int hub[kPerLane];
  load16<int>(a.hub_inv + e0, hub);
  if (a.partials_only || a.flags[k] != 0) {
    window_partials<T, R>(a, b, base, lane, hub, val);
    return;
  }

  // Fast path: the sub-shard's slots never decrease.
  float* sval = s_val[warp];
  int* shub = s_hub[warp];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    sval[pad(lane * kPerLane + j)] = val[j];
    shub[pad(lane * kPerLane + j)] = hub[j];
  }
  const int up = __shfl_up_sync(kFull, hub[kPerLane - 1], 1);
  unsigned starts = 0;  // bit j: edge lane * 16 + j starts a run in this block
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const bool st = j > 0 ? hub[j] != hub[j - 1] : (lane == 0 || hub[0] != up);
    starts |= static_cast<unsigned>(st) << j;
  }
  // The next run start after this lane's edges: a suffix min over lanes.
  int m = starts ? lane * kPerLane + __ffs(starts) - 1 : kEBlk;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const int y = __shfl_down_sync(kFull, m, off);
    if (lane + off < kLanes) m = min(m, y);
  }
  int end = __shfl_down_sync(kFull, m, 1);
  if (lane == kLanes - 1) end = kEBlk;
  __syncwarp();

  const bool has_prev = b > ss.first;
  const bool has_next = b + 1 < ss.end;
  const int prev_last = has_prev ? a.hub_inv[static_cast<size_t>(b) * kEBlk - 1] : 0;
  const int next_first = has_next ? a.hub_inv[static_cast<size_t>(b + 1) * kEBlk] : 0;
  T* out = static_cast<T*>(a.out) + ss.out_off;
  const T fill = from_f<T>(ident<R>());
  while (starts) {
    const int j = 31 - __clz(starts);
    starts &= ~(1u << j);
    const int p = lane * kPerLane + j;
    const int h = shub[pad(p)];
    float acc = ident<R>();
#pragma unroll 4
    for (int i = p; i < end; ++i) acc = combine<R>(acc, sval[pad(i)]);
    const T part = from_f<T>(acc);
    const bool prev_shared = p == 0 && has_prev && prev_last == h;
    const bool next_shared = end == kEBlk && has_next && next_first == h;
    if (prev_shared) static_cast<T*>(a.head)[b] = part;
    if (next_shared) static_cast<T*>(a.tail)[b] = part;
    if (!prev_shared && !next_shared && h >= 0 && h < ss.num_slots) {
      out[h] = in_window(h, base) ? from_f<T>(combine<R>(ident<R>(), to_f(part))) : fill;
    }
    // Slots no edge reaches: between the previous edge's slot and h, and
    // after the sub-shard's last slot.
    long long lo = p > 0 ? shub[pad(p - 1)] + 1LL : (has_prev ? prev_last + 1LL : 0LL);
    for (long long s = lo < 0 ? 0 : lo; s < h && s < ss.num_slots; ++s) out[s] = fill;
    if (end == kEBlk && !has_next) {
      for (long long s = h < 0 ? 0 : h + 1LL; s < ss.num_slots; ++s) out[s] = fill;
    }
    end = p;
  }
}

// First index in [0, n) whose value is greater than x (n if none).
__device__ __forceinline__ int first_above(const int* v, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] > x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Phase 2. Items [0, num_blocks): block b starts the walk of a run that
// crosses into the next block (sorted sub-shards). Items past that: one hub
// slot of a flagged sub-shard each, folded over its covering blocks.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) slot_fold(Args a) {
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item < a.num_blocks) {
    const int b = static_cast<int>(item);
    const int k = sub_shard_of_block(a, b);
    if (a.flags[k] != 0) return;
    const SubShard ss = sub_shard(a, k);
    if (b + 1 >= ss.end) return;
    const size_t e = static_cast<size_t>(b) * kEBlk;
    const int h = a.hub_inv[e + kEBlk - 1];
    if (a.hub_inv[e + kEBlk] != h) return;  // the last run ends in b
    if (b > ss.first && a.hub_inv[e - 1] == h) return;  // it began in an earlier block
    float v = ident<R>();
    if (in_window(h, a.block_base[b])) v = fold_step<T, R>(v, static_cast<const T*>(a.tail)[b]);
    for (int c = b + 1; c < ss.end; ++c) {
      const size_t ec = static_cast<size_t>(c) * kEBlk;
      if (a.hub_inv[ec] != h) break;
      if (in_window(h, a.block_base[c])) v = fold_step<T, R>(v, static_cast<const T*>(a.head)[c]);
      if (a.hub_inv[ec + kEBlk - 1] != h) break;
    }
    if (h >= 0 && h < ss.num_slots) static_cast<T*>(a.out)[ss.out_off + h] = from_f<T>(v);
    return;
  }
  const long long g = item - a.num_blocks;
  if (g >= a.gen_slots) return;
  const int q = last_at_most(a.gen_start, a.num_gen, static_cast<int>(g));
  const int k = a.gen_ss[q];
  const int s = static_cast<int>(g) - a.gen_start[q];
  if (a.flags[k] == 0) return;  // a single sub-shard, staged before its flags were known
  const SubShard ss = sub_shard(a, k);
  const int nb = ss.end - ss.first;
  const int* base = a.block_base + ss.first;
  int lo = 0, hi = nb;
  if (a.flags[a.num_ss + k] == 0) {  // block_base ascending: the covering blocks are a range
    lo = first_above(base, nb, static_cast<long long>(s) - kEBlk);
    hi = first_above(base, nb, s);
  }
  const T* partials = static_cast<const T*>(a.partials) + static_cast<size_t>(ss.first) * kEBlk;
  float v = ident<R>();
  for (int c = lo; c < hi; ++c) {
    const long long off = static_cast<long long>(s) - base[c];
    if (off < 0 || off >= kEBlk) continue;
    v = fold_step<T, R>(v, partials[static_cast<size_t>(c) * kEBlk + off]);
  }
  static_cast<T*>(a.out)[ss.out_off + s] = from_f<T>(v);
}

// A single sub-shard's table: first_block {0, num_blocks}, meta {0, isize,
// num_slots, 0}, flags {0, 0}, gen_ss {0}, gen_start {0, num_slots}. Its
// flags are not known yet, so phase 2 is given every slot as a general item
// and skips them if `classify` finds the sub-shard sorted.
constexpr int kOneTable = 11;

__global__ void stage_one(int num_blocks, int isize, int num_slots, int* t) {
  const int v[kOneTable] = {0, num_blocks, 0, isize, num_slots, 0, 0, 0, 0, 0, num_slots};
#pragma unroll
  for (int i = 0; i < kOneTable; ++i) t[i] = v[i];
}

// A single sub-shard's flags: its slots decrease somewhere; its block_base
// decreases somewhere. flags holds 0s before the launch; threads that find a
// decrease store 1 (the same value, so the order of the stores is moot).
__global__ void __launch_bounds__(kThreads)
    classify(const int* hub_inv, const int* block_base, long long e_pad, int num_blocks,
             int* flags) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i > 0 && i < e_pad && hub_inv[i] < hub_inv[i - 1]) flags[0] = 1;
  if (i > 0 && i < num_blocks && block_base[i] < block_base[i - 1]) flags[1] = 1;
}

template <typename T, int G, int R>
int launch(const Args& a, cudaStream_t stream) {
  const int grid1 = (a.num_blocks + kWarps - 1) / kWarps;
  block_partials<T, G, R><<<grid1, kWarps * kLanes, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.partials_only) return static_cast<int>(err);
  const long long items = static_cast<long long>(a.num_blocks) + a.gen_slots;
  const long long grid2 = (items + kThreads - 1) / kThreads;
  slot_fold<T, R><<<static_cast<unsigned>(grid2), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int gather_op, int reduce, const Args& a, cudaStream_t s) {
  switch (gather_op * 3 + reduce) {
    case kMul * 3 + kSum: return launch<T, kMul, kSum>(a, s);
    case kMul * 3 + kMin: return launch<T, kMul, kMin>(a, s);
    case kMul * 3 + kMax: return launch<T, kMul, kMax>(a, s);
    case kAdd * 3 + kSum: return launch<T, kAdd, kSum>(a, s);
    case kAdd * 3 + kMin: return launch<T, kAdd, kMin>(a, s);
    case kAdd * 3 + kMax: return launch<T, kAdd, kMax>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes (repro_torch/kernels/dsss_spmv.py).
// dtype 0 = float32, 1 = bfloat16; gather_op 0 = mul, 1 = add; reduce
// 0 = sum, 1 = min, 2 = max.
//
// dsss_spmv_launch runs a pass: first_block (num_ss + 1), meta (num_ss, 4)
// and flags (2, num_ss) describe the sub-shards; gen_ss/gen_start list the
// ones that may take the general path, whose gen_slots hub slots phase 2
// folds one a thread. partials_only runs phase 1 alone and writes every
// block's window to partials (out, head and tail unused).
//
// Every pointer to edge data (src_idx, hub_inv, w) is 16-byte aligned.
// Returns cudaGetLastError() of the launches: 0 on success.
extern "C" int dsss_spmv_launch(
    int dtype, int gather_op, int reduce, int num_ss, int num_blocks,
    int partials_only, int num_gen, int gen_slots,
    const int* first_block, const int* meta, const int* flags, const int* gen_ss,
    const int* gen_start, const void* src_vals, const int* src_idx,
    const int* hub_inv, const void* w, const int* block_base,
    void* partials, void* head, void* tail, void* out, void* stream) {
  if (num_blocks <= 0 || num_ss <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.num_ss = num_ss;
  a.num_blocks = num_blocks;
  a.partials_only = partials_only;
  a.first_block = first_block;
  a.meta = meta;
  a.flags = flags;
  a.gen_ss = gen_ss;
  a.gen_start = gen_start;
  a.num_gen = num_gen;
  a.gen_slots = gen_slots;
  a.src_vals = src_vals;
  a.src_idx = src_idx;
  a.hub_inv = hub_inv;
  a.w = w;
  a.block_base = block_base;
  a.partials = partials;
  a.head = head;
  a.tail = tail;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(gather_op, reduce, a, s);
    case 1: return dispatch<__nv_bfloat16>(gather_op, reduce, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dsss_spmv_stage_one stages one sub-shard of num_blocks blocks as a pass of
// one, on the stream, into table (kOneTable ints, laid out as stage_one
// says): dsss_spmv_launch then takes first_block = table, meta = table + 2,
// flags = table + 6, gen_ss = table + 8, gen_start = table + 9, num_ss = 1,
// num_gen = 1 and gen_slots = num_slots.
extern "C" int dsss_spmv_stage_one(int num_blocks, int isize, int num_slots,
                                   const int* hub_inv, const int* block_base,
                                   int* table, void* stream) {
  if (num_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stage_one<<<1, 1, 0, s>>>(num_blocks, isize, num_slots, table);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long e_pad = static_cast<long long>(num_blocks) * kEBlk;
  classify<<<static_cast<unsigned>((e_pad + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      hub_inv, block_base, e_pad, num_blocks, table + 6);
  return static_cast<int>(cudaGetLastError());
}
