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
//          Entries no edge reaches hold padding_identity.
// phase 2  out[s] = fold, in ascending b, of partials[b, s - block_base[b]]
//          over the blocks whose window [base_b, base_b + W) covers s,
//          starting from segment_fill_value. Slots >= num_slots are dropped.
//
// The plain PyTorch version (dsss_spmv.py::subshard_update_ref) folds in the
// same orders, so the two agree bit for bit.
//
// Why not the TPU design: the TPU sums a block's window as a one-hot
// (1, 512) x (512, 512) matmul on the MXU and min/max as a masked compare,
// O(E_BLK * W) work per block either way, and re-associates the sum. On
// Hopper the edges of a block are destination-sorted, so each hub slot's
// edges are one contiguous run: phase 1 gives each run to the thread that
// starts it, which folds the run from shared memory in edge order (O(E_BLK)
// per block, exact order). Phase 2 is one thread per hub slot; the blocks
// that cover a slot are a contiguous range of ascending block_base, found by
// binary search. A hub of 19 k edges spans about 40 blocks. No atomics, so a
// repeated launch gives the same bits.
//
// Input that is not destination-sorted (a src_sorted layout) still gets the
// same answer as the plain version, slowly: a block whose slots decrease
// somewhere is folded by one thread per window entry scanning the block, and
// when block_base decreases somewhere phase 2 scans every block for every
// slot. Phase 1 detects both: each thread block checks its own slots, and
// thread block 0 alone scans block_base (num_blocks ints) and writes the
// answer to `flag`, so the flag needs no zeroing before the launch.
//
// Types: float32 and bfloat16 values, weights and results. A bf16 sum
// accumulates in float32 inside a block and rounds once per partial, as the
// TPU kernel's preferred_element_type=f32 matmul does; the slot fold then
// adds in bf16 (rounding each step), as the reference's segment_sum does.
//
// What bounds it on the H100: bytes. Per edge 12 bytes of operands
// (src_idx, hub_inv, w) and a 4-byte random gather from src_vals, which is
// one source interval and mostly stays in L2; per hub slot one write. The
// (num_blocks, 512) partials make a round trip through device memory between
// the phases; fusing the fold into phase 1 for slots whose window range is a
// single block is left for later work.
//
// Exactness: --fmad=false, and every float operation is __fmul_rn/__fadd_rn.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kEBlk = 512;  // edges per block = width W of the slot window
constexpr int kThreads = 256;

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

struct Args {
  int isize, num_blocks, num_slots;
  const void* src_vals;
  const int* src_idx;
  const int* hub_inv;
  const void* w;
  const int* block_base;
  void* partials;
  void* out;
  int* flag;  // 1 when block_base decreases somewhere, else 0; nullptr without phase 2
};

// Phase 1: one thread block of 512 threads per 512-edge block.
template <typename T, int G, int R>
__global__ void __launch_bounds__(kEBlk) block_partials(Args a) {
  __shared__ int s_slot[kEBlk];
  __shared__ float s_val[kEBlk];
  __shared__ float s_part[kEBlk];
  __shared__ int s_unsorted;
  __shared__ int s_base_desc;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t e = static_cast<size_t>(b) * kEBlk + t;
  const int base = a.block_base[b];
  if (t == 0) {
    s_unsorted = 0;
    s_base_desc = 0;
  }
  const int src = a.src_idx[e];
  const float v = (src >= 0 && src < a.isize)
                      ? to_f(static_cast<const T*>(a.src_vals)[src])
                      : __int_as_float(0x7fc00000);
  const float w = to_f(static_cast<const T*>(a.w)[e]);
  const float c = G == kMul ? __fmul_rn(v, w) : __fadd_rn(v, w);
  s_val[t] = to_f(from_f<T>(c));  // the contrib, rounded to T
  s_slot[t] = a.hub_inv[e] - base;
  s_part[t] = ident<R>();
  __syncthreads();
  if (t > 0 && s_slot[t] < s_slot[t - 1]) s_unsorted = 1;
  const bool tells_phase2 = b == 0 && a.flag != nullptr;
  if (tells_phase2) {
    for (int k = t + 1; k < a.num_blocks; k += kEBlk) {
      if (a.block_base[k] < a.block_base[k - 1]) s_base_desc = 1;
    }
  }
  __syncthreads();
  if (tells_phase2 && t == 0) *a.flag = s_base_desc;
  if (!s_unsorted) {
    // Each slot's edges are one run; the thread at its start folds it.
    const int slot = s_slot[t];
    if (slot >= 0 && slot < kEBlk && (t == 0 || s_slot[t - 1] != slot)) {
      float p = ident<R>();
      for (int k = t; k < kEBlk && s_slot[k] == slot; ++k) p = combine<R>(p, s_val[k]);
      s_part[slot] = p;
    }
  } else {
    // Slots out of order: window entry t scans the whole block in order.
    float p = ident<R>();
    for (int k = 0; k < kEBlk; ++k) {
      if (s_slot[k] == t) p = combine<R>(p, s_val[k]);
    }
    s_part[t] = p;
  }
  __syncthreads();
  static_cast<T*>(a.partials)[e] = from_f<T>(s_part[t]);
}

// First index in [0, n) whose value is greater than x (n if none).
__device__ __forceinline__ int first_above(const int* v, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (v[mid] > x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Phase 2: one thread per hub slot, covering blocks in ascending order.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) slot_fold(Args a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.num_slots) return;
  int lo = 0, hi = a.num_blocks;
  if (*a.flag == 0) {  // block_base ascending: the covering blocks are a range
    lo = first_above(a.block_base, a.num_blocks, static_cast<long long>(s) - kEBlk);
    hi = first_above(a.block_base, a.num_blocks, s);
  }
  const T* partials = static_cast<const T*>(a.partials);
  float v = ident<R>();
  for (int b = lo; b < hi; ++b) {
    const long long off = static_cast<long long>(s) - a.block_base[b];
    if (off < 0 || off >= kEBlk) continue;
    const float p = to_f(partials[static_cast<size_t>(b) * kEBlk + off]);
    v = to_f(from_f<T>(combine<R>(v, p)));  // each step rounded to T
  }
  static_cast<T*>(a.out)[s] = from_f<T>(v);
}

template <typename T, int G, int R>
int launch(const Args& a, cudaStream_t stream) {
  block_partials<T, G, R><<<a.num_blocks, kEBlk, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.num_slots <= 0) return static_cast<int>(err);
  slot_fold<T, R><<<(a.num_slots + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int gather_op, int reduce, const Args& a, cudaStream_t s) {
  const int key = gather_op * 3 + reduce;
  switch (key) {
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

// C entry point, bound with ctypes (repro_torch/kernels/dsss_spmv.py).
// dtype 0 = float32, 1 = bfloat16; gather_op 0 = mul, 1 = add; reduce
// 0 = sum, 1 = min, 2 = max. num_slots < 0 runs phase 1 only (out and flag
// unused); otherwise flag points at one int of scratch that phase 1 writes
// and phase 2 reads. Returns
// cudaGetLastError() of the launches: 0 on success.
extern "C" int dsss_spmv_launch(
    int dtype, int gather_op, int reduce, int isize, int num_blocks,
    int num_slots, const void* src_vals, const int* src_idx,
    const int* hub_inv, const void* w, const int* block_base,
    void* partials, void* out, int* flag, void* stream) {
  if (num_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.isize = isize;
  a.num_blocks = num_blocks;
  a.num_slots = num_slots;
  a.src_vals = src_vals;
  a.src_idx = src_idx;
  a.hub_inv = hub_inv;
  a.w = w;
  a.block_base = block_base;
  a.partials = partials;
  a.out = out;
  a.flag = num_slots < 0 ? nullptr : flag;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(gather_op, reduce, a, s);
    case 1: return dispatch<__nv_bfloat16>(gather_op, reduce, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
