// The fused tile sweep of one NXgraph update, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/packed_sweep.py::_kernel, the Pallas TPU kernel
// that packed_sweep_update launches on grid (K queries, NT tiles).
//
// What it computes, per query k and per (selected) tile: gather attrs[k, src]
// and the aux leaves by src (and dst), apply the program's gather with the
// edge weights, mask edges of inactive source intervals to reduce_identity,
// reduce each run (one run_local slot) in ascending edge order starting from
// segment_fill_value, and fold the run partials into acc[k, run_dst] in
// ascending run order. The result equals the plain PyTorch version
// (packed_sweep.py::packed_sweep_update_ref) bit for bit.
//
// Why not the TPU design: the TPU grid runs in order and carries acc in VMEM
// across tiles; the sum path there is a (T,)-wide select per edge and the
// min/max path an O(T^2) masked compare. Blocks on Hopper run in no order, and
// tiles are large (T is at least the longest run, 2^15 and more on R-MAT
// graphs), so neither carries over. Here there are two phases and no atomics:
//
//   phase 1  one thread per (query, run) folds the run's edges in edge order
//            into a (K, R) scratch of run partials. Runs longer than long_min
//            edges go to a warp instead: the lanes gather 32 edges at a time
//            and every lane folds the 32 values in lane order from shuffles,
//            so the order of the adds is still the edge order.
//   phase 2  one thread per (query, destination) folds acc[k, d] with its
//            runs, read from a destination -> runs CSR built once on the host
//            in ascending run order (= ascending source interval). Runs of
//            tiles the selection left out are skipped.
//
// What bounds it on the H100: bytes. Each edge costs a random 4-byte gather of
// attrs (and of each aux leaf the program reads) plus its streamed leaves
// (src, and dst/weights where read); each run its span, each destination its
// CSR entries. Nothing is reused enough to be bound by arithmetic. This first
// design keeps the gathers independent across threads so many are in flight;
// tiling the gathers through shared memory (TMA) is left for later work.
//
// Layouts whose runs are not contiguous (subshard tiles of a src_sorted graph)
// come with perm, the valid flat edge positions stably sorted by run: run r's
// edges are then perm[run_start[r] .. run_end[r]), still in ascending edge
// order, and phase 1 reads edge perm[i] where it would read edge i. perm is
// null for destination-sorted layouts, which read edge i as before.
//
// Exactness: the build uses --fmad=false and the float operations are written
// as __fmul_rn/__fadd_rn, so v*inv*w is two rounded products and never an FMA.
// Masked edges fold as the identity, exactly as in the plain version.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kInfDepth = 1 << 30;  // INF_DEPTH of repro_torch.core.identities
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;

enum Reduce { kSum, kMin, kMax };

// The aux leaves of one query (already offset by k * aux_stride) and the
// edge weights (nullptr when the graph has none).
struct EdgeCtx {
  const void* aux0;
  const void* aux1;
  const float* w;
  const int* dst;
};

struct PageRankOp {
  typedef float T;
  static constexpr Reduce kReduce = kSum;
  __device__ static T ident() { return 0.0f; }
  __device__ static T fill() { return 0.0f; }
  __device__ static T gather(T v, int s, int e, const EdgeCtx& c) {
    T x = __fmul_rn(v, static_cast<const float*>(c.aux0)[s]);
    if (c.w != nullptr) x = __fmul_rn(x, c.w[e]);
    return x;
  }
};

struct BFSOp {
  typedef int T;
  static constexpr Reduce kReduce = kMin;
  __device__ static T ident() { return kInfDepth; }
  __device__ static T fill() { return INT_MAX; }
  __device__ static T gather(T v, int, int, const EdgeCtx&) {
    return v >= kInfDepth ? kInfDepth : v + 1;
  }
};

struct WCCOp {
  typedef int T;
  static constexpr Reduce kReduce = kMin;
  __device__ static T ident() { return kInfDepth; }
  __device__ static T fill() { return INT_MAX; }
  __device__ static T gather(T v, int, int, const EdgeCtx&) { return v; }
};

struct SSSPOp {
  typedef float T;
  static constexpr Reduce kReduce = kMin;
  __device__ static T ident() { return INFINITY; }
  __device__ static T fill() { return INFINITY; }
  __device__ static T gather(T v, int, int e, const EdgeCtx& c) {
    return __fadd_rn(v, c.w != nullptr ? c.w[e] : 1.0f);
  }
};

struct MaxLabelForwardOp {
  typedef int T;
  static constexpr Reduce kReduce = kMax;
  __device__ static T ident() { return -kInfDepth; }
  __device__ static T fill() { return INT_MIN; }
  __device__ static T gather(T v, int s, int, const EdgeCtx& c) {
    return static_cast<const int*>(c.aux0)[s] > 0 ? v : -kInfDepth;
  }
};

struct ReachBackwardOp {
  typedef int T;
  static constexpr Reduce kReduce = kMax;
  __device__ static T ident() { return -kInfDepth; }
  __device__ static T fill() { return INT_MIN; }
  __device__ static T gather(T v, int s, int e, const EdgeCtx& c) {
    const int* mask = static_cast<const int*>(c.aux0);
    const int* color = static_cast<const int*>(c.aux1);
    return (mask[s] > 0 && v > 0 && color[s] == color[c.dst[e]]) ? 1 : 0;
  }
};

template <Reduce R>
__device__ __forceinline__ float combine(float a, float b) {
  if (R == kSum) return __fadd_rn(a, b);
  if (R == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

template <Reduce R>
__device__ __forceinline__ int combine(int a, int b) {
  if (R == kSum) return a + b;
  if (R == kMin) return min(a, b);
  return max(a, b);
}

struct Args {
  int K, n_pad, R, L, isz, long_min;
  long long aux_stride;
  const void* attrs;
  const void* acc;
  void* out;
  void* partial;
  const int* src;
  const int* dst;
  const float* w;
  const int* run_start;
  const int* run_end;
  const int* run_tile;
  const int* dst_ptr;
  const int* dst_runs;
  const int* long_runs;
  const int* perm;  // nullptr: runs are contiguous flat spans
  const unsigned char* tile_sel;  // nullptr: every tile selected
  const unsigned char* row_active;
  const void* aux0;
  const void* aux1;
};

__device__ __forceinline__ EdgeCtx edge_ctx(const Args& a, int k) {
  EdgeCtx c;
  c.aux0 = a.aux0 == nullptr
               ? nullptr
               : static_cast<const void*>(static_cast<const char*>(a.aux0) +
                                          4 * k * a.aux_stride);
  c.aux1 = a.aux1 == nullptr
               ? nullptr
               : static_cast<const void*>(static_cast<const char*>(a.aux1) +
                                          4 * k * a.aux_stride);
  c.w = a.w;
  c.dst = a.dst;
  return c;
}

template <class Op>
__device__ __forceinline__ typename Op::T edge_value(
    const Args& a, const typename Op::T* attrs, const EdgeCtx& c, int e) {
  int s = a.src[e];
  if (!a.row_active[s / a.isz]) return Op::ident();
  return Op::gather(attrs[s], s, e, c);
}

// Phase 1, short runs: one thread per (query, run).
template <class Op>
__global__ void __launch_bounds__(kThreads)
    run_partials_short(Args a) {
  typedef typename Op::T T;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int k = blockIdx.y;
  if (r >= a.R) return;
  int b = a.run_start[r], end = a.run_end[r];
  if (end - b > a.long_min) return;  // folded by run_partials_long
  if (a.tile_sel != nullptr && !a.tile_sel[a.run_tile[r]]) return;
  const T* attrs = static_cast<const T*>(a.attrs) + (size_t)k * a.n_pad;
  EdgeCtx c = edge_ctx(a, k);
  T p = Op::fill();
  for (int i = b; i < end; ++i) {
    const int e = a.perm != nullptr ? a.perm[i] : i;
    p = combine<Op::kReduce>(p, edge_value<Op>(a, attrs, c, e));
  }
  static_cast<T*>(a.partial)[(size_t)k * a.R + r] = p;
}

// Phase 1, long runs: one warp per (query, run). Lanes gather 32 edges at a
// time; every lane then folds the 32 values in lane (= edge) order.
template <class Op>
__global__ void __launch_bounds__(kThreads)
    run_partials_long(Args a) {
  typedef typename Op::T T;
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x & 31;
  int k = blockIdx.y;
  if (warp >= a.L) return;  // uniform across the warp
  int r = a.long_runs[warp];
  if (a.tile_sel != nullptr && !a.tile_sel[a.run_tile[r]]) return;
  int b = a.run_start[r], end = a.run_end[r];
  const T* attrs = static_cast<const T*>(a.attrs) + (size_t)k * a.n_pad;
  EdgeCtx c = edge_ctx(a, k);
  T p = Op::fill();
  for (int base = b; base < end; base += 32) {
    int i = base + lane;
    T x = Op::ident();
    if (i < end) x = edge_value<Op>(a, attrs, c, a.perm != nullptr ? a.perm[i] : i);
    int n = min(32, end - base);
    for (int j = 0; j < n; ++j) p = combine<Op::kReduce>(p, __shfl_sync(kFullMask, x, j));
  }
  if (lane == 0) static_cast<T*>(a.partial)[(size_t)k * a.R + r] = p;
}

// Phase 2: one thread per (query, destination), runs in ascending order.
template <class Op>
__global__ void __launch_bounds__(kThreads)
    fold_runs(Args a) {
  typedef typename Op::T T;
  int d = blockIdx.x * blockDim.x + threadIdx.x;
  int k = blockIdx.y;
  if (d >= a.n_pad) return;
  size_t row = (size_t)k * a.n_pad;
  const T* partial = static_cast<const T*>(a.partial) + (size_t)k * a.R;
  T v = static_cast<const T*>(a.acc)[row + d];
  for (int q = a.dst_ptr[d]; q < a.dst_ptr[d + 1]; ++q) {
    int r = a.dst_runs[q];
    if (a.tile_sel != nullptr && !a.tile_sel[a.run_tile[r]]) continue;
    v = combine<Op::kReduce>(v, partial[r]);
  }
  static_cast<T*>(a.out)[row + d] = v;
}

template <class Op>
int launch(const Args& a, cudaStream_t stream) {
  if (a.R > 0) {
    dim3 grid((a.R + kThreads - 1) / kThreads, a.K);
    run_partials_short<Op><<<grid, kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.L > 0) {
    long long threads = 32LL * a.L;
    dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads), a.K);
    run_partials_long<Op><<<grid, kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((a.n_pad + kThreads - 1) / kThreads, a.K);
  fold_runs<Op><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes (repro_torch/kernels/packed_sweep.py).
// Returns cudaGetLastError() of the launches: 0 on success.
extern "C" int packed_sweep_launch(
    int prog, int K, int n_pad, int R, int L, int isz, int long_min,
    long long aux_stride, const void* attrs, const void* acc, void* out,
    void* partial, const int* src, const int* dst, const float* w,
    const int* run_start, const int* run_end, const int* run_tile,
    const int* dst_ptr, const int* dst_runs, const int* long_runs,
    const int* perm, const unsigned char* tile_sel, const unsigned char* row_active,
    const void* aux0, const void* aux1, void* stream) {
  Args a;
  a.K = K;
  a.n_pad = n_pad;
  a.R = R;
  a.L = L;
  a.isz = isz;
  a.long_min = long_min;
  a.aux_stride = aux_stride;
  a.attrs = attrs;
  a.acc = acc;
  a.out = out;
  a.partial = partial;
  a.src = src;
  a.dst = dst;
  a.w = w;
  a.run_start = run_start;
  a.run_end = run_end;
  a.run_tile = run_tile;
  a.dst_ptr = dst_ptr;
  a.dst_runs = dst_runs;
  a.long_runs = long_runs;
  a.perm = perm;
  a.tile_sel = tile_sel;
  a.row_active = row_active;
  a.aux0 = aux0;
  a.aux1 = aux1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prog) {
    case 0: return launch<PageRankOp>(a, s);
    case 1: return launch<BFSOp>(a, s);
    case 2: return launch<WCCOp>(a, s);
    case 3: return launch<SSSPOp>(a, s);
    case 4: return launch<MaxLabelForwardOp>(a, s);
    case 5: return launch<ReachBackwardOp>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
