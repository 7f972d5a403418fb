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
// tiles are large (2^15 edges and more on R-MAT graphs), so neither carries
// over. Here there are three launches and no atomics on values:
//
//   pre_gather    y[s, k] = the part of the gather that depends only on the
//                 source vertex s (PageRank v*inv[s], BFS v+1, MaxLabel's
//                 mask), for the vertices of active intervals, laid out
//                 vertex-major (n_pad, K): a K = 8 batch reads one 32-byte
//                 sector per edge, and each edge gathers one value per query
//                 instead of attrs and each aux leaf.
//   run_partials  one warp per chunk of the run index's chunk table, in one
//                 launch. A chunk is a run-aligned span of edge positions of
//                 one tile and one source interval, so activity and the tile
//                 selection are one check per chunk: an inactive chunk writes
//                 fill (+) ident for each of its runs and gathers nothing. A
//                 short chunk (runs packed greedily into at most kCap
//                 positions) loads its edges and run starts coalesced, gathers
//                 every edge's value into shared memory, and folds each run
//                 in edge order from there: the run starts are the head list,
//                 and the (run, query) folds go round robin over the lanes,
//                 so their partials are stored coalesced. A long chunk is one
//                 run of more than kCap edges: the warp walks it in windows of
//                 kCap positions and carries its running value from window to
//                 window, with later windows' loads in flight while it folds
//                 window t. The host puts long chunks first, longest first,
//                 so their chains overlap the rest.
//   fold_runs     one thread per destination folds acc[k, d] with its runs
//                 for every query k, read from a destination -> runs CSR built
//                 once on the host in ascending run order (= ascending source
//                 interval); a run's K partials are one row of the (R, K)
//                 scratch. Runs of tiles the selection left out are skipped.
//
// Host residency streams the layout in tile ranges (repro_torch.core.session,
// _packed_host_sweep), and the sweep is then split over entries of its own:
//
//   packed_sweep_pre_gather   pre_gather alone, once a sweep: y depends only
//                             on attrs and aux, never on the range.
//   packed_sweep_range_launch one tile range, self-contained: run_partials
//                             over its chunk rows (rebased to the range), then
//                             fold_touched, one thread per destination the
//                             range touches, folding its runs in ascending
//                             order into acc in place. A destination's runs in
//                             range c all precede its runs in range c+1, so
//                             folding the ranges in ascending order is
//                             fold_runs' left fold, and the bits are device
//                             residency's. A streamed sweep is one call per
//                             range: a whole-n_pad fold_runs per range would
//                             cost 68 us each at R-MAT scale 22, where ranges
//                             are one tile and there are 998 of them.
//
// No run is ever cut into partials that are combined later: a float sum is a
// left fold in edge order from segment_fill_value, exactly as in the plain
// version. Float min/max fold in edge order too and follow the plain
// version's scatter_reduce: a NaN operand wins, ties keep the earlier value.
//
// Layouts whose runs are not contiguous (subshard tiles of a src_sorted graph)
// come with perm, the valid flat edge positions stably sorted by run: run r's
// edges are then perm[run_start[r] .. run_end[r]), still in ascending edge
// order, and an edge position i reads edge perm[i]. perm is null for
// destination-sorted layouts, whose positions are flat edge slots.
//
// What bounds it on the H100: the gathers. Per edge a streamed 4-byte source
// id (plus weights/dst where read) and a random 4-byte gather of y, a 32-byte
// L2 sector for 4 useful bytes (y is 9.6 MB at 2.4 M vertices and stays in
// L2); per run its start and CSR entry. Short chunks run at the pace of the
// gathers' sector traffic, with as many warps in flight as the register cap
// allows; a long run's windows come one after another in one warp, so the
// longest run (19,163 edges at R-MAT scale 22) is a floor of its own.
//
// Exactness: the build uses --fmad=false and the float operations are written
// as __fmul_rn/__fadd_rn, so v*inv*w is two rounded products and never an FMA;
// the per-vertex part v*inv is the same rounded product as before.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kInfDepth = 1 << 30;  // INF_DEPTH of repro_torch.core.identities
constexpr int kLanes = 32;
constexpr int kCap = 512;             // positions of a window, and at most of a short chunk
constexpr int kLongRun = kCap;        // LONG_RUN of packed_sweep.py
constexpr int kPer = kCap / kLanes;   // 16 positions a lane
constexpr int kHeads = kCap + 4;      // a short chunk's head list (kCap + 1, padded)
constexpr int kWarps = 4;             // chunks per thread block (run_partials)
constexpr int kThreads = 256;         // pre_gather and fold_runs

enum Reduce { kSum, kMin, kMax };

// The aux leaves of one query (already offset by k * aux_stride).
struct Aux {
  const void* aux0;
  const void* aux1;
};

// Each program's gather, split into the part that depends on the source
// vertex alone (pre) and the per-edge rest (edge). kW: edge reads the
// weights; kDst: edge reads the edge's destination.
struct PageRankOp {
  typedef float T;
  static constexpr Reduce kReduce = kSum;
  static constexpr bool kW = true, kDst = false;
  __device__ static T ident() { return 0.0f; }
  __device__ static T fill() { return 0.0f; }
  __device__ static T pre(T v, int s, const Aux& x) {
    return __fmul_rn(v, static_cast<const float*>(x.aux0)[s]);
  }
  __device__ static T edge(T y, bool has_w, float w, int, int, const Aux&) {
    return has_w ? __fmul_rn(y, w) : y;
  }
};

struct BFSOp {
  typedef int T;
  static constexpr Reduce kReduce = kMin;
  static constexpr bool kW = false, kDst = false;
  __device__ static T ident() { return kInfDepth; }
  __device__ static T fill() { return INT_MAX; }
  __device__ static T pre(T v, int, const Aux&) { return v >= kInfDepth ? kInfDepth : v + 1; }
  __device__ static T edge(T y, bool, float, int, int, const Aux&) { return y; }
};

struct WCCOp {
  typedef int T;
  static constexpr Reduce kReduce = kMin;
  static constexpr bool kW = false, kDst = false;
  __device__ static T ident() { return kInfDepth; }
  __device__ static T fill() { return INT_MAX; }
  __device__ static T pre(T v, int, const Aux&) { return v; }
  __device__ static T edge(T y, bool, float, int, int, const Aux&) { return y; }
};

struct SSSPOp {
  typedef float T;
  static constexpr Reduce kReduce = kMin;
  static constexpr bool kW = true, kDst = false;
  __device__ static T ident() { return INFINITY; }
  __device__ static T fill() { return INFINITY; }
  __device__ static T pre(T v, int, const Aux&) { return v; }
  __device__ static T edge(T y, bool has_w, float w, int, int, const Aux&) {
    return __fadd_rn(y, has_w ? w : 1.0f);
  }
};

struct MaxLabelForwardOp {
  typedef int T;
  static constexpr Reduce kReduce = kMax;
  static constexpr bool kW = false, kDst = false;
  __device__ static T ident() { return -kInfDepth; }
  __device__ static T fill() { return INT_MIN; }
  __device__ static T pre(T v, int s, const Aux& x) {
    return static_cast<const int*>(x.aux0)[s] > 0 ? v : -kInfDepth;
  }
  __device__ static T edge(T y, bool, float, int, int, const Aux&) { return y; }
};

struct ReachBackwardOp {
  typedef int T;
  static constexpr Reduce kReduce = kMax;
  static constexpr bool kW = false, kDst = true;
  __device__ static T ident() { return -kInfDepth; }
  __device__ static T fill() { return INT_MIN; }
  // 1 where the source is live (mask and attrs set); the colour test is per edge.
  __device__ static T pre(T v, int s, const Aux& x) {
    return (static_cast<const int*>(x.aux0)[s] > 0 && v > 0) ? 1 : 0;
  }
  __device__ static T edge(T y, bool, float, int s, int d, const Aux& x) {
    const int* color = static_cast<const int*>(x.aux1);
    return (y != 0 && color[s] == color[d]) ? 1 : 0;
  }
};

// acc (+) x, the plain version's step: a NaN x wins, ties keep acc.
template <Reduce R>
__device__ __forceinline__ float combine(float acc, float x) {
  if (R == kSum) return __fadd_rn(acc, x);
  if (isnan(x)) return x;
  if (R == kMin) return x < acc ? x : acc;
  return x > acc ? x : acc;
}

template <Reduce R>
__device__ __forceinline__ int combine(int acc, int x) {
  if (R == kSum) return acc + x;
  if (R == kMin) return min(acc, x);
  return max(acc, x);
}

template <class T> struct Vec4;
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<int> { typedef int4 type; };

// acc folded with p[0 .. n) in order; p is 16-byte aligned.
template <Reduce R, class T>
__device__ __forceinline__ T fold_aligned(T acc, const T* p, int n) {
  typedef typename Vec4<T>::type V;
  int i = 0;
#pragma unroll 4
  for (; i + 4 <= n; i += 4) {
    const V v = *reinterpret_cast<const V*>(p + i);
    acc = combine<R>(acc, v.x);
    acc = combine<R>(acc, v.y);
    acc = combine<R>(acc, v.z);
    acc = combine<R>(acc, v.w);
  }
  for (; i < n; ++i) acc = combine<R>(acc, p[i]);
  return acc;
}

struct Args {
  int K, n_pad, NC, isz;
  long long aux_stride;
  const void* attrs;
  const void* acc;
  void* out;
  void* y;        // (n_pad, K) scratch: the per-vertex part of the gather
  void* partial;  // (R, K) scratch: the run partials
  const int* src;
  const int* dst;
  const float* w;
  const int* run_start;
  const int* run_tile;
  const int* dst_ptr;
  const int* dst_runs;
  const int4* chunks;  // (NC, 2): {run0, run1, pos0, pos1}, {interval, tile, 0, 0}
  const int* perm;  // nullptr: positions are flat edge slots
  const unsigned char* tile_sel;  // nullptr: every tile selected
  const unsigned char* row_active;
  const void* aux0;
  const void* aux1;
  // The range path's fold list (nullptr and 0 on the whole-layout path):
  // ND touched destinations fold_dst[i], each with its runs
  // fold_runs[fold_ptr[i] .. fold_ptr[i + 1]) in ascending order.
  int ND;
  const int* fold_ptr;
  const int* fold_dst;
  const int* fold_runs;
};

__device__ __forceinline__ Aux aux_of(const Args& a, int k) {
  const long long off = 4LL * k * a.aux_stride;
  Aux x;
  x.aux0 = a.aux0 == nullptr ? nullptr : static_cast<const char*>(a.aux0) + off;
  x.aux1 = a.aux1 == nullptr ? nullptr : static_cast<const char*>(a.aux1) + off;
  return x;
}

// y[s, :] for the vertices of active intervals; the rest is never read.
// One thread per vertex: attrs rows read coalesced, y's row written whole
// (16-byte stores where K is a multiple of 4).
template <class Op>
__global__ void __launch_bounds__(kThreads) pre_gather(Args a) {
  typedef typename Op::T T;
  typedef typename Vec4<T>::type V;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= a.n_pad || !a.row_active[s / a.isz]) return;
  const T* attrs = static_cast<const T*>(a.attrs) + s;
  T* y = static_cast<T*>(a.y) + static_cast<size_t>(s) * a.K;
  int k = 0;
  if ((a.K & 3) == 0) {
    for (; k < a.K; k += 4) {
      V q;
      q.x = Op::pre(attrs[static_cast<size_t>(k) * a.n_pad], s, aux_of(a, k));
      q.y = Op::pre(attrs[static_cast<size_t>(k + 1) * a.n_pad], s, aux_of(a, k + 1));
      q.z = Op::pre(attrs[static_cast<size_t>(k + 2) * a.n_pad], s, aux_of(a, k + 2));
      q.w = Op::pre(attrs[static_cast<size_t>(k + 3) * a.n_pad], s, aux_of(a, k + 3));
      *reinterpret_cast<V*>(y + k) = q;
    }
  }
  for (; k < a.K; ++k) y[k] = Op::pre(attrs[static_cast<size_t>(k) * a.n_pad], s, aux_of(a, k));
}

// Shared memory of one warp of run_partials: a window's values and a short
// chunk's head list.
template <class T, int KG>
__host__ __device__ constexpr size_t warp_smem() {
  return sizeof(T) * KG * kCap + sizeof(int) * kHeads;
}

// One window's edge operands in registers, position p = j * 32 + lane.
// W: the op reads weights and the graph has them.
template <bool W, bool D>
struct Edges {
  int s[kPer];
  float w[W ? kPer : 1];
  int d[D ? kPer : 1];
};

template <class Op, bool W>
__device__ __forceinline__ void load_edges(const Args& a, int w0, int n, int lane,
                                           Edges<W, Op::kDst>& r) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = j * kLanes + lane;
    if (p < n) {
      const int e = a.perm != nullptr ? a.perm[w0 + p] : w0 + p;
      r.s[j] = a.src[e];
      if (W) r.w[W ? j : 0] = a.w[e];
      if (Op::kDst) r.d[Op::kDst ? j : 0] = a.dst[e];
    }
  }
}

// The contribs of positions (j0 + j) * 32 + lane, j < J, for queries
// k0 .. k0 + kn: v[j * KG + kk].
template <class Op, bool W, int KG, int J>
__device__ __forceinline__ void gather(const Args& a, const Edges<W, Op::kDst>& r, int n, int lane,
                                       int k0, int kn, int j0, typename Op::T (&v)[J * KG]) {
  typedef typename Op::T T;
  const T* y = static_cast<const T*>(a.y);
  const bool vec = KG == 4 && kn == 4 && (a.K & 3) == 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int jj = j0 + j;
    if (jj * kLanes + lane < n) {
      const T* row = y + static_cast<size_t>(r.s[jj]) * (KG == 1 ? 1 : a.K) + k0;
      if (vec) {
        const typename Vec4<T>::type q = __ldg(reinterpret_cast<const typename Vec4<T>::type*>(row));
        v[j * KG] = q.x;
        v[j * KG + (KG > 1 ? 1 : 0)] = q.y;
        v[j * KG + (KG > 2 ? 2 : 0)] = q.z;
        v[j * KG + (KG > 3 ? 3 : 0)] = q.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          if (kk < kn) v[j * KG + kk] = __ldg(row + kk);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        if (kk < kn) {
          v[j * KG + kk] = Op::edge(v[j * KG + kk], W, W ? r.w[W ? jj : 0] : 0.0f, r.s[jj],
                                    Op::kDst ? r.d[Op::kDst ? jj : 0] : 0, aux_of(a, k0 + kk));
        }
      }
    }
  }
}

template <class Op, int KG, int J>
__device__ __forceinline__ void stage(typename Op::T* sval, const typename Op::T (&v)[J * KG],
                                      int n, int lane, int kn, int j0) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = (j0 + j) * kLanes + lane;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (p < n && kk < kn) sval[kk * kCap + p] = v[j * KG + kk];
    }
  }
}

// A window's contribs into shared memory: all 16 positions a lane at once
// for one query, four at a time for a group of four (fewer registers).
template <class Op, bool W, int KG>
__device__ __forceinline__ void gather_stage(const Args& a, const Edges<W, Op::kDst>& r,
                                             typename Op::T* sval, int n, int lane, int k0, int kn) {
  constexpr int J = KG == 1 ? kPer : 4;
#pragma unroll
  for (int j0 = 0; j0 < kPer; j0 += J) {
    typename Op::T v[J * KG];
    gather<Op, W, KG, J>(a, r, n, lane, k0, kn, j0, v);
    stage<Op, KG, J>(sval, v, n, lane, kn, j0);
  }
}

// acc folded with p[i0 .. i1) in order, four loads in flight.
template <Reduce R, class T>
__device__ __forceinline__ T fold_span(T acc, const T* p, int i0, int i1) {
  int i = i0;
  for (; i + 4 <= i1; i += 4) {
    const T x0 = p[i], x1 = p[i + 1], x2 = p[i + 2], x3 = p[i + 3];
    acc = combine<R>(acc, x0);
    acc = combine<R>(acc, x1);
    acc = combine<R>(acc, x2);
    acc = combine<R>(acc, x3);
  }
  for (; i < i1; ++i) acc = combine<R>(acc, p[i]);
  return acc;
}

// A short chunk: runs run0 .. run1 over positions pos0 .. pos1 (at most kCap
// of them). The runs are consecutive, so their starts are the head list:
// run h spans heads[h] .. heads[h + 1]. The (run, query) folds go round
// robin over the lanes, so a lane's partials are neighbours of its
// neighbours' and the stores coalesce.
template <class Op, bool W, int KG>
__device__ void fold_chunk(const Args& a, int4 c, typename Op::T* sval, int* heads, int lane) {
  typedef typename Op::T T;
  const int run0 = c.x, pos0 = c.z;
  const int H = c.y - run0;
  const int n = c.w - pos0;
  Edges<W, Op::kDst> er;
  load_edges<Op, W>(a, pos0, n, lane, er);
  int st[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j * kLanes + lane < H) st[j] = a.run_start[run0 + j * kLanes + lane];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j * kLanes + lane < H) heads[j * kLanes + lane] = st[j] - pos0;
  }
  if (lane == 0) heads[H] = n;
  T* partial = static_cast<T*>(a.partial);
  const int K = KG == 1 ? 1 : a.K;  // KG = 1 is launched for K = 1 only
  for (int k0 = 0; k0 < K; k0 += KG) {
    const int kn = min(KG, K - k0);
    gather_stage<Op, W, KG>(a, er, sval, n, lane, k0, kn);
    __syncwarp();
    for (int t = lane; t < H * kn; t += kLanes) {
      const int h = KG == 1 ? t : t / kn;
      const int kk = KG == 1 ? 0 : t - h * kn;
      partial[static_cast<size_t>(run0 + h) * K + k0 + kk] =
          fold_span<Op::kReduce>(Op::fill(), sval + kk * kCap, heads[h], heads[h + 1]);
    }
    __syncwarp();
  }
}

// A long chunk: run r over positions pos0 .. pos1, in windows of kCap. Lane
// kk folds query k0 + kk; the edge loads of window t+1 are in flight while
// window t is folded. (Gathering window t+1 ahead as well, in registers or
// by cp.async into a ring of windows, did not shorten the longest run.)
template <class Op, bool W, int KG>
__device__ void fold_long_run(const Args& a, int4 c, typename Op::T* sval, int lane) {
  typedef typename Op::T T;
  const int r = c.x, pos0 = c.z, pos1 = c.w;
  T* partial = static_cast<T*>(a.partial);
  const int K = KG == 1 ? 1 : a.K;
  for (int k0 = 0; k0 < K; k0 += KG) {
    const int kn = min(KG, K - k0);
    T acc = Op::fill();
    Edges<W, Op::kDst> er;
    load_edges<Op, W>(a, pos0, min(kCap, pos1 - pos0), lane, er);
    for (int w0 = pos0; w0 < pos1; w0 += kCap) {
      const int n = min(kCap, pos1 - w0);
      gather_stage<Op, W, KG>(a, er, sval, n, lane, k0, kn);
      if (w0 + kCap < pos1) load_edges<Op, W>(a, w0 + kCap, min(kCap, pos1 - w0 - kCap), lane, er);
      __syncwarp();
      if (lane < kn) acc = fold_aligned<Op::kReduce>(acc, sval + lane * kCap, n);
      __syncwarp();
    }
    if (lane < kn) partial[static_cast<size_t>(r) * K + k0 + lane] = acc;
  }
}

// Blocks of run_partials an SM must hold at once, which caps the registers
// (64 a thread for one query, 128 for a group of four): more warps in
// flight cover more of the gathers' latency. Both caps were picked by
// timing neighbouring ones on the H100; a group of four spills badly at 64.
constexpr int kMinBlocks1 = 8;
constexpr int kMinBlocks4 = 4;

// Phase 1: one warp per chunk, kWarps chunks per thread block.
template <class Op, bool W, int KG>
__global__ void __launch_bounds__(kWarps * kLanes, KG == 1 ? kMinBlocks1 : kMinBlocks4) run_partials(Args a) {
  typedef typename Op::T T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= a.NC) return;  // the whole warp
  const int4 span = a.chunks[2 * c];
  const int4 where = a.chunks[2 * c + 1];
  if (a.tile_sel != nullptr && !a.tile_sel[where.y]) return;
  if (!a.row_active[where.x]) {  // every run folds identities only
    const T v = combine<Op::kReduce>(Op::fill(), Op::ident());
    T* partial = static_cast<T*>(a.partial);
    const size_t hi = static_cast<size_t>(span.y) * a.K;
    for (size_t i = static_cast<size_t>(span.x) * a.K + lane; i < hi; i += kLanes) partial[i] = v;
    return;
  }
  unsigned char* mine = smem + warp * warp_smem<T, KG>();
  T* sval = reinterpret_cast<T*>(mine);
  if (span.y - span.x == 1 && span.w - span.z > kLongRun) {
    fold_long_run<Op, W, KG>(a, span, sval, lane);
  } else {
    fold_chunk<Op, W, KG>(a, span, sval, reinterpret_cast<int*>(mine + sizeof(T) * KG * kCap), lane);
  }
}

// Phase 2: one thread per destination, its runs in ascending order, the
// queries kFold at a time (a run's K partials are one row).
constexpr int kFold = 8;

// acc[k, d] folded with the runs runs[q0 .. q1) in order, for every query,
// written to out[k, d] (acc and out may be one array: one thread owns d).
// Runs of tiles the selection left out are skipped.
template <class Op>
__device__ __forceinline__ void fold_dest(const Args& a, int d, int q0, int q1, const int* runs,
                                          const typename Op::T* acc, typename Op::T* out) {
  typedef typename Op::T T;
  const T* partial = static_cast<const T*>(a.partial);
  if (a.K == 1) {
    T v = acc[d];
    for (int q = q0; q < q1; ++q) {
      const int r = runs[q];
      if (a.tile_sel != nullptr && !a.tile_sel[a.run_tile[r]]) continue;
      v = combine<Op::kReduce>(v, partial[r]);
    }
    out[d] = v;
    return;
  }
  for (int k0 = 0; k0 < a.K; k0 += kFold) {
    const int kn = min(kFold, a.K - k0);
    T v[kFold];
#pragma unroll
    for (int kk = 0; kk < kFold; ++kk) {
      if (kk < kn) v[kk] = acc[static_cast<size_t>(k0 + kk) * a.n_pad + d];
    }
    for (int q = q0; q < q1; ++q) {
      const int r = runs[q];
      if (a.tile_sel != nullptr && !a.tile_sel[a.run_tile[r]]) continue;
      const T* row = partial + static_cast<size_t>(r) * a.K + k0;
#pragma unroll
      for (int kk = 0; kk < kFold; ++kk) {
        if (kk < kn) v[kk] = combine<Op::kReduce>(v[kk], row[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kFold; ++kk) {
      if (kk < kn) out[static_cast<size_t>(k0 + kk) * a.n_pad + d] = v[kk];
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads) fold_runs(Args a) {
  typedef typename Op::T T;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= a.n_pad) return;
  fold_dest<Op>(a, d, a.dst_ptr[d], a.dst_ptr[d + 1], a.dst_runs, static_cast<const T*>(a.acc),
                static_cast<T*>(a.out));
}

// The range path's phase 2: one thread per touched destination, in place.
template <class Op>
__global__ void __launch_bounds__(kThreads) fold_touched(Args a) {
  typedef typename Op::T T;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.ND) return;
  T* acc = static_cast<T*>(a.out);
  fold_dest<Op>(a, a.fold_dst[i], a.fold_ptr[i], a.fold_ptr[i + 1], a.fold_runs, acc, acc);
}

template <class Op, bool W, int KG>
int launch_kg(const Args& a, cudaStream_t stream) {
  typedef typename Op::T T;
  if (a.n_pad == 0 || a.K == 0) return 0;
  const unsigned vblocks = (a.n_pad + kThreads - 1) / kThreads;
  pre_gather<Op><<<vblocks, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.NC > 0) {
    const size_t smem = kWarps * warp_smem<T, KG>();
    run_partials<Op, W, KG><<<(a.NC + kWarps - 1) / kWarps, kWarps * kLanes, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fold_runs<Op><<<vblocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One tile range: run_partials over its chunk rows, then fold_touched.
template <class Op, bool W, int KG>
int launch_range_kg(const Args& a, cudaStream_t stream) {
  typedef typename Op::T T;
  if (a.K == 0) return 0;
  cudaError_t err;
  if (a.NC > 0) {
    const size_t smem = kWarps * warp_smem<T, KG>();
    run_partials<Op, W, KG><<<(a.NC + kWarps - 1) / kWarps, kWarps * kLanes, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.ND > 0) fold_touched<Op><<<(a.ND + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Op, bool W>
int launch_w(const Args& a, cudaStream_t stream, bool range) {
  if (range) return a.K == 1 ? launch_range_kg<Op, W, 1>(a, stream) : launch_range_kg<Op, W, 4>(a, stream);
  return a.K == 1 ? launch_kg<Op, W, 1>(a, stream) : launch_kg<Op, W, 4>(a, stream);
}

template <class Op>
int launch(const Args& a, cudaStream_t stream, bool range = false) {
  if (Op::kW && a.w != nullptr) return launch_w<Op, Op::kW>(a, stream, range);
  return launch_w<Op, false>(a, stream, range);
}

template <class Op>
int launch_pre_gather(const Args& a, cudaStream_t stream) {
  if (a.n_pad == 0 || a.K == 0) return 0;
  pre_gather<Op><<<(a.n_pad + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes (repro_torch/kernels/packed_sweep.py).
// Returns cudaGetLastError() of the launches: 0 on success.
extern "C" int packed_sweep_launch(
    int prog, int K, int n_pad, int NC, int isz, long long aux_stride,
    const void* attrs, const void* acc, void* out, void* y, void* partial,
    const int* src, const int* dst, const float* w, const int* run_start,
    const int* run_tile, const int* dst_ptr, const int* dst_runs, const int* chunks,
    const int* perm, const unsigned char* tile_sel, const unsigned char* row_active,
    const void* aux0, const void* aux1, void* stream) {
  Args a;
  a.K = K;
  a.n_pad = n_pad;
  a.NC = NC;
  a.isz = isz;
  a.aux_stride = aux_stride;
  a.attrs = attrs;
  a.acc = acc;
  a.out = out;
  a.y = y;
  a.partial = partial;
  a.src = src;
  a.dst = dst;
  a.w = w;
  a.run_start = run_start;
  a.run_tile = run_tile;
  a.dst_ptr = dst_ptr;
  a.dst_runs = dst_runs;
  a.chunks = reinterpret_cast<const int4*>(chunks);
  a.perm = perm;
  a.tile_sel = tile_sel;
  a.row_active = row_active;
  a.aux0 = aux0;
  a.aux1 = aux1;
  a.ND = 0;
  a.fold_ptr = nullptr;
  a.fold_dst = nullptr;
  a.fold_runs = nullptr;
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

// The range path's first entry: pre_gather alone, y[s, k] for the sources of
// active intervals, once a sweep (y is (n_pad, K)).
extern "C" int packed_sweep_pre_gather(
    int prog, int K, int n_pad, int isz, long long aux_stride, const void* attrs, void* y,
    const unsigned char* row_active, const void* aux0, const void* aux1, void* stream) {
  Args a = {};
  a.K = K;
  a.n_pad = n_pad;
  a.isz = isz;
  a.aux_stride = aux_stride;
  a.attrs = attrs;
  a.y = y;
  a.row_active = row_active;
  a.aux0 = aux0;
  a.aux1 = aux1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prog) {
    case 0: return launch_pre_gather<PageRankOp>(a, s);
    case 1: return launch_pre_gather<BFSOp>(a, s);
    case 2: return launch_pre_gather<WCCOp>(a, s);
    case 3: return launch_pre_gather<SSSPOp>(a, s);
    case 4: return launch_pre_gather<MaxLabelForwardOp>(a, s);
    case 5: return launch_pre_gather<ReachBackwardOp>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The range path's second entry: fold one tile range's runs into acc, in
// place. Every index is range-local: runs, positions (flat slots of the
// range's tiles, or perm entries) and tiles (tile_sel, run_tile); y comes from
// packed_sweep_pre_gather of the same sweep, and partial holds at least the
// range's runs times K. run_tile is read only under a selection.
extern "C" int packed_sweep_range_launch(
    int prog, int K, int n_pad, int NC, int ND, int isz, long long aux_stride,
    const void* y, void* acc, void* partial, const int* src, const int* dst, const float* w,
    const int* run_start, const int* run_tile, const int* chunks, const int* perm,
    const int* fold_ptr, const int* fold_dst, const int* fold_runs,
    const unsigned char* tile_sel, const unsigned char* row_active,
    const void* aux0, const void* aux1, void* stream) {
  Args a = {};
  a.K = K;
  a.n_pad = n_pad;
  a.NC = NC;
  a.isz = isz;
  a.aux_stride = aux_stride;
  a.acc = acc;
  a.out = acc;
  a.y = const_cast<void*>(y);
  a.partial = partial;
  a.src = src;
  a.dst = dst;
  a.w = w;
  a.run_start = run_start;
  a.run_tile = run_tile;
  a.chunks = reinterpret_cast<const int4*>(chunks);
  a.perm = perm;
  a.tile_sel = tile_sel;
  a.row_active = row_active;
  a.aux0 = aux0;
  a.aux1 = aux1;
  a.ND = ND;
  a.fold_ptr = fold_ptr;
  a.fold_dst = fold_dst;
  a.fold_runs = fold_runs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prog) {
    case 0: return launch<PageRankOp>(a, s, true);
    case 1: return launch<BFSOp>(a, s, true);
    case 2: return launch<WCCOp>(a, s, true);
    case 3: return launch<SSSPOp>(a, s, true);
    case 4: return launch<MaxLabelForwardOp>(a, s, true);
    case 5: return launch<ReachBackwardOp>(a, s, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
