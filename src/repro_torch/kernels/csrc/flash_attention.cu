// Flash attention (online softmax) for the LM wing, hand-written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel, the Pallas TPU
// kernel that flash_attention launches on a (batch*q_heads, q_blocks,
// kv_blocks) grid, carrying the running max, denominator and accumulator in
// VMEM from one KV block to the next.
//
// What it computes, for q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D):
//
//   s   = (q * scale) . k^T            q scaled in float32 before the product
//   s   = softcap * tanh(s / softcap)  if a softcap is given, before the mask
//   key k_pos visible to q_pos iff  k_pos < Sk
//                               and q_pos >= k_pos          (if causal)
//                               and q_pos - k_pos < window  (if a window)
//   out = softmax over the visible keys of s, times v; float32 math, stored
//         in q's dtype. Query head h reads KV head h / (Hq / Hkv) of the same
//         batch; K and V are never repeated in memory.
//
// The online softmax is the TPU kernel's, step for step: masked scores are
// NEG_INF = -1e30; after each KV tile m = max(m, rowmax(s)); while a row has
// seen no visible key (m <= NEG_INF / 2) alpha = 1 and the max is taken as 0;
// masked p are zeroed; l = alpha * l + rowsum(p); acc = alpha * acc + p v;
// out = acc / max(l, 1e-30), so a row that sees no key gives 0.
//
// Design. On the TPU the grid runs in order and m, l, acc live in scratch
// between grid steps. On Hopper blocks run in parallel and in no order, so
// one thread block takes one (64-row q block, batch*q_head) pair and loops
// over the KV tiles itself: m, l and acc stay in registers for the whole
// loop, and only K and V tiles (32 keys) pass through shared memory. A
// tile's keys all fail the mask when the tile lies wholly above the causal
// diagonal or wholly before the window; those tiles are skipped, which
// leaves m, l and acc as they were and so changes no result.
//
// 256 threads = 16 (tx) x 16 (ty). Thread (tx, ty) owns query rows
// ty + 16 i (i < 4); in the score tile its keys are tx + 16 j (j < 2), in the
// output its head-dim columns are 64 g + 4 tx + e (g < DP / 64, e < 4). Row
// max and row sum are butterflies over the 16 lanes of a half warp. The head
// dimension is padded with zeros to DP in {64, 128, 256} (a template
// argument, so the accumulator is a fixed register array): D = 256 keeps
// 4 x 16 accumulators a thread and stages q (64 KB), k (33 KB), v (32 KB) and
// p (8 KB) in 137 KB of dynamic shared memory, past the 48 KB default, so
// the launch raises the limit with cudaFuncSetAttribute.
//
// What bounds it on the H100: operations. Each visible (q, k) pair costs
// 4 D operations (a multiply and an add for q.k and for p v); at gemma-2b's
// serving buckets that is 3.4e10-6.9e10 operations against 75 MB of q, k,
// v and out. This first kernel computes in float32 on the CUDA cores, as
// the TPU kernel computes in float32: its floor is the CUDA cores' 67
// TFLOP/s, not the tensor cores' bf16 rate. It reads q once per block and
// each K/V tile once per 64 query rows; the inner loops read shared memory
// as float4 (the k rows are padded by 4 floats so 8 lanes cover 32 banks)
// and multiply-add in registers. wgmma, TMA and bf16 products are later
// work.
//
// Exactness: no atomics, fixed reduction orders, so a repeated launch gives
// the same bits. The dot products use fmaf explicitly (the build passes
// --fmad=false, which only stops the compiler from contracting on its own);
// the plain PyTorch version sums in another order, so the two agree within
// a tolerance.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // query rows per thread block
constexpr int kBK = 32;              // keys per KV tile
constexpr int kTX = 16;              // lanes across keys / head-dim columns
constexpr int kTY = 16;              // lanes across query rows
constexpr int kThreads = kTX * kTY;  // 256
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // keys per thread in the score tile
constexpr float kNegInf = -1e30f;

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

// Shared-memory layout, in floats, for head dims padded to DP.
template <int DP>
struct Smem {
  static constexpr int kKStride = DP + 4;  // float4 reads of 8 rows hit 32 banks
  static constexpr int kPStride = kBK + 1;
  static constexpr int kQ = kBQ * DP;
  static constexpr int kK = kBK * kKStride;
  static constexpr int kV = kBK * DP;
  static constexpr int kP = kBQ * kPStride;
  static constexpr int kBytes = 4 * (kQ + kK + kV + kP);
};

struct Args {
  int Hq, group, Sq, Sk, D;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;  // element strides
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
  const void* q;
  const void* k;
  const void* v;
  void* out;  // (B, Hq, Sq, D), contiguous
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(Args a) {
  constexpr int kG = DP / 64;  // float4 column groups per thread in the output
  using S = Smem<DP>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::kQ;
  float* Vs = Ks + S::kK;
  float* Ps = Vs + S::kV;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh % a.Hq;
  const int kvh = h / a.group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // The q block, scaled in float32; rows past Sq and columns past D are 0.
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP, qp = q0 + r;
    Qs[i] = (qp < a.Sq && c < a.D) ? __fmul_rn(to_f(qb[qp * a.q_ss + c]), a.scale) : 0.0f;
  }

  // Keys any row of this block can see: [k_begin, k_end).
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.has_window ? max(0, q0 - a.window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][4 * kG];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    // Stage the K and V tile; keys past k_end and columns past D are 0, so
    // masked keys multiply zeros and never bring garbage into acc.
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, kp = k0 + r;
      const bool in = kp < k_end && c < a.D;
      Ks[r * S::kKStride + c] = in ? to_f(kb[kp * a.k_ss + c]) : 0.0f;
      Vs[r * DP + c] = in ? to_f(vb[kp * a.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    // Scores: a 4 x 2 register tile per thread.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + kTY * i) * DP + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + kTX * j) * S::kKStride + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Softcap, mask, and the online softmax update of each row.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + kTY * i;
      bool vis[kCols];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + kTX * j;
        float x = s[i][j];
        if (a.has_softcap) x = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x, a.softcap)));
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && qp >= kp;
        if (a.has_window) ok = ok && qp - kp < a.window;
        vis[j] = ok;
        s[i][j] = ok ? x : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const bool dead = m_new <= kNegInf / 2;
      const float alpha = dead ? 1.0f : expf(__fsub_rn(m[i], m_new));
      const float m_sub = dead ? 0.0f : m_new;
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = vis[j] ? expf(__fsub_rn(s[i][j], m_sub)) : 0.0f;
        Ps[(ty + kTY * i) * S::kPStride + tx + kTX * j] = p;
        row_sum = __fadd_rn(row_sum, p);
      }
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), half_warp_sum(row_sum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] = __fmul_rn(alpha, acc[i][c]);
    }
    __syncthreads();

    // acc += p v over the tile's keys that exist (the rest have p = 0, v = 0).
    const int kn = min(kBK, k_end - k0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty + kTY * i) * S::kPStride + c];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + c * DP + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + kTY * i;
    if (qp >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = out + (static_cast<long long>(bh) * a.Sq + qp) * a.D;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * g + 4 * tx + e;
        if (c < a.D) row[c] = from_f<T>(__fdiv_rn(acc[i][4 * g + e], den));
      }
  }
}

template <typename T, int DP>
int launch(const Args& a, int bh, cudaStream_t stream) {
  auto kern = flash_kernel<T, DP>;
  constexpr int bytes = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (a.Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int bh, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(a, bh, stream);
  if (a.D <= 128) return launch<T, 128>(a, bh, stream);
  return launch<T, 256>(a, bh, stream);
}

}  // namespace

extern "C" int flash_attention_launch(
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int has_window, int window, int has_softcap,
    float softcap, const void* q, const void* k, const void* v, void* out,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 || D <= 0 || D > 256 ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.Hq = Hq;
  a.group = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.scale = scale;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.has_softcap = has_softcap;
  a.softcap = softcap;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(a, B * Hq, s);
    case 1: return dispatch<__nv_bfloat16>(a, B * Hq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
