// Flash attention (online softmax) for the LM wing, hand-written for Hopper
// (sm_90a): a tensor-core body for bfloat16 inputs and a CUDA-core body for
// float32 inputs.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel, the Pallas TPU
// kernel that flash_attention launches on a (batch*q_heads, q_blocks,
// kv_blocks) grid, carrying the running max, denominator and accumulator in
// VMEM from one KV block to the next.
//
// What it computes, for q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D):
//
//   s   = q . k^T * scale              (see "Numerics" for where scale goes)
//   s   = softcap * tanh(s / softcap)  if a softcap is given, before the mask
//   key k_pos visible to q_pos iff  k_pos < Sk
//                               and q_pos >= k_pos          (if causal)
//                               and q_pos - k_pos < window  (if a window)
//   out = softmax over the visible keys of s, times v; float32 softmax,
//         stored in q's dtype. Query head h reads KV head h / (Hq / Hkv) of
//         the same batch; K and V are never repeated in memory.
//
// The online softmax is the TPU kernel's, step for step, in both bodies:
// masked scores are NEG_INF = -1e30; after each KV tile m = max(m,
// rowmax(s)); while a row has seen no visible key (m <= NEG_INF / 2)
// alpha = 1 and the max is taken as 0; masked p are zeroed; l = alpha * l +
// rowsum(p); acc = alpha * acc + p v; out = acc / max(l, 1e-30), so a row
// that sees no key gives 0. A KV tile whose keys all fail the mask for every
// row of a block (wholly above the causal diagonal or before the window)
// would leave m, l and acc as they are, so it is skipped. (In the bfloat16
// body a tile that one warpgroup's rows cannot see but its partner's can
// goes through the mask: alpha = 1 and p = 0, so it changes no bit.)
//
// Numerics.
// * float32 inputs (flash_attention_f32_launch): q is scaled in float32
//   before the product and both products are float32 fmaf on the CUDA cores.
//   The JAX tests' float32 bound (2e-5) rules out TF32 and bf16 products.
// * bfloat16 inputs (flash_attention_bf16_launch): s = q . k^T takes the
//   bf16 q and k as they are on the tensor cores with float32 accumulation
//   (a bf16 x bf16 product is exact in float32), then is multiplied by scale
//   in float32; for a power-of-two scale (1/16 at D = 256) this equals the
//   TPU kernel's (q * scale) . k up to float32 summation order. For p v, p is
//   rounded to bf16 (float32 accumulation); l sums the float32 p. That
//   rounding is the one the float32 body does not make; it stays inside the
//   JAX tests' bf16 bound (3e-2, held on the CPU by an emulation in
//   tests/test_torch_flash_attention.py and on the card by the cuda tests).
// * Neither body uses atomics and every sum has a fixed order, so a repeated
//   launch gives the same bits, and strided inputs give the bits of their
//   contiguous copies.
//
// What bounds it on the H100: operations. Each visible (q, k) pair costs
// 4 D operations (a multiply and an add for q.k and for p v); at gemma-2b's
// serving buckets (8 x 1024 and 4 x 2048, Hq 8, Hkv 1, D 256, causal) that
// is 3.4e10-6.9e10 operations against 75 MB of q, k, v and out: 35-70 us at
// the bf16 tensor-core rate, 0.5-1.0 ms at the float32 CUDA-core rate.
//
// The bfloat16 body (namespace tc) is shaped for that bound:
// * One block takes 128 query rows of one (batch, query head): two consumer
//   warpgroups of 64 rows each, plus a producer warpgroup. Blocks are launched
//   longest first (the q block with the most causal keys), so the causal
//   tail is short.
// * The producer's first thread keeps a ring of K/V tiles (64 keys each; 2
//   stages at D = 256, 4 below) in flight with TMA (cp.async.bulk.tensor,
//   one 4-D tensor map per operand built at each launch, so (batch, head,
//   seq) strides are taken as they are and rows past Sk or columns past D
//   arrive as zeros) and mbarriers: k_full / v_full say a tile has landed,
//   k_empty / v_empty that both consumer warpgroups are done with it (K
//   after S, V after p v). q arrives the same way once. Every tile is a
//   stack of 64-column panels in the 128-byte swizzle that TMA writes and
//   wgmma reads.
// * S = Q K^T is wgmma m64n64k16 with both operands in shared memory (K as a
//   K-major B operand); the scale, softcap, mask and online softmax run on
//   the accumulator registers; P goes from the S accumulator straight into
//   bf16 A-operand registers (the accumulator layout of one m64n16 slice is
//   the A-fragment layout of a k16 step), and O += P V is wgmma m64n64k16
//   with A in registers and V as an MN-major (transposed) B operand, one
//   instruction per 64-column panel of V.
// * Each warpgroup starts S(t) and the previous tile's P V together, waits
//   for S(t) only, and runs the softmax of tile t on the CUDA cores while
//   P V is still on the tensor cores; then o is rescaled by alpha(t). The
//   arithmetic, and its order, is that of one tile at a time. No wgmma is
//   started under a condition and the warpgroup index is broadcast from lane
//   0, so ptxas keeps the wgmma pipelined (it reports when it does not).
// * At D = 256 the O accumulator is 64 x 256 float32 per warpgroup, 128
//   registers a thread: setmaxnreg gives the consumers 240 registers and
//   the producer 24. The build prints ptxas's register and spill counts.
// * The per-element mask runs only on tiles that straddle the diagonal, the
//   window's edge or Sk; other tiles take every score without a select.
// * Shared memory at D = 256: q 64 KB + 2 stages x (K 32 KB + V 32 KB) =
//   192 KB, one block per SM.
//
// The float32 body (kept from the first port of this kernel): one 256-thread
// block per (64-row q block, batch*q_head) loops over 32-key K/V tiles that
// it stages itself; m, l and acc stay in registers. 256 threads = 16 (tx) x
// 16 (ty). Thread (tx, ty) owns query rows ty + 16 i (i < 4); in the score
// tile its keys are tx + 16 j (j < 2), in the output its head-dim columns are
// 64 g + 4 tx + e (g < DP / 64, e < 4). Row max and row sum are butterflies
// over the 16 lanes of a half warp. The head dimension is padded with zeros
// to DP in {64, 128, 256}; D = 256 stages q (64 KB), k (33 KB), v (32 KB) and
// p (8 KB) in 137 KB of dynamic shared memory. The dot products use fmaf
// explicitly (the build passes --fmad=false, which only stops the compiler
// from contracting on its own).

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// The float32 body: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;              // query rows per thread block
constexpr int kBK = 32;              // keys per KV tile
constexpr int kTX = 16;              // lanes across keys / head-dim columns
constexpr int kTY = 16;              // lanes across query rows
constexpr int kThreads = kTX * kTY;  // 256
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // keys per thread in the score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// The bfloat16 body: TMA ring, wgmma on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;                   // query rows per block
constexpr int kBN = 64;                    // keys per K/V tile
constexpr int kConsumerThreads = 256;      // two warpgroups of 64 rows each
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kPanel = 64;                 // head-dim columns of a 128-byte swizzled panel
constexpr float kNegInf = -1e30f;

// Byte offsets in dynamic shared memory (from a 1024-byte aligned base, as
// the 128-byte swizzle needs) for head dims padded to DP.
template <int DP>
struct Layout {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kStages = DP == 256 ? 2 : 4;
  static constexpr int kQPanel = kBM * 128;   // bytes of one panel of q
  static constexpr int kKPanel = kBN * 128;   // bytes of one panel of a K or V tile
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kTileBytes = kPanels * kKPanel;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase with this parity has completed. (No
// watchdog: a __trap() path here makes ptxas spill the D = 256 accumulators
// and serialize the wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile starting at
// `addr`: rows of 128 bytes, 8-row groups 1024 bytes apart. Both byte
// offsets are 1024: the K-major operands (q, K) read the stride-dimension
// offset (8-row groups), the MN-major operand (V, 64 columns = one swizzle
// atom wide) steps 8 keys by it as well.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma window.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) = [d +] A (64 x 16, bf16) . B (16 x 64, bf16); A and B in
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16, in registers) . B (16 x 64, bf16, in
// shared memory, MN-major: the transpose flag is set).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Grid: (B * Hq, q blocks); blockIdx.y = 0 takes the last q block.
// Accumulator layout of wgmma m64n64 (and so of s and each o panel): thread
// (warp w, lane) holds rows 16 w + lane / 4 (registers 4 j + 0, 1) and that
// row + 8 (4 j + 2, 3) at columns 8 j + 2 (lane % 4) + {0, 1}, j < 8.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Layout<DP>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + S + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * S + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * S + s); };

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh % a.Hq;
  const int kvh = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // KV tiles any row of this block can see: [t_begin, t_end).
  const int q_last = min(q0 + kBM, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.has_window ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = k_begin / kBN;
  const int t_end = k_end > k_begin ? (k_end + kBN - 1) / kBN : t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerThreads);
      mbar_init(v_empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Broadcast from lane 0, so the compiler sees the warpgroup (and every
  // condition drawn from it) as uniform and keeps the wgmma pipelined.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // Producer: one thread keeps the ring full. A stage's K is free once
    // both consumer warpgroups have taken S from it, its V once they have
    // added p v.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p) tma_load(sq + p * L::kQPanel, &tq, q_full, p * kPanel, q0, h, b);
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int s = it % S;
        const uint32_t phase = (it / S) & 1;
        mbar_wait(k_empty(s), phase ^ 1);
        mbar_expect_tx(k_full(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sk + s * L::kTileBytes + p * L::kKPanel, &tk, k_full(s), p * kPanel, t * kBN, kvh, b);
        mbar_wait(v_empty(s), phase ^ 1);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sv + s * L::kTileBytes + p * L::kKPanel, &tv, v_full(s), p * kPanel, t * kBN, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;                          // this warpgroup's first row
    const int row0 = qw0 + 16 * (tid / 32) + lane / 4;     // the thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t qa = sq + wg * 64 * 128;                // its 64 rows within each q panel

    float o[L::kPanels][32];
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    float sc[32];
    uint32_t pa[kBN / 16][4];  // P as bf16 A fragments, one per 16-key step
    float alpha[2];

    // S(t) = q K(t)^T over DP / 16 steps of 16 head-dim columns (not waited for).
    auto start_s = [&](int it) {
      // Shared-memory bases made opaque to the compiler, so it forms each
      // descriptor next to its wgmma instead of holding all of them (32
      // registers for q's alone at D = 256) across the loop.
      uint32_t qb = qa, kb = sk + (it % S) * L::kTileBytes;
      asm volatile("" : "+r"(qb), "+r"(kb));
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled row
        wgmma_ss(sc, sw128_desc(qb + (kk / 4) * L::kQPanel + off),
                 sw128_desc(kb + (kk / 4) * L::kKPanel + off), kk > 0);
      }
      wgmma_commit();
    };
    // o += p v for the tile in ring slot it % S, 16 keys a step, one
    // instruction per 64-column panel (not waited for).
    auto start_pv = [&](int it) {
      uint32_t vb = sv + (it % S) * L::kTileBytes;
      asm volatile("" : "+r"(vb));
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          wgmma_rs_mn(o[p], pa[kk], sw128_desc(vb + p * L::kKPanel + kk * 16 * 128));
      wgmma_commit();
    };
    auto phase_of = [&](int it) { return static_cast<uint32_t>((it / S) & 1); };
    // Scale, softcap, mask and the online softmax of S(t): sc becomes p,
    // m and l move on, alpha is left for o. The per-element mask runs only
    // where the tile straddles the diagonal, the window's edge or Sk. A
    // tile wholly masked for these rows leaves m and l as they are and
    // gives alpha = 1, p = 0.
    auto softmax = [&](int t) {
      const int kt0 = t * kBN;
      const bool edge = kt0 + kBN > a.Sk || (a.causal && kt0 + kBN - 1 > qw0) ||
                        (a.has_window && qw0 + 63 - kt0 >= a.window);
      uint32_t vis = 0xffffffffu;  // bit i: sc[i] is visible
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float x = __fmul_rn(sc[i], a.scale);
        if (a.has_softcap) x = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x, a.softcap)));
        if (edge) {
          const int qp = row0 + 8 * r;
          const int kp = kt0 + 8 * (i / 4) + col0 + i % 2;
          bool ok = kp < a.Sk;
          if (a.causal) ok = ok && qp >= kp;
          if (a.has_window) ok = ok && qp - kp < a.window;
          if (!ok) {
            x = kNegInf;
            vis &= ~(1u << i);
          }
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float m_sub[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        const bool dead = m_new <= kNegInf / 2;
        alpha[r] = dead ? 1.0f : expf(__fsub_rn(m[r], m_new));
        m_sub[r] = dead ? 0.0f : m_new;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float p = expf(__fsub_rn(sc[i], m_sub[r]));
        if (edge && !((vis >> i) & 1u)) p = 0.0f;  // (a masked score gives 0 here already)
        sc[i] = p;
        rs[r] = __fadd_rn(rs[r], p);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), quad_sum(rs[r]));
    };
    // P to bf16 A fragments: 16 keys (k step kk) are accumulator registers
    // 8 kk .. 8 kk + 7 of S, already in the A-fragment order.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] = __fmul_rn(alpha[(i / 2) % 2], o[p][i]);
    };

    mbar_wait(q_full, 0);
    const int n = t_end - t_begin;
    if (n > 0) {
      // The first tile alone: o is 0, so alpha * o is 0 whatever alpha is.
      mbar_wait(k_full(0), 0);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      fence_regs(sc);
      wgmma_fence();
      start_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty(0));
      softmax(t_begin);
      pack_p();
    }
    // Tile it: S(it) and the previous tile's p v go to the tensor cores
    // together; the softmax of S(it) runs on the CUDA cores while p v is
    // still running; then o is rescaled by alpha(it). That is the same
    // acc = alpha acc + p v, in the same order, as one tile at a time.
    for (int it = 1; it < n; ++it) {
      mbar_wait(k_full(it % S), phase_of(it));
      mbar_wait(v_full((it - 1) % S), phase_of(it - 1));
      fence_regs(sc);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) fence_regs(o[p]);
      wgmma_fence();
      start_s(it);
      start_pv(it - 1);
      wgmma_wait<1>();  // S(it) is done; p v may still run
      fence_regs(sc);
      mbar_arrive(k_empty(it % S));
      softmax(t_begin + it);
      wgmma_wait<0>();  // p v is done
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) fence_regs(o[p]);
      mbar_arrive(v_empty((it - 1) % S));
      rescale_o();
      pack_p();
    }
    if (n > 0) {  // the last tile's p v
      mbar_wait(v_full((n - 1) % S), phase_of(n - 1));
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) fence_regs(o[p]);
      wgmma_fence();
      start_pv(n - 1);
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) fence_regs(o[p]);
      mbar_arrive(v_empty((n - 1) % S));
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= a.Sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* row = out + (static_cast<long long>(bh) * a.Sq + qp) * a.D;
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = p * kPanel + 8 * j + col0;
          const float x0 = __fdiv_rn(o[p][4 * j + 2 * r], den);
          const float x1 = __fdiv_rn(o[p][4 * j + 2 * r + 1], den);
          if (c + 1 < a.D && a.D % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (c < a.D) row[c] = __float2bfloat16_rn(x0);
            if (c + 1 < a.D) row[c + 1] = __float2bfloat16_rn(x1);
          }
        }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (D8, S, H, B) of a bf16 tensor with element strides (ss, sh, sb)
// and a box of 64 columns x `rows` rows. D8 is D rounded up to 8 (the
// wrapper pads rows that are not): a multiple of 16 bytes, as TMA needs. A
// dimension of extent 1 gets a packed stride whatever its own.
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B, long long ss,
             long long sh, long long sb, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long d8 = (D + 7) / 8 * 8;
  const long long packed[3] = {d8, d8 * S, d8 * S * H};
  const long long given[3] = {ss, sh, sb};
  const long long extent[3] = {S, H, B};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d8), static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long st = extent[i] > 1 ? given[i] : packed[i];
    if (st <= 0 || st % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    strides[i] = static_cast<cuuint64_t>(st) * 2;
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads as 0
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DP>
int launch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, a.q, a.D, a.Sq, a.Hq, B, a.q_ss, a.q_sh, a.q_sb, kBM);
  if (a.Sk == 0) {  // no tile is read: maps of q stand in for the empty k and v
    tk = tq;
    tv = tq;
  } else {
    if (err == 0) err = make_map(&tk, a.k, a.D, a.Sk, Hkv, B, a.k_ss, a.k_sh, a.k_sb, kBN);
    if (err == 0) err = make_map(&tv, a.v, a.D, a.Sk, Hkv, B, a.v_ss, a.v_sh, a.v_sb, kBN);
  }
  if (err != 0) return err;
  auto kern = flash_tc_kernel<DP>;
  constexpr int bytes = Layout<DP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * a.Hq, (a.Sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  if (a.D <= 64) return launch<64>(a, B, Hkv, stream);
  if (a.D <= 128) return launch<128>(a, B, Hkv, stream);
  return launch<256>(a, B, Hkv, stream);
}

}  // namespace tc

// The C entries take the same arguments; the wrapper picks one by dtype.
#define FLASH_PARAMS                                                                  \
  int B, int Hq, int Hkv, int Sq, int Sk, int D, long long q_sb, long long q_sh,      \
      long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb, \
      long long v_sh, long long v_ss, float scale, int causal, int has_window,         \
      int window, int has_softcap, float softcap, const void *q, const void *k,       \
      const void *v, void *out, void *stream

#define FLASH_ARGS                                                                       \
  B, Hq, Hkv, Sq, Sk, D, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,   \
      causal, has_window, window, has_softcap, softcap, q, k, v, out, stream

int launch_body(bool tensor_cores, FLASH_PARAMS) {
  const int rows_per_block = tensor_cores ? tc::kBM : kBQ;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 || D <= 0 || D > 256 ||
      (Sq + rows_per_block - 1) / rows_per_block > 65535)
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
  return tensor_cores ? tc::dispatch(a, B, Hkv, s) : dispatch<float>(a, B * Hq, s);
}

}  // namespace

// float32 q, k, v: the CUDA-core body.
extern "C" int flash_attention_f32_launch(FLASH_PARAMS) { return launch_body(false, FLASH_ARGS); }

// bfloat16 q, k, v: the tensor-core body. Rows must start 16-byte aligned:
// strides of extents above 1 a multiple of 8 and D a multiple of 8 (the
// wrapper copies other inputs into padded rows first).
extern "C" int flash_attention_bf16_launch(FLASH_PARAMS) { return launch_body(true, FLASH_ARGS); }
