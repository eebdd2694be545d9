// The weight-only quantized product y[M, N] = (x[M, K] . q[N, K]^T) * scale[N]
// for Hopper (sm_90a): int8 or e4m3 weights stored [N, K] (the
// torch Linear layout, one row per output channel), one f32 scale per
// output channel, x in bf16 or f32, y in x's dtype, f32 accumulation.
//
// Replaces no Pallas kernel: tpudl's fused quantized product
// (tpudl/quant/dense.py quant_dot, "fused") is XLA's mixed-dtype
// dot_general with preferred_element_type=f32, then one per-channel
// multiply. Its point is that the full-precision weight never exists in
// device memory; no PyTorch call contracts bf16 activations against int8
// or e4m3 weights on CUDA without first writing the dequantized weight,
// so the port's fused form is this kernel.
//
// Two entry points:
//
// (a) tpudl_quant_gemv, M <= 16 (decode). Bound by the weight's bytes:
//     N * K bytes of int8/e4m3 streamed once (5.03 us at [4, 4096] ->
//     4096 on the H100's 3.35 TB/s). What held the first design (a CUDA-
//     core FMA loop, 2 rows a warp) to 20-51 % of that was issue, not the
//     memory: 16 scalar FMAs per row of x per 16 weights, x re-read through
//     L1 per weight vector, too few loads in flight at N = 1024, and a
//     cold start after pdl_wait(). For bf16 x in whole 16-byte vectors
//     (the main path) quant_gemv_mma_kernel, section (d):
//     - tensor cores: the weights, widened to bf16 by integer tricks
//       (widen_quad), are mma.sync m16n8k16's A operand (16 channels, or
//       8 where the plan wants twice the tiles), x^T its B operand (one
//       n8 tile for M <= 8, two for M <= 16), held in registers for a
//       round of K and reused against every channel tile the warp streams;
//       the mma's free K order lets a lane feed one 16-byte weight load
//       straight to its fragments;
//     - K split: one slice a warp, the warps of a CTA summed in shared
//       memory in warp order: no atomics, no workspace, one launch,
//       bitwise repeatable; the plan (tpudl_torch/ops/quant_dot.py
//       gemv_plan) depends on the shape alone;
//     - weights streamed deep: the next tile's 16-byte loads issue as the
//       current tile's are consumed (one tile, 4 steps of K, always in
//       flight), no L1 allocation, L2 asked for 256 bytes a request, one
//       CTA of 16 warps a multiprocessor (64 KB of loads in flight);
//     - the launch ramp: a programmatic dependent launch that asks L2
//       for its first tile's weights before pdl_wait() (weights are
//       immutable during a decode step, and L2 is where the kernel
//       ahead's writes land too) and reads nothing else before it; the
//       next kernel is let in after the last weight load.
//     f32 x, a ragged K or a misaligned pointer take quant_gemv_kernel:
//     2 output rows a warp, 16-byte or scalar weight loads widened to
//     f32, 2 x M f32 sums a lane reduced with xor-shuffles in a fixed
//     order, the same dependent launch (no prefetch). Each route is chosen
//     by operand; neither falls back to the other.
//
// (b) tpudl_quant_gemm, M > 16 (prefill, BERT), bf16 x in whole 16-byte
//     vectors (the main path): quant_gemm_tma_kernel. Bound by the
//     weight's bytes at a prefill's M = 128 (N * K bytes) and by
//     operations at BERT's M = 32768 (2 M N K at the bf16 tensor-core
//     rate). The output tile is computed transposed, y^T = q . x^T, so the
//     weight is wgmma's A operand, widened to bf16 in registers: a block
//     of two consumer warpgroups takes 128 channels (64 each) by 128 rows
//     of x (wgmma m64n128k16, x as B from shared memory, K-major), and a
//     producer warpgroup keeps 6 stages of the x tile and the raw weight
//     tile (bytes: half of bf16's shared memory per weight) in flight by
//     TMA. A consumer widens the next stage's weights while the
//     current stage's products run. Where the output tiles number at least
//     the SMs (BERT's M = 32768) a tile takes 256 rows of x (wgmma
//     m64n256k16, the consumers taking the producer's registers), which
//     halves the x and weight bytes a product pulls into shared memory.
//     The grid is persistent, and where the output tiles are fewer than
//     the SMs (a prefill's M = 128), K is split as far as the units still
//     fit one wave: each split's f32 partial goes to a workspace and a
//     dependent launch adds the partials in split order, applies the
//     scale once and rounds once, so the result is bitwise repeatable.
//     The plan (split, steps a split, grid) comes from the wrapper
//     (tpudl_torch/ops/quant_dot.py gemm_plan).
//     Otherwise (f32 x, ragged K or a misaligned pointer) the mma.sync
//     kernel: 64 x 64 output tiles, 4 warps of 32 x 32, K in steps of 32,
//     mma.sync m16n8k16 bf16 with f32 accumulation, the tiles passing
//     through registers, one step ahead, into two shared stages; an f32 x
//     is split into three bf16 terms (hi + mid + lo, each exact), three
//     mma per step, so the product keeps nearly all of f32's mantissa.
//     Ragged M, N and K are zero-filled in shared memory.
//
// Weights are widened with integer tricks rather than conversion
// instructions (a quarter of the ALU rate): an int8 v becomes the f32
// 2^23 + (v + 128), less 2^23 + 128; an e4m3 byte's exponent and mantissa
// bits placed at f32's exponent field make 2^-120 times its value
// (subnormals included), times 2^120. Both are exact, and the high half of
// the f32 is the bf16 (at most 8 significant bits). The TMA kernel widens
// two weights at a time straight to a bf16 pair (widen_pair).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "attention_hopper.cuh"  // mbarriers, wgmma descriptors, tensor-map encoding

namespace {

using tpudl::from_f32;
using tpudl::to_f32;

// Weight storage codes, as the wrapper encodes them.
enum QType : int { kInt8 = 0, kE4M3 = 1 };

// ---------------------------------------------------------------------------
// Weight element -> f32 (exact for both types).
// ---------------------------------------------------------------------------

template <int Q> __device__ __forceinline__ float q_to_f32(uint32_t b);
template <> __device__ __forceinline__ float q_to_f32<kInt8>(uint32_t b) {
  // b in the low byte: (b ^ 0x80) = v + 128 in [1, 255].
  return __int_as_float(0x4B000000u | ((b ^ 0x80u) & 0xffu)) - 8388736.0f;
}
template <> __device__ __forceinline__ float q_to_f32<kE4M3>(uint32_t b) {
  const uint32_t bits = ((b & 0x80u) << 24) | ((b & 0x7Fu) << 20);
  return __int_as_float(bits) * 0x1p120f;
}

// Sixteen weights (one 16-byte vector) -> f32.
template <int Q>
__device__ __forceinline__ void unpack_q16(const uint4& raw, float (&out)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = q_to_f32<Q>(w[i] >> (8 * j));
  }
}

// ---------------------------------------------------------------------------
// (a) the FMA GEMV: f32 x, or bf16 x with a ragged K or misaligned pointers
// ---------------------------------------------------------------------------

constexpr int kGemvWarps = 4;
constexpr int kGemvRows = 2;  // output rows a warp

// Sixteen consecutive elements of T at p (16-byte aligned, read-only
// device memory) -> f32, as 16-byte loads through the L1 path.
template <typename T>
__device__ __forceinline__ void ldg16(const T* p, float (&out)[16]) {
  constexpr int W = tpudl::VecWidth<T>::value;
#pragma unroll
  for (int i = 0; i < 16 / W; ++i) {
    float part[W];
    tpudl::unpack_vec<T>(__ldg(reinterpret_cast<const uint4*>(p) + i), part);
#pragma unroll
    for (int j = 0; j < W; ++j) out[i * W + j] = part[j];
  }
}

// VEC = 16: 16-byte weight loads (K % 16 == 0, aligned); VEC = 1: scalar.
// MB rows of x are computed (a template bound: 4, 8 or 16); rows past
// m_rows re-read row m_rows - 1 (no branch in the loop) and are not
// written.
template <typename T, int Q, int VEC, int MB>
__global__ void __launch_bounds__(kGemvWarps * 32)
    quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ y, int m_rows, int n,
                      int64_t k) {
  constexpr int R = kGemvRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kGemvWarps + warp) * R;
  // Rows past n read row n - 1 (in bounds) and are not written.
  int64_t qoff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) qoff[r] = static_cast<int64_t>(min(row0 + r, n - 1)) * k;
  int64_t xoff[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) xoff[m] = static_cast<int64_t>(min(m, m_rows - 1)) * k;

  float acc[R][MB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[r][m] = 0.0f;

  tpudl::pdl_wait();

  if constexpr (VEC == 16) {
    const int nv = static_cast<int>(k / 16);
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      float w[R][16];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        unpack_q16<Q>(__ldg(reinterpret_cast<const uint4*>(q + qoff[r]) + v), w[r]);
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float xv[16];
        ldg16(x + xoff[m] + 16 * static_cast<int64_t>(v), xv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = acc[r][m];
#pragma unroll
          for (int j = 0; j < 16; ++j) s = fmaf(xv[j], w[r][j], s);
          acc[r][m] = s;
        }
      }
    }
  } else {
    for (int64_t i = lane; i < k; i += 32) {
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = q_to_f32<Q>(q[qoff[r] + i]);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = to_f32(x[xoff[m] + i]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][m] = fmaf(xv, w[r], acc[r][m]);
      }
    }
  }
  tpudl::pdl_launch_dependents();

  // Fixed-order butterfly: every lane ends with the warp's sum.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const float s = scale[min(row, n - 1)];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (row < n && m < m_rows) {
          y[static_cast<int64_t>(m) * n + row] = from_f32<T>(acc[r][m] * s);
        }
      }
    }
  }
}

template <typename T, int Q, int VEC>
int launch_gemv_v(const void* x, const void* q, const void* scale, void* y, int m, int n,
                  int64_t k, cudaStream_t st) {
  constexpr int rows_per_block = kGemvWarps * kGemvRows;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block));
  const dim3 block(kGemvWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  if (m <= 4) {
    return tpudl::launch_pdl(quant_gemv_kernel<T, Q, VEC, 4>, grid, block, st, xp, qp, sp, yp,
                             m, n, k);
  }
  if (m <= 8) {
    return tpudl::launch_pdl(quant_gemv_kernel<T, Q, VEC, 8>, grid, block, st, xp, qp, sp, yp,
                             m, n, k);
  }
  return tpudl::launch_pdl(quant_gemv_kernel<T, Q, VEC, 16>, grid, block, st, xp, qp, sp, yp,
                           m, n, k);
}

template <typename T, int Q>
int launch_gemv(const void* x, const void* q, const void* scale, void* y, int m, int n,
                int64_t k, cudaStream_t st) {
  const bool vec = k % 16 == 0 && tpudl::aligned16(x) && tpudl::aligned16(q);
  return vec ? launch_gemv_v<T, Q, 16>(x, q, scale, y, m, n, k, st)
             : launch_gemv_v<T, Q, 1>(x, q, scale, y, m, n, k, st);
}

// ---------------------------------------------------------------------------
// (b) the tiled tensor-core product
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;
// Row stride of a shared tile in bf16 elements: 8 of padding make the
// fragment loads of 8 rows x 4 lanes hit 32 distinct banks.
constexpr int kLds = kBK + 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The high 16 bits of two f32 as one bf16 pair (exact for values with at
// most 8 significant bits, as widened weights are).
__device__ __forceinline__ uint32_t pack_hi16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// One thread's share of a step's tiles, held in registers between the
// loads and the shared-memory stores: 16 consecutive elements of one row
// of the x tile and of the weight tile, widened.
struct StepRegs {
  float xf[16];
  float w[16];
};

// SPLIT = 1 (bf16 x) or 3 (f32 x as hi + mid + lo bf16 terms).
// VEC = 16: whole 16-byte vectors (K % 16 == 0, aligned); VEC = 1:
// element loads. bf16 x in whole vectors takes quant_gemm_tma_kernel, so
// bf16 x comes here only with VEC = 1.
template <typename T, int Q, int VEC, int SPLIT>
__global__ void __launch_bounds__(128)
    quant_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ y, int m_rows, int n,
                      int64_t k) {
  __shared__ __align__(16) __nv_bfloat16 a_s[2][SPLIT][kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBN * kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's 32 x 32
  const int group = lane >> 2, tig = lane & 3;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  // This thread's row of each tile and its 16 columns.
  const int lr = tid >> 1, lc = (tid & 1) * 16;
  const int64_t gm = m0 + lr, gn = n0 + lr;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  StepRegs regs;
  auto load_step = [&](int64_t k0) {
    if constexpr (VEC == 16) {
      if (gm < m_rows && k0 + lc < k) {
        ldg16(x + gm * k + k0 + lc, regs.xf);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) regs.xf[j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t gk = k0 + lc + j;
        regs.xf[j] = (gm < m_rows && gk < k) ? to_f32(x[gm * k + gk]) : 0.0f;
      }
    }
    if constexpr (VEC == 16) {
      if (gn < n && k0 + lc < k) {
        unpack_q16<Q>(__ldg(reinterpret_cast<const uint4*>(q + gn * k + k0 + lc)), regs.w);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) regs.w[j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t gk = k0 + lc + j;
        regs.w[j] = (gn < n && gk < k) ? q_to_f32<Q>(q[gn * k + gk]) : 0.0f;
      }
    }
  };
  auto store_step = [&](int buf) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = regs.xf[j];
#pragma unroll
    for (int sp = 0; sp < SPLIT; ++sp) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(&a_s[buf][sp][lr * kLds + lc]);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[j], v[j + 1]);
        dst[j / 2] = *reinterpret_cast<const uint32_t*>(&h);
        // The remainder (exact in f32) feeds the next term.
        v[j] -= __low2float(h);
        v[j + 1] -= __high2float(h);
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(&bs[buf][lr * kLds + lc]);
#pragma unroll
    for (int j = 0; j < 16; j += 2) dst[j / 2] = pack_hi16(regs.w[j], regs.w[j + 1]);
  };

  load_step(0);
  int buf = 0;
  for (int64_t k0 = 0; k0 < k; k0 += kBK, buf ^= 1) {
    store_step(buf);
    // One barrier a step: the other stage was last read a step ago, before
    // every thread reached this one.
    __syncthreads();
    if (k0 + kBK < k) load_step(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bfrag[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* b = &bs[buf][(wn + j * 8 + group) * kLds + kk + tig * 2];
        bfrag[j][0] = *reinterpret_cast<const uint32_t*>(b);
        bfrag[j][1] = *reinterpret_cast<const uint32_t*>(b + 8);
      }
#pragma unroll
      for (int sp = 0; sp < SPLIT; ++sp) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* a = &a_s[buf][sp][(wm + i * 16 + group) * kLds + kk + tig * 2];
          uint32_t afrag[4];
          afrag[0] = *reinterpret_cast<const uint32_t*>(a);
          afrag[1] = *reinterpret_cast<const uint32_t*>(a + 8 * kLds);
          afrag[2] = *reinterpret_cast<const uint32_t*>(a + 8);
          afrag[3] = *reinterpret_cast<const uint32_t*>(a + 8 * kLds + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], afrag, bfrag[j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t cn = n0 + wn + j * 8 + tig * 2;
    const float s0 = cn < n ? scale[cn] : 0.0f;
    const float s1 = cn + 1 < n ? scale[cn + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t cm = m0 + wm + i * 16 + group + 8 * h;
        if (cm >= m_rows) continue;
        if (cn < n) y[cm * n + cn] = from_f32<T>(acc[i][j][2 * h] * s0);
        if (cn + 1 < n) y[cm * n + cn + 1] = from_f32<T>(acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) the TMA + wgmma product: bf16 x in whole 16-byte vectors, M > 16
// ---------------------------------------------------------------------------

namespace hop = tpudl::hopper;

// The output tile is computed transposed, y^T = q . x^T, so the weight is
// wgmma's A operand and can be widened in registers: a block takes
// kConsumers x 64 output channels (a consumer warpgroup of 64 each,
// wgmma's M) by BT rows of x (wgmma's N: 128, or 256 where the tiles fill
// the card), K in steps of 64. (Measured on the H100: three consumers, or
// clusters of 2 and 4 blocks multicasting each x tile to neighbouring
// channel tiles, were no faster; a split K summed by a cluster of the
// tile's blocks through distributed shared memory, in place of the
// workspace and the second launch, was 1.1-1.8x slower at a prefill's
// shapes.)
constexpr int kConsumers = 2;
constexpr int kTmaChannels = 64 * kConsumers;
constexpr int kTmaK = 64;
// Rows of x a tile, and of the taller tile taken where its tiles fill the card.
constexpr int kTmaRows = 128;
constexpr int kTmaTallRows = 256;
constexpr int kTmaThreads = 128 * (kConsumers + 1);  // the consumers, then the producer
constexpr uint32_t kQTileBytes = kTmaChannels * kTmaK;

// A stage: the x tile [BT rows][64 k] bf16 (128-byte rows, 128 B swizzle)
// then the raw weight tile [channels][64 k] bytes (64-byte rows, 64 B
// swizzle); both 1024-byte aligned. At BT 256 the consumers hold a
// 64 x 256 f32 accumulator (128 registers a thread) and take the producer
// warpgroup's registers (setmaxnreg).
template <int BT> struct TmaTile {
  static_assert(BT == 128 || BT == 256, "128 or 256 rows of x a tile");
  static constexpr int kStages = BT == 128 ? 6 : 5;
  static constexpr uint32_t kXTileBytes = BT * kTmaK * 2;
  static constexpr uint32_t kStageBytes = kXTileBytes + kQTileBytes;
  static constexpr uint32_t kBarBytes = kStages * kStageBytes;
  static constexpr size_t kSmem = kBarBytes + 16 * kStages + 1024;  // + barriers, + alignment
  static_assert(kStageBytes % 1024 == 0 && kXTileBytes % 1024 == 0, "1024-byte aligned tiles");
  static_assert(kSmem <= 232448, "shared memory of one block");
};
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65536

// The work: units of (split s, row tile mt, channel tile nt), channel
// tile fastest; unit u takes K steps [s * per, min((s + 1) * per, ksteps)).
struct GemmPlan {
  int m, n;
  int ksteps, split, per;
  int tiles_m, tiles_n, units;
};

struct Unit {
  int split, mt, nt, kb0, kb1;
};

__device__ __forceinline__ Unit unit_of(const GemmPlan& p, int u) {
  const int tiles = p.tiles_m * p.tiles_n;
  Unit w;
  w.split = u / tiles;
  const int t = u - w.split * tiles;
  w.mt = t / p.tiles_n;
  w.nt = t - w.mt * p.tiles_n;
  w.kb0 = w.split * p.per;
  w.kb1 = min(w.kb0 + p.per, p.ksteps);
  return w;
}

// wgmma.mma_async m64nNk16, bf16, f32 accumulator: D[64, N] (+)= A B, A
// from registers (the m16n8k16 A fragment per warp), B from shared
// memory, K-major (no transpose). The accumulator's layout is
// attention_hopper.cuh's Wgmma.
template <int N> struct WgmmaK;

template <> struct WgmmaK<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <> struct WgmmaK<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

// One box of a 2-D tensor map into shared memory; completion (its bytes)
// goes to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = a * b + c on bf16 pairs (exact wherever the callers use it).
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two weights -> one bf16 pair of an A fragment: bytes 2t and 2t + 1 of the
// 8 bytes (wa, wb), `sel` the thread's byte_perm selector (the byte in
// each half's low byte; for e4m3 its sign replicated into the high
// byte). Exact, with integer tricks in place of conversions:
// - int8 v (byte b): 128 + (b & 127) and 128 (b >= 0) or 256 (b < 0) are
//   bf16 numbers; their difference is v.
// - e4m3: sign, exponent and mantissa bits moved to bf16's fields give
//   2^-120 times the value (subnormals included); times 2^120.
template <int Q>
__device__ __forceinline__ uint32_t widen_pair(uint32_t wa, uint32_t wb, uint32_t sel) {
  const uint32_t x = __byte_perm(wa, wb, sel);
  if constexpr (Q == kInt8) {
    const uint32_t big = (x & 0x007F007Fu) | 0x43004300u;
    const uint32_t base = (x & 0x00800080u) | 0x43004300u;
    return fma_bf16x2(base, 0xBF80BF80u, big);  // big - base
  } else {
    const uint32_t bits = (x & 0x80008000u) | ((x & 0x007F007Fu) << 4);
    return fma_bf16x2(bits, 0x7B807B80u, 0x80008000u);  // bits * 2^120 + (-0)
  }
}

// The thread's A fragments of one stage (16 registers: 4 k16 slices x
// a0..a3) from the raw weight tile at `qt`: rows r and r + 8 of the tile,
// which TMA stored with the 64 B swizzle (16-byte chunk c of row r at
// chunk c ^ ((r >> 1) & 3); rows r and r + 8 share the pattern, and the 8
// rows a warp reads at once land in 8 distinct 4-bank groups).
template <int Q>
__device__ __forceinline__ void widen_stage(const uint8_t* qt, int r, uint32_t sel,
                                            uint32_t (&a)[16]) {
  const uint32_t swz = (static_cast<uint32_t>(r) >> 1) & 3u;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t chunk = 16u * (static_cast<uint32_t>(s) ^ swz);
    const uint4 lo = *reinterpret_cast<const uint4*>(qt + r * kTmaK + chunk);
    const uint4 hi = *reinterpret_cast<const uint4*>(qt + (r + 8) * kTmaK + chunk);
    a[4 * s] = widen_pair<Q>(lo.x, lo.y, sel);
    a[4 * s + 1] = widen_pair<Q>(hi.x, hi.y, sel);
    a[4 * s + 2] = widen_pair<Q>(lo.z, lo.w, sel);
    a[4 * s + 3] = widen_pair<Q>(hi.z, hi.w, sel);
  }
}

// The stage's four k16 products into acc, issued and committed as one
// group (not waited for). B: the x tile at `xt`, K-major, 128 B swizzle
// (8-row groups of 1024 bytes).
template <int BT>
__device__ __forceinline__ void stage_products(float (&acc)[BT / 2], const uint32_t (&a)[16],
                                               uint32_t xt, bool first) {
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    WgmmaK<BT>::rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                   hop::smem_desc(xt + 32u * kk, 0, 1024, 1), first && kk == 0 ? 0u : 1u);
  }
  hop::wgmma_commit();
}

// A consumer warpgroup's part of quant_gemm_tma_kernel: its block's
// units, its 64 channels of each tile.
template <int Q, int BT>
__device__ __forceinline__ void consume(const uint8_t* tiles, uint32_t base,
                                        const float* __restrict__ scale,
                                        __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                                        const GemmPlan& p) {
  using Tile = TmaTile<BT>;
  constexpr int kStages = Tile::kStages;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  auto full = [&](int s) { return base + Tile::kBarBytes + 8u * s; };
  auto empty = [&](int s) { return base + Tile::kBarBytes + 8u * (kStages + s); };
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = wg * 64 + warp * 16 + g;  // the thread's first channel row of the tile
  const uint32_t b0 = 2u * t, b1 = 2u * t + 1u;
  const uint32_t sel = Q == kInt8 ? (b0 | (b0 << 4) | (b1 << 8) | (b1 << 12))
                                  : (b0 | ((b0 | 8u) << 4) | (b1 << 8) | ((b1 | 8u) << 12));
  int step = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    const int steps = w.kb1 - w.kb0;
    float acc[BT / 2];
    uint32_t a0[16], a1[16];
    // Stage i: wait for its tiles, widen its weights into `a`, issue its
    // products (not waited for).
    auto stage = [&](int i, uint32_t(&a)[16]) {
      const int st = step + i, slot = st % kStages;
      hop::mbar_wait(full(slot), (st / kStages) & 1);
      widen_stage<Q>(tiles + slot * Tile::kStageBytes + Tile::kXTileBytes, r, sel, a);
      stage_products<BT>(acc, a, base + slot * Tile::kStageBytes, i == 0);
    };
    auto release = [&](int i) {
      if (lane == 0) hop::mbar_arrive(empty((step + i) % kStages));
    };
    // Even stages widen into a0, odd ones into a1: a stage's weights are
    // widened while the previous stage's products run, and a buffer is
    // written again only after the products that read it are waited for.
    // Straight-line code, one products chain (no branch joins two chains
    // of the accumulator while products are in flight).
    stage(0, a0);
    int i = 1;
    for (; i + 1 < steps; i += 2) {
      stage(i, a1);
      wgmma_wait<1>();
      release(i - 1);
      stage(i + 1, a0);
      wgmma_wait<1>();
      release(i);
    }
    if (i < steps) {
      stage(i, a1);
      wgmma_wait<0>();
      release(i - 1);
      release(i);
    } else {
      wgmma_wait<0>();
      release(i - 1);
    }
    hop::reg_fence(acc);
    step += steps;
    if (u + static_cast<int>(gridDim.x) >= p.units) tpudl::pdl_launch_dependents();

    // acc[4j + e]: channel row r (e < 2) or r + 8, row of x 8j + 2t + (e & 1).
    const int c0 = w.nt * kTmaChannels + r, c1 = c0 + 8;
    const int64_t m0 = static_cast<int64_t>(w.mt) * BT + 2 * t;
    if (p.split == 1) {
      const float s0 = c0 < p.n ? scale[c0] : 0.0f;
      const float s1 = c1 < p.n ? scale[c1] : 0.0f;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t m = m0 + 8 * j + e;
          if (m >= p.m) continue;
          if (c0 < p.n) y[m * p.n + c0] = __float2bfloat16_rn(acc[4 * j + e] * s0);
          if (c1 < p.n) y[m * p.n + c1] = __float2bfloat16_rn(acc[4 * j + 2 + e] * s1);
        }
      }
    } else {
      float* part = ws + static_cast<int64_t>(w.split) * p.m * p.n;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t m = m0 + 8 * j + e;
          if (m >= p.m) continue;
          if (c0 < p.n) part[m * p.n + c0] = acc[4 * j + e];
          if (c1 < p.n) part[m * p.n + c1] = acc[4 * j + 2 + e];
        }
      }
    }
  }
}

// The block walks units u = blockIdx.x, + gridDim.x, ... (a persistent
// grid). One thread of the producer warpgroup keeps the stage ring full
// by TMA (zero fill past M, N and K); each consumer warpgroup widens its
// 64 channels' weights of a stage into A fragments while the previous
// stage's products run, issues the stage's products, and hands a slot
// back once its products are done. With split 1 the epilogue applies the scale
// and rounds once to bf16 into y; otherwise it writes the f32 partial to
// ws[split][M][N] for quant_split_sum_kernel.
template <int Q, int BT>
__global__ void __launch_bounds__(kTmaThreads, 1)
    quant_gemm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                          float* __restrict__ ws, const GemmPlan p) {
  using Tile = TmaTile<BT>;
  constexpr int kStages = Tile::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t base = raw + pad;
  const uint8_t* const tiles = smem_raw + pad;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  auto full = [&](int s) { return base + Tile::kBarBytes + 8u * s; };
  auto empty = [&](int s) { return base + Tile::kBarBytes + 8u * (kStages + s); };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(full(s), 1);
      hop::mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  tpudl::pdl_wait();

  if (wg == kConsumers) {
    if constexpr (BT == 256) hop::reg_dealloc<kProducerRegs>();
    if (tid == kConsumers * 128) {
      int step = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit w = unit_of(p, u);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++step) {
          const int slot = step % kStages;
          if (step >= kStages) hop::mbar_wait(empty(slot), ((step / kStages) - 1) & 1);
          const uint32_t dst = base + slot * Tile::kStageBytes;
          hop::mbar_expect_tx(full(slot), Tile::kStageBytes);
          tma_load_2d(dst, xmap, full(slot), kb * kTmaK, w.mt * BT);
          tma_load_2d(dst + Tile::kXTileBytes, qmap, full(slot), kb * kTmaK,
                      w.nt * kTmaChannels);
        }
      }
    }
    tpudl::pdl_launch_dependents();
  } else {
    if constexpr (BT == 256) hop::reg_alloc<kConsumerRegs>();
    consume<Q, BT>(tiles, base, scale, y, ws, p);
  }
}

// The split-K sum: y[i] = bf16(scale[i % n] * (ws[0][i] + ws[1][i] + ...)),
// the partials added in split order, scaled once, rounded once. A
// dependent launch: it reads nothing before the product has finished.
__global__ void __launch_bounds__(256)
    quant_split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                           __nv_bfloat16* __restrict__ y, int64_t mn, int n, int split) {
  tpudl::pdl_wait();
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < mn;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < split; ++p) s += ws[p * mn + i];
    y[i] = __float2bfloat16_rn(s * scale[i % n]);
  }
}

// A rank-2 tensor map of `rows` rows of `cols` elements (`row_bytes`
// apart), boxes of box_rows x box_cols, zero fill past the edges.
int encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, uint64_t cols,
              uint64_t rows, uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows,
              CUtensorMapSwizzle swizzle) {
  const hop::EncodeTiled fn = hop::encode_tiled();
  if (fn == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  const CUresult res = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The TMA kernel's launch: a programmatic dependent launch (it touches no
// device memory before pdl_wait) with its dynamic shared memory.
template <int BT, typename... Params, typename... Args>
int launch_tma(void (*kernel)(Params...), int blocks, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = TmaTile<BT>::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <int Q, int BT>
int launch_gemm_tma(const void* x, const void* q, const void* scale, void* y, void* ws, int m,
                    int n, int64_t k, int split, int per, int grid, cudaStream_t st) {
  static bool opted = false;
  const int ksteps = static_cast<int>((k + kTmaK - 1) / kTmaK);
  // Whole 16-byte rows for TMA; a plan that covers every K step once and
  // leaves no split empty.
  if (k % 16 != 0 || !tpudl::aligned16(x) || !tpudl::aligned16(q)) return cudaErrorInvalidValue;
  if (split < 1 || per < 1 || static_cast<int64_t>(split) * per < ksteps ||
      static_cast<int64_t>(split - 1) * per >= ksteps || grid < 1 ||
      (split > 1 && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  GemmPlan p{m, n, ksteps, split, per, (m + BT - 1) / BT,
             (n + kTmaChannels - 1) / kTmaChannels, 0};
  p.units = p.tiles_m * p.tiles_n * split;
  CUtensorMap xmap, qmap;
  if (const int e = encode_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, m, k * 2, kTmaK, BT,
                              CU_TENSOR_MAP_SWIZZLE_128B)) {
    return e;
  }
  if (const int e = encode_2d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, n, k, kTmaK,
                              kTmaChannels, CU_TENSOR_MAP_SWIZZLE_64B)) {
    return e;
  }
  if (const int e = hop::opt_in_smem(quant_gemm_tma_kernel<Q, BT>, TmaTile<BT>::kSmem, opted)) {
    return e;
  }
  const int blocks = grid < p.units ? grid : p.units;
  const float* sp = static_cast<const float*>(scale);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  float* wp = static_cast<float*>(ws);
  if (const int e = launch_tma<BT>(quant_gemm_tma_kernel<Q, BT>, blocks, st, xmap, qmap, sp, yp,
                                   wp, p)) {
    return e;
  }
  if (split == 1) return 0;
  const int64_t mn = static_cast<int64_t>(m) * n;
  const int64_t want = (mn + 255) / 256;
  const dim3 sum_grid(static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16));
  return tpudl::launch_pdl(quant_split_sum_kernel, sum_grid, dim3(256), st,
                           static_cast<const float*>(wp), sp, yp, mn, n, split);
}

template <int Q>
int launch_gemm_tma_rows(const void* x, const void* q, const void* scale, void* y, void* ws,
                         int m, int n, int64_t k, int split, int per, int grid, int rows,
                         cudaStream_t st) {
  if (rows == kTmaRows) {
    return launch_gemm_tma<Q, kTmaRows>(x, q, scale, y, ws, m, n, k, split, per, grid, st);
  }
  if (rows == kTmaTallRows) {
    return launch_gemm_tma<Q, kTmaTallRows>(x, q, scale, y, ws, m, n, k, split, per, grid, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int Q, int SPLIT>
int launch_gemm(const void* x, const void* q, const void* scale, void* y, int m, int n,
                int64_t k, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  const T* xp = static_cast<const T*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  const bool vec = k % 16 == 0 && tpudl::aligned16(q) && tpudl::aligned16(x);
  if (!vec) {
    quant_gemm_kernel<T, Q, 1, SPLIT><<<grid, 128, 0, st>>>(xp, qp, sp, yp, m, n, k);
  } else if constexpr (SPLIT == 3) {
    quant_gemm_kernel<T, Q, 16, SPLIT><<<grid, 128, 0, st>>>(xp, qp, sp, yp, m, n, k);
  } else {
    return cudaErrorInvalidValue;  // bf16 x in whole vectors takes the TMA kernel
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// (d) the tensor-core GEMV: bf16 x in whole 16-byte vectors, M <= 16
// ---------------------------------------------------------------------------

// A tile is 16 output channels (mma's M), or 8 where the plan wants twice
// the tiles (mma rows 8-15 then zero); a step is 64 of K, one 16-byte
// weight vector a lane for each of its channel rows; a round is up to
// kGemvSteps steps, whose x fragments a warp holds in registers.
constexpr int kGemvTile = 16;
constexpr int kGemvHalfTile = 8;
constexpr int kGemvStepK = 64;
constexpr int kGemvSteps = 4;
// The plan's bounds: warps a CTA (each a K slice; half of it for 9-16
// rows of x, whose fragments take twice the registers), channel tiles a
// CTA.
constexpr int kGemvMaxWarps = 16;
constexpr int kGemvMaxTiles = 16;
// Floats of padding a row of the partials: the 4 lanes of a quad store
// to 4 distinct bank groups.
constexpr int kGemvPad = 4;

// The launch plan (tpudl_torch/ops/quant_dot.py gemv_plan). K is cut into
// one run of whole steps a warp, warp w taking steps [w * ksteps / warps,
// (w + 1) * ksteps / warps) (none empty: warps <= ksteps). The channel
// tiles are cut into `groups` of `tiles`, one group a CTA.
struct GemvPlan {
  int m, n;
  int64_t k;
  int ksteps, warps, tiles, ntiles;
};

// Shared-memory bytes of a CTA's partials: [warps][8 NB rows][tiles x height + pad] f32.
__host__ __device__ constexpr size_t gemv_smem(int warps, int nb, int tiles, int height) {
  return static_cast<size_t>(warps) * 8 * nb * (tiles * height + kGemvPad) * sizeof(float);
}

// The 16 bytes of one channel row at one step, or zeros past K (K is
// whole 16-byte vectors, so a vector is all in or all out). Read once:
// no L1 allocation, and L2 asked for the 256 bytes around it (the quad's
// next steps; measured 10-14 % faster than a plain __ldg on the H100).
__device__ __forceinline__ uint4 gemv_load(const uint8_t* row, int64_t kk, int64_t k, bool live) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (live && kk < k) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(row + kk));
  }
  return v;
}

// Four weights (one word, bytes b0..b3) -> two bf16 pairs, lo = (b0, b2)
// and hi = (b1, b3), exact, by widen_pair's integer tricks; pairing bytes
// 0 and 2 (and 1 and 3) keeps each in the low byte of a half (for hi,
// after one shift) and needs no byte permute: 7 instructions a word
// against widen_pair's 8 (int8) and 10 (e4m3).
template <int Q>
__device__ __forceinline__ void widen_quad(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (Q == kInt8) {
    const uint32_t s = w >> 8;
    lo = fma_bf16x2((w & 0x00800080u) | 0x43004300u, 0xBF80BF80u, (w & 0x007F007Fu) | 0x43004300u);
    hi = fma_bf16x2((s & 0x00800080u) | 0x43004300u, 0xBF80BF80u, (s & 0x007F007Fu) | 0x43004300u);
  } else {
    const uint32_t bl = ((w << 8) & 0x80008000u) | ((w << 4) & 0x07F007F0u);
    const uint32_t bh = (w & 0x80008000u) | ((w >> 4) & 0x07F007F0u);
    lo = fma_bf16x2(bl, 0x7B807B80u, 0x80008000u);
    hi = fma_bf16x2(bh, 0x7B807B80u, 0x80008000u);
  }
}

// y^T = q . x^T on mma.sync m16n8k16: the widened weight is the A operand
// (H = 16 channels, or 8 and zeros, x 16 of K), x^T the B operand (NB n8
// tiles: rows 8b..8b+7 of x), f32 accumulators. The K order inside one mma is free as long as A
// and B agree, so lane (g, t) of a step takes bytes [16t, 16t + 16) of
// channel rows g and (H = 16) g + 8, one 16-byte load each, and, for mma j of the
// step, feeds bytes 4j, 4j + 2 as its k slots 2t, 2t + 1 and bytes 4j + 1,
// 4j + 3 as 2t + 8, 2t + 9 (widen_quad); its x fragment takes the same 16
// elements of row g of x (two 16-byte loads, permuted to match), held in
// registers for the round and reused against every tile the CTA streams.
// Even and odd mma of a step accumulate apart (two dependent chains,
// added in that order at the tile's end). A warp streams its tiles
// with the next tile's loads issued as the current tile's are consumed
// (one tile of loads, 8 a lane, always in flight), writes each tile's
// f32 partial to shared memory, and the CTA sums the warps' partials in
// warp order, applies the scale once and rounds once. Before pdl_wait()
// the kernel only asks L2 for its first tile's weights (immutable during
// a decode step; L2 is where the kernel ahead's writes land too).
template <int Q, int NB, int H>
__global__ void __launch_bounds__(kGemvMaxWarps * 32 / NB, 1)
    quant_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                          const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                          const GemvPlan p) {
  extern __shared__ float part[];
  constexpr int MR = 8 * NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile0 = static_cast<int>(blockIdx.x) * p.tiles;
  const int ntiles = min(p.tiles, p.ntiles - tile0);
  const int chp = p.tiles * H + kGemvPad;
  const int st0 = static_cast<int>(static_cast<int64_t>(warp) * p.ksteps / p.warps);
  const int st1 = static_cast<int>(static_cast<int64_t>(warp + 1) * p.ksteps / p.warps);
  // Channel rows g and g + 8 of tile i (past n: row n - 1, not written).
  auto rows_of = [&](int i, const uint8_t*(&r)[2]) {
    const int c = (tile0 + i) * H + g;
    r[0] = q + static_cast<int64_t>(min(c, p.n - 1)) * p.k;
    r[1] = q + static_cast<int64_t>(min(c + 8, p.n - 1)) * p.k;
  };

  // The first tile's weights of the round at step r0 into L2: lane l
  // takes 128 bytes of channel row l / (32 / H).
  auto prefetch_round = [&](int r0) {
    constexpr int kLanes = 32 / H;  // lanes a row
    const int c = min(tile0 * H + lane / kLanes, p.n - 1);
    const int64_t kk = static_cast<int64_t>(r0) * kGemvStepK + 128 * (lane % kLanes);
    const int64_t end = static_cast<int64_t>(min(r0 + kGemvSteps, st1)) * kGemvStepK;
    if (kk < p.k && kk < end) {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(q + static_cast<int64_t>(c) * p.k + kk));
    }
  };
  prefetch_round(st0);
  tpudl::pdl_wait();

  // The outputs this thread writes: o = threadIdx.x + j x blockDim (row
  // o / ch, channel tile0 x H + o % ch) below outs; the first one's scale
  // is read now, off the path from the last product to the store.
  const int ch = ntiles * H;
  const int outs = p.m * ch;
  const int o0 = static_cast<int>(threadIdx.x);
  const float scale0 = o0 < outs ? scale[min(tile0 * H + o0 % ch, p.n - 1)] : 0.0f;

  for (int r0 = st0; r0 < st1; r0 += kGemvSteps) {
    const int nst = min(kGemvSteps, st1 - r0);
    const bool first = r0 == st0;
    if (r0 + kGemvSteps < st1) prefetch_round(r0 + kGemvSteps);
    // x fragments of the round: xb[b][j][2i], [2i + 1] are mma i's b0, b1
    // at step j (rows past m and steps past the round are zeros).
    uint32_t xb[NB][kGemvSteps][8];
#pragma unroll
    for (int j = 0; j < kGemvSteps; ++j) {
      const int64_t kk = static_cast<int64_t>(r0 + j) * kGemvStepK + 16 * t;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
        const int row = 8 * b + g;
        if (j < nst && row < p.m && kk < p.k) {
          const uint4* src =
              reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * p.k + kk);
          lo = __ldg(src);
          hi = __ldg(src + 1);
        }
        // Elements (4i, 4i + 2) and (4i + 1, 4i + 3), as widen_quad pairs bytes.
        const uint32_t e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xb[b][j][2 * i] = __byte_perm(e[2 * i], e[2 * i + 1], 0x5410);
          xb[b][j][2 * i + 1] = __byte_perm(e[2 * i], e[2 * i + 1], 0x7632);
        }
      }
    }
    // The ring: the weights of the round's steps for one tile (row g + 8
    // only at H = 16).
    uint4 w[kGemvSteps][2];
    const uint8_t* rows[2];
    rows_of(0, rows);
#pragma unroll
    for (int j = 0; j < kGemvSteps; ++j) {
      const int64_t kk = static_cast<int64_t>(r0 + j) * kGemvStepK + 16 * t;
      w[j][0] = gemv_load(rows[0], kk, p.k, j < nst);
      w[j][1] = gemv_load(rows[1], kk, p.k, H == 16 && j < nst);
    }
    for (int i = 0; i < ntiles; ++i) {
      const bool more = i + 1 < ntiles;
      rows_of(i + 1, rows);
      float acc[NB][2][4];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[b][e >> 2][e & 3] = 0.0f;
#pragma unroll
      for (int j = 0; j < kGemvSteps; ++j) {
        const uint4 lo = w[j][0], hi = w[j][1];
        const int64_t kk = static_cast<int64_t>(r0 + j) * kGemvStepK + 16 * t;
        w[j][0] = gemv_load(rows[0], kk, p.k, more && j < nst);
        w[j][1] = gemv_load(rows[1], kk, p.k, H == 16 && more && j < nst);
        if (j < nst) {
          const uint32_t wg[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            uint32_t a[4] = {0u, 0u, 0u, 0u};
            widen_quad<Q>(wg[mi], a[0], a[2]);
            if constexpr (H == 16) widen_quad<Q>(wh[mi], a[1], a[3]);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const uint32_t bf[2] = {xb[b][j][2 * mi], xb[b][j][2 * mi + 1]};
              mma_bf16(acc[b][mi & 1], a, bf);
            }
          }
        }
      }
      // acc[b]: channels g (0, 1) and g + 8 (2, 3), rows of x 8b + 2t (0, 2)
      // and 8b + 2t + 1 (1, 3). Later rounds add to the first's.
      float* dst = part + static_cast<int64_t>(warp) * MR * chp + i * H + g;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[b][0][e] + acc[b][1][e];
        float* d0 = dst + (8 * b + 2 * t) * chp;
        float* d1 = d0 + chp;
        if (first) {
          d0[0] = v[0], d1[0] = v[1];
          if constexpr (H == 16) d0[8] = v[2], d1[8] = v[3];
        } else {
          d0[0] += v[0], d1[0] += v[1];
          if constexpr (H == 16) d0[8] += v[2], d1[8] += v[3];
        }
      }
    }
  }
  tpudl::pdl_launch_dependents();
  __syncthreads();

  // The CTA's sum over its warps, in warp order, for the rows of x that
  // exist and the CTA's channels.
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    const int row = o / ch, c = o - row * ch;
    const float* src = part + row * chp + c;
    // Every load issued before the first add.
    float v[kGemvMaxWarps / NB];
#pragma unroll
    for (int wi = 0; wi < kGemvMaxWarps / NB; ++wi) {
      v[wi] = wi < p.warps ? src[static_cast<int64_t>(wi) * MR * chp] : 0.0f;
    }
    float sum = v[0];
#pragma unroll
    for (int wi = 1; wi < kGemvMaxWarps / NB; ++wi) {
      if (wi < p.warps) sum += v[wi];
    }
    const int chan = tile0 * H + c;
    if (chan < p.n) {
      const float sc = o == o0 ? scale0 : scale[chan];
      y[static_cast<int64_t>(row) * p.n + chan] = __float2bfloat16_rn(sum * sc);
    }
  }
}

template <int Q, int NB, int H>
int launch_gemv_mma(const void* x, const void* q, const void* scale, void* y, const GemvPlan& p,
                    int groups, cudaStream_t st) {
  static bool opted = false;
  const auto kernel = quant_gemv_mma_kernel<Q, NB, H>;
  if (const int e = hop::opt_in_smem(kernel, gemv_smem(kGemvMaxWarps / NB, NB, kGemvMaxTiles, H),
                                     opted)) {
    return e;
  }
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups));
  cfg.blockDim = dim3(static_cast<unsigned>(p.warps * 32));
  cfg.dynamicSmemBytes = gemv_smem(p.warps, NB, p.tiles, H);
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const uint8_t*>(q),
                                             static_cast<const float*>(scale),
                                             static_cast<__nv_bfloat16*>(y), p);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// y [m, n] = (x [m, k] . q [n, k]^T) * scale [n]; dtype: tpudl::DType of
// x and y; qtype: QType of q. m <= 16. warps 0: the FMA kernel (f32 x, or
// bf16 x whose rows are not whole 16-byte vectors or whose pointers are
// not 16-byte aligned; bf16 x in whole vectors returns
// cudaErrorInvalidValue), tiles and height 0. warps >= 1: the
// tensor-core kernel (bf16 x, k % 16 == 0, x and q 16-byte aligned) on
// the plan of tpudl_torch/ops/quant_dot.py gemv_plan: `warps` warps a
// CTA, `tiles` tiles of `height` (16 or 8) channels a CTA. Anything else
// returns cudaErrorInvalidValue.
extern "C" int tpudl_quant_gemv(const void* x, const void* q, const void* scale, void* y, int m,
                                int n, int64_t k, int warps, int tiles, int height,
                                int dtype, int qtype, void* stream) {
  if (m <= 0 || m > 16 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  if (qtype != kInt8 && qtype != kE4M3) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 16 == 0 && tpudl::aligned16(x) && tpudl::aligned16(q);
  if (warps == 0) {
    if (tiles != 0 || height != 0) return cudaErrorInvalidValue;
    if (dtype == tpudl::kBFloat16) {
      if (vec) return cudaErrorInvalidValue;  // takes the tensor-core kernel
      return qtype == kInt8 ? launch_gemv_v<__nv_bfloat16, kInt8, 1>(x, q, scale, y, m, n, k, st)
                            : launch_gemv_v<__nv_bfloat16, kE4M3, 1>(x, q, scale, y, m, n, k, st);
    }
    return qtype == kInt8 ? launch_gemv<float, kInt8>(x, q, scale, y, m, n, k, st)
                          : launch_gemv<float, kE4M3>(x, q, scale, y, m, n, k, st);
  }
  if (dtype != tpudl::kBFloat16 || !vec) return cudaErrorInvalidValue;
  const int64_t ksteps = (k + kGemvStepK - 1) / kGemvStepK;
  const int nb = m <= 8 ? 1 : 2;
  if (warps < 1 || warps > kGemvMaxWarps / nb || tiles < 1 || tiles > kGemvMaxTiles ||
      warps > ksteps || ksteps > (1 << 30) ||
      (height != kGemvTile && height != kGemvHalfTile)) {
    return cudaErrorInvalidValue;
  }
  const int ntiles = (n + height - 1) / height;
  const int groups = (ntiles + tiles - 1) / tiles;
  const GemvPlan p{m, n, k, static_cast<int>(ksteps), warps, tiles, ntiles};
  const bool int8 = qtype == kInt8, full = height == kGemvTile;
  if (nb == 1) {
    if (full) {
      return int8 ? launch_gemv_mma<kInt8, 1, kGemvTile>(x, q, scale, y, p, groups, st)
                  : launch_gemv_mma<kE4M3, 1, kGemvTile>(x, q, scale, y, p, groups, st);
    }
    return int8 ? launch_gemv_mma<kInt8, 1, kGemvHalfTile>(x, q, scale, y, p, groups, st)
                : launch_gemv_mma<kE4M3, 1, kGemvHalfTile>(x, q, scale, y, p, groups, st);
  }
  if (full) {
    return int8 ? launch_gemv_mma<kInt8, 2, kGemvTile>(x, q, scale, y, p, groups, st)
                : launch_gemv_mma<kE4M3, 2, kGemvTile>(x, q, scale, y, p, groups, st);
  }
  return int8 ? launch_gemv_mma<kInt8, 2, kGemvHalfTile>(x, q, scale, y, p, groups, st)
              : launch_gemv_mma<kE4M3, 2, kGemvHalfTile>(x, q, scale, y, p, groups, st);
}

// The same product for any m (the wrapper sends m > 16 here). split 0:
// the mma.sync kernel (f32 x, or bf16 x whose rows are not whole 16-byte
// vectors; bf16 x in whole vectors returns cudaErrorInvalidValue); ws
// must be null. split >= 1: the TMA + wgmma kernel (bf16 x, k % 16 == 0,
// x and q 16-byte aligned) on the plan of
// tpudl_torch/ops/quant_dot.py gemm_plan: tiles of `rows` (128 or 256)
// rows of x, K steps of 64 cut into `split` runs of `per`, a persistent
// grid of `grid` blocks, and with split > 1 an f32 workspace ws of
// split * m * n values. Anything else returns cudaErrorInvalidValue.
extern "C" int tpudl_quant_gemm(const void* x, const void* q, const void* scale, void* y,
                                void* ws, int m, int n, int64_t k, int split, int per, int grid,
                                int rows, int dtype, int qtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m > 65535 * kBM || split < 0) return cudaErrorInvalidValue;
  if (qtype != kInt8 && qtype != kE4M3) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split > 0) {
    if (dtype != tpudl::kBFloat16) return cudaErrorInvalidValue;
    if (qtype == kInt8) {
      return launch_gemm_tma_rows<kInt8>(x, q, scale, y, ws, m, n, k, split, per, grid, rows, st);
    }
    return launch_gemm_tma_rows<kE4M3>(x, q, scale, y, ws, m, n, k, split, per, grid, rows, st);
  }
  if (ws != nullptr) return cudaErrorInvalidValue;
  if (dtype == tpudl::kBFloat16) {
    return qtype == kInt8 ? launch_gemm<__nv_bfloat16, kInt8, 1>(x, q, scale, y, m, n, k, st)
                          : launch_gemm<__nv_bfloat16, kE4M3, 1>(x, q, scale, y, m, n, k, st);
  }
  return qtype == kInt8 ? launch_gemm<float, kInt8, 3>(x, q, scale, y, m, n, k, st)
                        : launch_gemm<float, kE4M3, 3>(x, q, scale, y, m, n, k, st);
}
